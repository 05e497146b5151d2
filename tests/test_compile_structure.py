"""Compile-structure regression tests: pin the TRACED program shape of
the chains so engine-selection regressions are catchable on CPU,
without the card.

Parity tests prove the math; nothing else proves the *engine
selection*. A regression that silently flips the headline chain off its
engine (a policy change, a dtype promotion that re-routes an op, a
matrix product left at the GPU's TF32 default) can pass every -80 dB
gate on the CPU and only show up on the card. These tests trace
``batch.make_flagship_step`` and the public chain with
``jax.make_jaxpr`` (no compile, backend-agnostic) and assert:

- the card's engine runs the EQ inside the reverb's FFT convolution (LTI
  fold) and the limiter as the envelope kernel: every top-level
  ``pallas_call`` is that kernel — one pass unsegmented, three when the
  rows split into time segments;
- float64 appears ONLY in (n,)-sized index math on that engine; a
  batch-shaped f64 intermediate is a promotion bug (2x the bytes);
- every top-level f32 matrix product names precision HIGHEST (HIGH and
  DEFAULT are TF32 on the GPU, which spends the -80 dB budget);
- the XLA engine runs no Pallas kernel at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from xmtpu import batch as xbatch
from xmtpu.kernels.envelope import pick_segments

B_HEAD, N_IN, SR_IN, SR_BUS = 256, 44100, 44100, 16000


def _walk(jaxpr, in_pallas=False, out=None):
    """Flatten eqns of ``jaxpr`` and every sub-jaxpr (jit/cond/while/
    pallas bodies), tagging each with whether it sits inside a
    pallas_call."""
    if out is None:
        out = []
    for e in jaxpr.eqns:
        out.append((e, in_pallas))
        child = in_pallas or e.primitive.name == "pallas_call"
        for v in e.params.values():
            for x in (v if isinstance(v, (tuple, list)) else [v]):
                if hasattr(x, "jaxpr"):
                    _walk(x.jaxpr, child, out)
                elif hasattr(x, "eqns"):
                    _walk(x, child, out)
    return out


def _trace(batch, **kw):
    step = xbatch.make_flagship_step(sr_in=SR_IN, sr_bus=SR_BUS, **kw)
    v = jnp.zeros((batch, N_IN), jnp.int16)
    b = jnp.zeros((batch, N_IN), jnp.int16)
    jx = jax.make_jaxpr(step)(v, b)
    return jx, _walk(jx.jaxpr)


def _top_pallas(eqns):
    return [e for e, p in eqns if e.primitive.name == "pallas_call" and not p]


def _kernel_names(calls):
    return {str(e.params.get("name", "")) for e in calls}


def test_headline_chain_structure():
    """The card's engine at the headline batch: only envelope-kernel
    passes, disciplined dtypes and precision."""
    jx, eqns = _trace(B_HEAD, engine="gpu_interpret")

    calls = _top_pallas(eqns)
    n_bus = N_IN * SR_BUS // SR_IN
    want = 3 if pick_segments(B_HEAD, n_bus) > 1 else 1
    assert len(calls) == want, (
        f"headline chain must run {want} envelope-kernel passes, traced "
        f"{len(calls)} — engine selection regressed")
    assert all(nm.startswith("xm_envelope") for nm in _kernel_names(calls))

    for e, _ in eqns:
        for var in e.outvars:
            aval = getattr(var, "aval", None)
            dt = getattr(aval, "dtype", None)
            if dt is not None and str(dt) == "float64":
                assert len(aval.shape) <= 1, (
                    f"batch-shaped float64 intermediate "
                    f"{e.primitive.name} -> {aval.shape}")

    for e, in_pal in eqns:
        if e.primitive.name != "dot_general" or in_pal:
            continue
        in_dts = {str(v.aval.dtype) for v in e.invars}
        if in_dts == {"float32"}:
            prec = e.params.get("precision")
            assert prec and all(p == jax.lax.Precision.HIGHEST
                                for p in prec), (
                f"top-level f32 dot {tuple(v.aval.shape for v in e.invars)}"
                f" has precision={prec}; the GPU runs anything below "
                f"HIGHEST as TF32")

    out_aval = jx.jaxpr.outvars[0].aval
    assert str(out_aval.dtype) == "int16"
    assert out_aval.shape == (B_HEAD, n_bus)


def test_small_batch_keeps_segmented_kernels():
    """A small batch must split its rows into time segments (3 kernel
    passes) so the card fills, not fall back to one pass per row."""
    assert pick_segments(32, N_IN * SR_BUS // SR_IN) > 1
    _, eqns = _trace(32, engine="gpu_interpret")
    assert len(_top_pallas(eqns)) == 3


_PUBLIC_CHAIN = [
    {"name": "equalizer", "bands": [
        {"freq_hz": f, "gain_db": g, "q": 1.0}
        for f, g in [(60, 2.0), (250, -1.5), (1000, 3.0),
                     (4000, -2.0), (6000, 1.0)]]},
    {"name": "reverb", "params": {"ir_seconds": 0.3, "wet": 0.25,
                                  "dry": 0.75}},
    {"name": "limiter", "threshold_db": -3.0},
]


def _trace_public(backend, states=True):
    from functools import partial

    from xmtpu.graph import fx

    effects = fx.build_chain(16000, _PUBLIC_CHAIN,
                             default_backend=backend)
    x = jnp.zeros((128, 1, 160000), jnp.float32)
    st = ([e.init_state(x.shape[:-1]) for e in effects] if states
          else tuple(None for _ in effects))
    jx = jax.make_jaxpr(partial(fx.chain_apply, effects))(x, st)
    return effects, _walk(jx.jaxpr)


def test_public_chain_runs_production_engine():
    """On the card's engine the public chain LTI-folds EQ into the
    reverb (FusedLTIFx) and runs the limiter as the envelope kernel."""
    effects, eqns = _trace_public("gpu_interpret")
    assert [type(e).__name__ for e in effects] == \
        ["FusedLTIFx", "LimiterFx"], (
            f"LTI fold regressed: {[type(e).__name__ for e in effects]}")
    calls = _top_pallas(eqns)
    assert len(calls) in (1, 3), len(calls)
    assert all(nm.startswith("xm_envelope") for nm in _kernel_names(calls))


def test_public_chain_stateless_path_keeps_padded_handoff():
    """The whole-clip (None states) path of the card's engine runs the
    same stages as the stateful one: the FFT reverb with no tail carry
    and the envelope kernel, with no EQ recurrence left."""
    effects, eqns = _trace_public("gpu_interpret", states=False)
    assert [type(e).__name__ for e in effects] == ["FusedLTIFx", "LimiterFx"]
    names = {e.primitive.name for e, p in eqns if not p}
    assert "pallas_call" in names
    assert not any(n.startswith("cum") for n in names), names


def test_public_chain_scan_backend_is_kernel_free():
    """backend='scan' is the oracle/streaming-state path: no fold, no
    Pallas — the f64 twins the correctness arguments lean on."""
    effects, eqns = _trace_public("scan")
    assert [type(e).__name__ for e in effects] == \
        ["EqualizerFx", "ReverbFx", "LimiterFx"]
    assert not _top_pallas(eqns)


def test_scan_backend_has_no_sequential_pallas():
    """The XLA engine's headline chain runs no Pallas kernel: the EQ and
    limiter are the f64 scans, the reverb the XLA FFT convolution."""
    _, eqns = _trace(B_HEAD, engine="xla")
    assert not _top_pallas(eqns)
