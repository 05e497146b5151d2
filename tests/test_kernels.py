"""The limiter envelope kernel (Pallas, Triton route) and the engine
policy.

On the CPU the kernel runs in Pallas interpret mode, checked against
the float64 numpy oracle (``ops.limiter.limiter_np``) and the f64 scan
twins; its CUDA lowering is checked through ``jax.export`` with no card.
Tests marked ``chip`` run the compiled kernel on the card
(``python chip_smoke.py``) and skip elsewhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import xmtpu  # noqa: F401
from xmtpu import engine as E
from xmtpu.kernels import envelope as K
from xmtpu.ops import limiter as L
from xmtpu.utils.errors import ConfigError

from .conftest import rms_db

SR = 16000
K_REL = L._release_coeff(80.0, SR)
C_ATT = L._attack_coeff(1.0, SR)


def _signal(rng, shape, loud=0.9):
    x = (loud * rng.standard_normal(shape)).astype(np.float32)
    x[..., 100:300] *= 4.0  # drive the knee and the ceiling clamp
    return x


def _state(rng, b):
    return (np.abs(rng.standard_normal(b)).astype(np.float32),
            np.abs(rng.standard_normal(b)).astype(np.float32))


@pytest.mark.parametrize("B,ch,n,segments,carry,curve", [
    (3, 1, 1003, None, False, "limit"),   # ragged n, auto segments
    (2, 1, 4096, 8, True, "limit"),       # segmented mono, carried state
    (2, 2, 4096, 16, True, "limit"),      # linked stereo (gain mode)
    (1, 2, 3000, 3, True, "limit"),       # non-power-of-two segments
    (5, 1, 777, 1, False, "comp"),        # compressor curve, one pass
    (2, 2, 2048, 4, True, "comp"),        # compressor, segmented stereo
    (1, 1, 10, None, True, "limit"),      # n shorter than one unroll step
    (33, 1, 512, 2, False, "limit"),      # lanes padded to the block
])
def test_limiter_kernel_matches_oracle(rng, B, ch, n, segments, carry, curve):
    """Output and final states vs the f64 oracle over rows, ragged n,
    segments, carried state and both curves (-80 dB gate)."""
    x = _signal(rng, (B, ch, n))
    init = _state(rng, B) if carry else (0.0, 0.0)
    kw = dict(threshold_db=-6.0)
    if curve == "comp":
        kw.update(threshold_db=-10.0, ratio=4.0, makeup_db=2.0)
    ref, (er, sr_) = L.limiter_np(x, SR, release_ms=80.0, state=init, **kw)
    y, (el, sl) = K.limiter_kernel(
        jnp.asarray(x), K_REL, C_ATT, init=init if carry else None,
        segments=segments, interpret=True, **kw)
    assert y.shape == x.shape
    assert rms_db(np.asarray(y, np.float64) - ref, ref) <= -80.0
    assert rms_db(np.asarray(el, np.float64) - er, er) <= -80.0
    assert rms_db(np.asarray(sl, np.float64) - sr_, sr_) <= -80.0
    # the ceiling clamp holds exactly
    assert np.max(np.abs(np.asarray(y))) <= 1.0 + 1e-6


@pytest.mark.parametrize("R,n,segments,carry", [
    (2, 2048, None, False), (3, 1500, 5, True), (1, 4096, 1, True),
    (4, 640, 2, False)])
def test_envelope_kernel_matches_scans(rng, R, n, segments, carry):
    """The kernel's gain pass vs the f64 associative scans. With the
    threshold far below the signal every sample is limited, so the gain
    is threshold / envelope and carries the envelope's error 1:1."""
    d = np.abs(rng.standard_normal((R, n))).astype(np.float32) * 1.5
    init = _state(rng, R) if carry else (np.zeros(R), np.zeros(R))
    env, _ = L.decaying_max_scan(jnp.asarray(d, jnp.float64), K_REL,
                                 jnp.asarray(init[0], jnp.float64))
    e2, _ = L.onepole_scan(env, C_ATT, jnp.asarray(init[1], jnp.float64))
    e2 = np.asarray(e2)
    ref = 10.0 ** (np.asarray(L.soft_knee_gain_db(
        20.0 * np.log10(e2), -60.0, 6.0)) / 20.0)
    g, (el, sl) = K._rows(
        jnp.asarray(d), jnp.asarray(np.stack(init), jnp.float32), K_REL,
        C_ATT, absdet=False, emit="gain", curve=(-60.0, 6.0, 0.0, 1.0, 0.0),
        segments=segments, interpret=True)
    assert rms_db(np.asarray(g, np.float64) - ref, ref) <= -100.0
    np.testing.assert_allclose(np.asarray(sl), e2[:, -1], rtol=1e-5)


@pytest.mark.parametrize("segments", [None, 1])
def test_limiter_kernel_state_carry(rng, segments):
    """Two state-carried halves == the whole clip (streaming blocks)."""
    n = 4096
    x = _signal(rng, (2, 1, n))
    kw = dict(segments=segments, interpret=True)
    yw, stw = K.limiter_kernel(jnp.asarray(x), K_REL, C_ATT, -6.0, **kw)
    y1, st = K.limiter_kernel(jnp.asarray(x[..., :n // 2]), K_REL, C_ATT,
                              -6.0, **kw)
    y2, st2 = K.limiter_kernel(jnp.asarray(x[..., n // 2:]), K_REL, C_ATT,
                               -6.0, init=st, **kw)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)], -1)
    ref = np.asarray(yw, np.float64)
    assert rms_db(got - ref, ref) <= -100.0
    np.testing.assert_allclose(np.asarray(st2[1]), np.asarray(stw[1]),
                               rtol=1e-5)


@pytest.mark.parametrize("S", [2, 5, 10])
def test_segmented_equals_unsegmented(rng, S):
    """The exact cross-segment states reproduce the one-pass recurrence
    (f32 rounding only)."""
    x = _signal(rng, (2, 1, 2000))
    y1, _ = K.limiter_kernel(jnp.asarray(x), K_REL, C_ATT, -6.0,
                             segments=1, interpret=True)
    ys, _ = K.limiter_kernel(jnp.asarray(x), K_REL, C_ATT, -6.0,
                             segments=S, interpret=True)
    ref = np.asarray(y1, np.float64)
    assert rms_db(np.asarray(ys, np.float64) - ref, ref) <= -100.0


@pytest.mark.parametrize("R,n", [
    (256, 160000), (16, 480000), (1, 44100), (32, 480000), (7, 1009)])
def test_pick_segments_fills_lanes(R, n):
    """Segments divide n and respect the lane target and the minimum
    segment length."""
    S = K.pick_segments(R, n)
    assert n % S == 0 and R * S <= max(R, K._LANES_FILL)
    assert S == 1 or n // S >= K._MIN_SEGLEN
    if n == 1009:  # prime: no split possible
        assert S == 1


def test_segments_must_divide_n(rng):
    x = _signal(rng, (1, 1, 1000))
    with pytest.raises(ValueError, match="divide"):
        K.limiter_kernel(jnp.asarray(x), K_REL, C_ATT, -6.0, segments=3,
                         interpret=True)


def _export_cuda(fn, *shapes):
    from jax import export

    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    return exp.mlir_module()


@pytest.mark.parametrize("emit,absdet", [
    ("finals", True), ("finals", False), ("gain", False), ("limit", True)])
def test_kernel_pass_lowers_for_cuda(emit, absdet):
    """Each kernel pass lowers to a Triton call for CUDA from this host
    (no card needed), x64 on as in the package."""
    curve = (-3.0, 6.0, 0.0, 1.0, 0.0)
    txt = _export_cuda(
        lambda x, s: K._run(x, s, k_rel=K_REL, c_att=C_ATT, absdet=absdet,
                            emit=emit, curve=curve, interpret=False),
        (2500, 64), (2, 64))
    assert "__gpu$xla.gpu.triton" in txt


@pytest.mark.parametrize("shape", [(256, 1, 16000), (16, 2, 48000)])
def test_limiter_kernel_lowers_for_cuda(shape):
    """The whole segmented limiter (three passes + the cross-segment
    scans) lowers for CUDA at flagship- and config-3-like shapes."""
    txt = _export_cuda(
        lambda x: K.limiter_kernel(x, K_REL, C_ATT, -3.0)[0], shape)
    assert K.pick_segments(shape[0], shape[-1]) > 1
    # the two state passes share one compiled kernel
    assert txt.count("__gpu$xla.gpu.triton") == 2
    out = "xm_envelope_limit" if shape[1] == 1 else "xm_envelope_gain"
    assert "xm_envelope_finals" in txt and out in txt


@pytest.mark.parametrize("ratio,makeup_db", [(float("inf"), 0.0), (4.0, 2.0)])
def test_kernel_curve_matches_ops_curve(ratio, makeup_db):
    """The kernel's soft-knee gain (exp/log in f32) equals the pinned
    curve of ops.limiter (log10/power in f64) across the knee."""
    e2 = np.geomspace(1e-4, 4.0, 4001).astype(np.float32)
    curve = (-6.0, 6.0, 0.0, L._knee_slope(ratio), makeup_db)
    got = np.asarray(K._curve_gain(jnp.asarray(e2), curve), np.float64)
    level_db = 20.0 * np.log10(e2.astype(np.float64))
    want = 10.0 ** ((np.asarray(L.soft_knee_gain_db(
        jnp.asarray(level_db), -6.0, 6.0, ratio)) + makeup_db) / 20.0)
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("ch", [1, 2])
def test_ops_limiter_engines_agree(rng, ch):
    """ops.limiter through the card's engine (kernel, interpreted) and
    the XLA engine (f64 scans) agree, carried state included."""
    x = _signal(rng, (2, ch, 2048))
    st = _state(rng, 2)
    y_x, s_x = L.limiter(jnp.asarray(x), SR, state=st, backend="xla")
    y_g, s_g = L.limiter(jnp.asarray(x), SR, state=st,
                         backend="gpu_interpret")
    ref = np.asarray(y_x, np.float64)
    assert rms_db(np.asarray(y_g, np.float64) - ref, ref) <= -80.0
    for a, b in zip(s_g, s_x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4)


# --- engine policy (xmtpu.engine) -------------------------------------------


@pytest.mark.parametrize("name,want", [
    ("xla", ("xla", False)), ("scan", ("xla", False)),
    ("oracle", ("xla", False)), ("gpu_interpret", ("gpu", True))])
def test_engine_names_resolve(name, want):
    assert E.resolve(name) == want


def test_engine_auto_follows_platform(monkeypatch):
    """auto: gpu -> the card's engine, cpu -> the XLA twins, and never
    interpret mode (nothing turns it on because it found a CPU)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert E.resolve(None) == ("gpu", False)
    assert E.resolve("auto") == ("gpu", False)
    assert E.resolve("gpu") == ("gpu", False)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert E.resolve("auto") == ("xla", False)
    for name in E.NAMES:
        if name != "gpu_interpret" and name != "gpu":
            assert E.resolve(name)[1] is False, name


def test_engine_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "bogus")
    with pytest.raises(E.EngineError, match="bogus"):
        E.resolve("auto")
    assert issubclass(E.EngineError, ConfigError)


def test_engine_gpu_needs_the_card(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(E.EngineError, match="gpu_interpret"):
        E.resolve("gpu")
    with pytest.raises(ConfigError, match="unknown engine"):
        E.resolve("pallas")


def _build_limiter_fx(backend):
    from xmtpu.graph import fx

    fx.build_chain(SR, [{"name": "limiter", "params": {"backend": backend}}])


def _build_eq_fx(backend):
    from xmtpu.graph import fx

    fx.build_chain(SR, [{"name": "equalizer", "params": {
        "bands": [{"freq_hz": 1000.0, "gain_db": 3.0, "q": 1.0}],
        "backend": backend}}])


def _build_flagship(backend):
    from xmtpu import batch as xb

    xb.make_flagship_step(engine=backend)


def _build_pool(backend):
    from xmtpu.graph.pool import SessionPool

    SessionPool({"tracks": [{"url": "v"}], "sampleRate": SR,
                 "normalize": None}, 1, effects_backend=backend)


@pytest.mark.parametrize("build", [
    _build_limiter_fx, _build_eq_fx, _build_flagship, _build_pool])
@pytest.mark.parametrize("backend,match", [
    ("gpu", "gpu_interpret"), ("pallas_interpret", "unknown engine")])
def test_entry_points_refuse_engines_they_cannot_run(monkeypatch, build,
                                                     backend, match):
    """An explicit engine request is refused with a ConfigError at build
    time, never silently downgraded: 'gpu' on a CPU platform, and any
    name the engine module does not know."""
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(ConfigError, match=match):
        build(backend)


# --- compile cache (xmtpu._cachedir) ----------------------------------------


def test_cache_dir_env_wins(tmp_path):
    from xmtpu import _cachedir

    assert _cachedir.cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) \
        == str(tmp_path)


def test_cache_dir_default_is_in_checkout():
    import os

    from xmtpu import _cachedir

    d = _cachedir.cache_dir({})
    assert d == os.path.join(_cachedir.REPO_ROOT, ".jax_cache",
                             _cachedir.host_fingerprint())
    assert _cachedir.host_fingerprint() == _cachedir.host_fingerprint()
    assert len(_cachedir.host_fingerprint()) == 12


def test_cache_dir_applied_on_import():
    """Importing xmtpu points jax at $JAX_COMPILATION_CACHE_DIR when set
    (jax reads it itself), else at the in-checkout directory."""
    import os

    from xmtpu import _cachedir

    got = jax.config.jax_compilation_cache_dir
    assert got == (os.environ.get(_cachedir.ENV) or _cachedir.cache_dir())


def test_cache_dir_gitignored():
    import os

    from xmtpu import _cachedir

    with open(os.path.join(_cachedir.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- on the card (python chip_smoke.py runs these) --------------------------


@pytest.mark.chip
@pytest.mark.parametrize("shape", [(256, 1, 160000), (16, 2, 480000)])
def test_limiter_kernel_compiled_on_card(shape):
    """The compiled kernel at real widths vs the f64 scan engine."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(_signal(rng, shape, loud=0.5))
    y_k = jax.jit(lambda v: L.limiter(v, SR, backend="gpu")[0])(x)
    y_x = jax.jit(lambda v: L.limiter(v, SR, backend="xla")[0])(x)
    ref = np.asarray(y_x, np.float64)
    assert rms_db(np.asarray(y_k, np.float64) - ref, ref) <= -80.0


@pytest.mark.chip
def test_flagship_gpu_engine_on_card():
    """The card's flagship chain vs the float64 host oracle."""
    from xmtpu import batch as xb

    rng = np.random.default_rng(2)
    v = (rng.standard_normal((4, 44100)) * 9000).astype(np.int16)
    b = (rng.standard_normal((4, 44100)) * 3000).astype(np.int16)
    y = np.asarray(jax.jit(xb.make_flagship_step(engine="gpu"))(v, b))
    ref = xb.flagship_oracle_np(v[3], b[3]).astype(np.float64)
    assert rms_db((y[3] - ref) / 32768.0, ref / 32768.0) <= -80.0
