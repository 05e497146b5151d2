"""Sequence parallelism: one long clip sharded along time over chips.

Reference analogue: the upstream handles long files by *streaming* one
frame at a time on one core [upstream, SURVEY.md §5 "long-context"];
the rebuild splits the clip across devices instead:

* **FIR** (reverb, resampler windows): each shard needs the previous
  shard's last ``taps-1`` samples — a halo passed left->right via
  ``jax.lax.ppermute`` (the ring/blockwise-attention analogue for
  convolutional ops, SURVEY.md §2.2 SP row).
* **IIR** (biquad cascade): each shard's whole-shard effect on the
  2-vector section state is an affine map ``z -> M z + v``; shards
  ``all_gather`` their (M, v) summaries (6 numbers each), compose the
  prefix serially (exact — no approximation), then apply their true
  incoming state to the per-sample cumulative maps they already built
  (SURVEY.md §5: "compute each shard's 2x2 transition-matrix product
  and chain them with a tiny inter-chip scan").
* **Envelope** (limiter): same idea in the (max, x) semiring for the
  decaying max, plus an affine chain for the one-pole smoother.

All entry points take the FULL array and a mesh with an ``"sp"`` axis;
the `_local_*` functions are the shard_map bodies and can be composed
into larger SPMD programs (see :func:`sp_effects_chain`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu.ops import biquad as _biquad

P = jax.sharding.PartitionSpec

_JIT_CACHE: dict = {}


def _array_sig(a) -> tuple:
    """Content signature for a host array baked into a shard_map body."""
    import hashlib

    a = np.ascontiguousarray(np.asarray(a))
    return (a.shape, str(a.dtype), hashlib.sha1(a.tobytes()).hexdigest())


def _cached_jit(key, build):
    """Module-level LRU of jitted SPMD programs. The entry points used
    to call ``jax.jit(fn)`` on a FRESH shard_map closure every
    invocation, so jax's own cache (keyed on function identity) never
    hit and every call re-traced and re-compiled.
    Closed-over host arrays enter ``key`` by content hash (via
    :func:`_array_sig`), so a changed sos/ir/taps cannot reuse a stale
    baked constant."""
    fn = _JIT_CACHE.pop(key, None)
    if fn is None:
        fn = jax.jit(build())
        if len(_JIT_CACHE) >= 16:
            _JIT_CACHE.pop(next(iter(_JIT_CACHE)))
    _JIT_CACHE[key] = fn  # (re)insert last = most recently used
    return fn


def _sp_perm(n: int):
    """left -> right neighbor permutation (device i sends to i+1)."""
    return [(i, i + 1) for i in range(n - 1)]


def _prefix_select(stacked, my_idx, fold, init):
    """Exact cross-shard prefix: state entering shard ``my_idx``.

    ``stacked``: pytree of arrays with leading axis = n_shards (from
    all_gather). Folds shards 0..k-1 serially (n_shards is static and
    small) and selects row ``my_idx`` (traced) from the prefix stack.
    """
    n_sh = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    states = [init]
    for k in range(n_sh - 1):
        row = jax.tree.map(lambda a: a[k], stacked)
        states.append(fold(states[-1], row))
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    return jax.tree.map(
        lambda a: jax.lax.dynamic_index_in_dim(a, my_idx, 0, keepdims=False),
        stack,
    )


# ---------------------------------------------------------------------------
# FIR with ppermute halo
# ---------------------------------------------------------------------------


def _local_fir(xl, taps, axis: str, block: int | None = None):
    """Causal FIR on a time shard; left halo of taps-1 samples arrives
    from the left neighbor (zeros at shard 0). ``block``:
    overlap-save FFT block size for long shards (None = one full-size
    transform — fine for short shards, wasteful at SP scale)."""
    from xmtpu.ops.reverb import fir_convolve_full, fir_convolve_os

    m = taps.shape[-1]
    halo = m - 1
    n_sh = jax.lax.axis_size(axis)
    if halo > xl.shape[-1]:
        # one ppermute hop supplies ONE neighbor's tail; a halo longer
        # than the shard would need samples from shard k-2 and beyond,
        # which this implementation would silently replace with zeros
        # (round-2 review find). Use fewer/longer shards.
        raise ValueError(
            f"FIR halo {halo} exceeds the per-shard length "
            f"{xl.shape[-1]}; use fewer 'sp' shards (need shard length "
            f">= taps-1)")
    if halo > 0:
        tail = xl[..., -halo:]
        left = jax.lax.ppermute(tail, axis, _sp_perm(n_sh))
        xw = jnp.concatenate([left, xl], axis=-1)
    else:
        xw = xl
    if block is not None:
        # same-length causal conv == full conv [:n]; slice off the halo
        w = fir_convolve_os(xw, taps, block)
    else:
        w = fir_convolve_full(xw, taps)
    return w[..., halo : halo + xl.shape[-1]]


def _fir_block_auto(n_shard: int, m: int) -> int | None:
    """Overlap-save block for the sharded FIR: None (full transform)
    for short shards, a 64k-floor power of two above the IR otherwise."""
    if n_shard <= 1 << 17:
        return None
    b = 65536
    while b <= 2 * (m - 1):
        b *= 2
    return b


def sp_fir(x, taps, mesh, wet: float = 1.0, dry: float = 0.0,
           block: int | str | None = "auto"):
    """Convolve the last axis of ``x`` with ``taps`` (causal, same
    length), time-sharded over the mesh's ``sp`` axis. ``wet``/``dry``
    give the reverb mix (wet=1, dry=0 -> plain convolution)."""
    taps = jnp.asarray(taps, jnp.float32)
    if block == "auto":
        block = _fir_block_auto(x.shape[-1] // mesh.shape["sp"],
                                taps.shape[-1])

    def build():
        def body(xl):
            w = _local_fir(xl, taps, "sp", block=block)
            return (jnp.asarray(dry, xl.dtype) * xl
                    + jnp.asarray(wet, xl.dtype) * w)

        return jax.shard_map(
            body, mesh=mesh, in_specs=P(*(None,) * (x.ndim - 1), "sp"),
            out_specs=P(*(None,) * (x.ndim - 1), "sp"), check_vma=False)

    key = ("fir", mesh, x.ndim, block, float(wet), float(dry),
           _array_sig(taps))
    return _cached_jit(key, build)(x)


# ---------------------------------------------------------------------------
# Biquad cascade with exact cross-shard state chain
# ---------------------------------------------------------------------------


def _local_biquad(xl, sos, axis: str, state_dtype=jnp.float64):
    """Cascaded sections on a time shard, state chained across shards."""
    y = xl.astype(state_dtype)
    sosd = jnp.asarray(sos, state_dtype)
    my = jax.lax.axis_index(axis)

    def fold(z, row):
        m11, m12, m21, m22, v1, v2 = row
        return (
            m11 * z[0] + m12 * z[1] + v1,
            m21 * z[0] + m22 * z[1] + v2,
        )

    for s in range(sos.shape[0]):
        b0, b1, b2, a1, a2 = sosd[s, 0], sosd[s, 1], sosd[s, 2], sosd[s, 4], sosd[s, 5]
        m11, m12, m21, m22, v1, v2 = _biquad.section_cums(y, b0, b1, b2, a1, a2)
        summary = tuple(
            t[..., -1] for t in (m11, m12, m21, m22, v1, v2)
        )
        gathered = jax.lax.all_gather(summary, axis)  # leading axis: shards
        zero = jnp.zeros_like(summary[4])
        zi1, zi2 = _prefix_select(gathered, my, fold, (zero, zero))
        zi1 = zi1[..., None]
        zi2 = zi2[..., None]
        z1 = m11 * zi1 + m12 * zi2 + v1
        z1_prev = jnp.concatenate([zi1, z1[..., :-1]], axis=-1)
        y = b0 * y + z1_prev
    return y.astype(xl.dtype)


def sp_biquad(sos, x, mesh, state_dtype=jnp.float64):
    """sosfilt over the last axis, time-sharded over the ``sp`` axis:
    float64 associative scans with the exact cross-shard state chain;
    equals the single-device :func:`ops.biquad.sosfilt_scan`."""
    def build():
        body = partial(_local_biquad, sos=np.asarray(sos), axis="sp",
                       state_dtype=state_dtype)
        return jax.shard_map(
            body, mesh=mesh, in_specs=P(*(None,) * (x.ndim - 1), "sp"),
            out_specs=P(*(None,) * (x.ndim - 1), "sp"), check_vma=False)

    key = ("biquad", mesh, x.ndim, str(state_dtype), _array_sig(sos))
    return _cached_jit(key, build)(x)


# ---------------------------------------------------------------------------
# Limiter envelope across shards (max-plus + affine chains)
# ---------------------------------------------------------------------------


def _local_envelope(d, k_rel: float, c_att: float, axis: str):
    """Smoothed envelope on a time shard; exact cross-shard carry."""
    from xmtpu.ops.limiter import decaying_max_scan, onepole_scan

    my = jax.lax.axis_index(axis)
    n = d.shape[-1]
    zero = jnp.zeros(d.shape[:-1], d.dtype)

    # decaying max: shard summary (v = env0[-1], p = k^n) in (max, *)
    env0, _ = decaying_max_scan(d, k_rel, zero)
    p_shard = jnp.full(d.shape[:-1], float(k_rel) ** n, d.dtype)
    g = jax.lax.all_gather((env0[..., -1], p_shard), axis)
    e_in = _prefix_select(
        g, my, lambda e, row: jnp.maximum(row[0], row[1] * e), zero
    )
    expo = jnp.arange(1, n + 1, dtype=d.dtype)
    decay = (jnp.exp(expo * jnp.log(jnp.asarray(k_rel, d.dtype)))
             if k_rel > 0 else jnp.zeros(n, d.dtype))
    env = jnp.maximum(env0, decay * e_in[..., None])

    if c_att >= 1.0:
        return env
    # one-pole smoother: affine chain (v = e2_0[-1], p = a^n)
    a = 1.0 - c_att
    e2_0, _ = onepole_scan(env, c_att, zero)
    # NOTE: e2_0 already folds env (which includes cross-shard max) but a
    # zero incoming smoother state; correct it with the affine chain.
    pa = jnp.full(d.shape[:-1], a ** n, d.dtype)
    g2 = jax.lax.all_gather((e2_0[..., -1], pa), axis)
    s_in = _prefix_select(
        g2, my, lambda e, row: row[0] + row[1] * e, zero
    )
    apow = jnp.exp(expo * jnp.log(jnp.asarray(a, d.dtype)))
    return e2_0 + apow * s_in[..., None]


def sp_envelope(d, sr: int, mesh, attack_ms=1.0, release_ms=100.0):
    """Smoothed limiter envelope of detector ``d``, time-sharded over
    the ``sp`` axis (exact max-plus and affine cross-shard chains)."""
    from xmtpu.ops import limiter as _lim

    k_rel = _lim._release_coeff(release_ms, sr)
    c_att = _lim._attack_coeff(attack_ms, sr)

    def build():
        body = partial(_local_envelope, k_rel=k_rel, c_att=c_att, axis="sp")
        return jax.shard_map(
            body, mesh=mesh, in_specs=P(*(None,) * (d.ndim - 1), "sp"),
            out_specs=P(*(None,) * (d.ndim - 1), "sp"), check_vma=False)

    key = ("env", mesh, d.ndim, float(k_rel), float(c_att))
    return _cached_jit(key, build)(d)


# ---------------------------------------------------------------------------
# Full effects chain, time-sharded (config-3 chain on ONE huge clip)
# ---------------------------------------------------------------------------


def sp_effects_chain(x, sr: int, mesh, bands, ir, wet=0.3, dry=0.7,
                     threshold_db=-3.0, knee_db=6.0, attack_ms=1.0,
                     release_ms=100.0, ceiling_db=0.0,
                     dp_axis: str | None = None,
                     fir_block: int | str | None = "auto"):
    """EQ -> FIR reverb -> soft-knee limiter on (ch, n) PCM, the time
    axis sharded over the mesh's ``sp`` axis. Collectives: one
    all_gather of the EQ state summary, one taps-1 ppermute halo,
    two tiny all_gathers for the limiter — everything else is local.

    The per-shard recurrences are float64 associative scans with the
    exact affine/max-plus cross-shard chains. ``fir_block``:
    overlap-save block for the sharded reverb ("auto" = full transform
    under 128k-sample shards).

    With ``dp_axis`` set (2-D ``(dp, sp)`` mesh — SURVEY.md §5
    "optional (batch, block) mesh"), ``x`` is ``[B, ch, n]`` and the
    leading clip axis shards over ``dp`` while time shards over ``sp``:
    a batch of hour-long clips uses every chip along both axes. The
    ``sp`` collectives are per-dp-row automatic (shard_map scopes
    ``axis_name`` collectives to the named mesh axis).

    Output equals the single-device chain (ops twins) to f32 tolerance.
    """
    from xmtpu.ops.limiter import _attack_coeff, _release_coeff, soft_knee_gain_db

    sos = np.asarray(bands if np.ndim(bands) == 2 else
                     _biquad.eq_sos(list(bands), sr))
    irj = jnp.asarray(ir, jnp.float32)
    k_rel = _release_coeff(release_ms, sr)
    c_att = _attack_coeff(attack_ms, sr)
    ceil_amp = 10.0 ** (ceiling_db / 20.0)
    n_shard = x.shape[-1] // mesh.shape["sp"]
    if fir_block == "auto":
        fir_block = _fir_block_auto(n_shard, irj.shape[-1])

    def body(xl):
        y = _local_biquad(xl, sos, "sp")
        w = _local_fir(y, irj, "sp", block=fir_block)
        y = jnp.asarray(dry, y.dtype) * y + jnp.asarray(wet, y.dtype) * w
        d = jnp.max(jnp.abs(y.astype(jnp.float64)), axis=-2)
        e2 = _local_envelope(d, k_rel, c_att, "sp")
        level_db = 20.0 * jnp.log10(jnp.maximum(e2, 1e-12))
        gain = jnp.power(
            10.0, soft_knee_gain_db(level_db, threshold_db, knee_db) / 20.0
        )
        out = jnp.clip(y.astype(jnp.float64) * gain[..., None, :],
                       -ceil_amp, ceil_amp)
        return out.astype(xl.dtype)

    spec = [None] * (x.ndim - 1) + ["sp"]
    if dp_axis is not None:
        spec[0] = dp_axis

    def build():
        return jax.shard_map(body, mesh=mesh, in_specs=P(*spec),
                             out_specs=P(*spec), check_vma=False)

    key = ("chain", mesh, x.ndim, fir_block,
           float(wet), float(dry), float(threshold_db), float(knee_db),
           float(k_rel), float(c_att), float(ceil_amp), dp_axis,
           _array_sig(sos), _array_sig(ir))
    return _cached_jit(key, build)(x)
