"""Pallas kernel (Triton route): the limiter's envelope follower.

Reference analogue: the limiter's per-sample envelope C loop
(``src/effects/`` [upstream, SURVEY.md §2.1]).

The sequential part of the soft-knee limiter is two chained first-order
recurrences over the detector d[t] (``ops.limiter`` pinned math):

    env[t] = max(d[t], k_rel * env[t-1])      (peak hold, exp release)
    e2[t]  = (1-c_att) e2[t-1] + c_att env[t] (attack smoothing)

followed by the elementwise soft-knee curve and ceiling clamp.

Design (one kernel; its passes emit final states only, the gain, or the
limited signal):

* **Layout.** Time-major ``(n, lanes)``: one lane is one (row, segment)
  pair, so the loads of a warp at step t are contiguous. The grid runs
  over blocks of ``_BLOCK_LANES`` lanes only; an in-kernel
  ``lax.fori_loop`` walks time with the state in registers.
* **Loads ahead of the recurrence.** Each loop step handles ``_UNROLL``
  samples and issues the NEXT step's ``_UNROLL`` loads before it runs
  the dependent chain on the current ones, so device-memory latency
  overlaps the arithmetic instead of stalling every step.
* **Segments fill the card.** Batch x channels is 16-512 rows against
  132 SMs, so each row splits into S segments along time
  (:func:`pick_segments`). The segments' incoming states are exact: a
  first pass with zero state gives each segment's final decaying max,
  a decaying-max scan across segments gives every segment's true
  incoming envelope; a second pass from those gives each segment's
  final one-pole value, and an affine scan gives the true incoming
  smoother state. The third pass runs from the exact states and emits
  the output, so no correction follows it and the soft-knee curve can
  be applied in the kernel. The first two passes read the signal and
  write only one float per lane.
* **Fused curve.** The output pass emits the soft-knee gain (linked
  channels) or the limited signal itself (mono: ``|x|`` detector, gain
  and clamp on the loaded values), so the envelope never reaches
  device memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from xmtpu.ops.limiter import _EPS, _knee_slope

_BLOCK_LANES = 32  # lanes per program: one warp, one lane per thread
_UNROLL = 16  # samples per loop step (and loads kept in flight)
_LANES_FILL = 32768  # segment lanes that keep 132 SMs busy
_MIN_SEGLEN = 512  # shortest segment worth its two extra passes
_LN10 = float(np.log(10.0))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_segments(R: int, n: int) -> int:
    """Segment count S for R rows of n samples: the largest divisor of
    n (exact corrections need equal segments) with R*S <= ``_LANES_FILL``
    and segments of at least ``_MIN_SEGLEN`` samples; 1 when the rows
    alone fill the card or n has no such divisor."""
    for s in range(max(1, _LANES_FILL // max(R, 1)), 1, -1):
        if n % s == 0 and n // s >= _MIN_SEGLEN:
            return s
    return 1


def _curve_gain(e2, curve):
    """Soft-knee static gain from the smoothed envelope
    (``ops.limiter.soft_knee_gain_db`` semantics in f32, with exp/log
    in place of log10/power). ``curve`` = (threshold_db, knee_db,
    ceiling_db, slope, makeup_db)."""
    threshold_db, knee_db, _ceiling_db, slope, makeup_db = curve
    level_db = (20.0 / _LN10) * jnp.log(jnp.maximum(e2, _EPS))
    over = level_db - threshold_db
    w = max(float(knee_db), 1e-6)
    in_knee = slope * (over + 0.5 * w) ** 2 / (2.0 * w)
    red = jnp.where(over <= -0.5 * w, 0.0,
                    jnp.where(over >= 0.5 * w, slope * over, in_knee))
    return jnp.exp((makeup_db - red) * (_LN10 / 20.0))


def _kernel(x_ref, init_ref, *out_refs, n, k_rel, c_att, absdet, emit,
            curve, unroll):
    if emit == "finals":
        (fin_ref,) = out_refs
        y_ref = None
    else:
        y_ref, fin_ref = out_refs
    a_att = 1.0 - c_att
    ceil_amp = None if curve is None else 10.0 ** (float(curve[2]) / 20.0)

    def load(t):
        return x_ref[pl.ds(t, 1), :]

    def step(xv, st):
        env, e2 = st
        d = jnp.abs(xv) if absdet else xv
        env = jnp.maximum(d, k_rel * env)
        e2 = a_att * e2 + c_att * env
        return env, e2

    def put(t, xv, e2):
        if emit == "gain":
            y_ref[pl.ds(t, 1), :] = _curve_gain(e2, curve)
        elif emit == "limit":
            y_ref[pl.ds(t, 1), :] = jnp.clip(
                xv * _curve_gain(e2, curve), -ceil_amp, ceil_amp)

    last = n - 1

    def body(i, carry):
        st, cur = carry[:2], carry[2:]
        t0 = i * unroll
        # next step's loads first (clamped at the end: a redundant
        # in-bounds load instead of a branch)
        nxt = tuple(load(jnp.minimum(t0 + unroll + j, last))
                    for j in range(unroll))
        for j in range(unroll):
            st = step(cur[j], st)
            if y_ref is not None:
                put(t0 + j, cur[j], st[1])
        return st + nxt

    def body1(t, st):
        xv = load(t)
        st = step(xv, st)
        if y_ref is not None:
            put(t, xv, st[1])
        return st

    st = (init_ref[pl.ds(0, 1), :], init_ref[pl.ds(1, 1), :])
    nfull = n // unroll
    if nfull:
        first = tuple(load(min(j, last)) for j in range(unroll))
        st = jax.lax.fori_loop(0, nfull, body, st + first)[:2]
    st = jax.lax.fori_loop(nfull * unroll, n, body1, st)
    fin_ref[pl.ds(0, 1), :] = st[0]
    fin_ref[pl.ds(1, 1), :] = st[1]


@functools.partial(jax.jit, static_argnames=(
    "k_rel", "c_att", "absdet", "emit", "curve", "interpret"))
def _run(xt, init, *, k_rel, c_att, absdet, emit, curve, interpret):
    """One kernel pass over time-major ``xt`` (n, L) f32 from per-lane
    states ``init`` (2, L). -> (y (n, L) or None, finals (2, L))."""
    n, L = xt.shape
    bl = _BLOCK_LANES
    Lp = _cdiv(L, bl) * bl
    if Lp != L:
        xt = jnp.pad(xt, ((0, 0), (0, Lp - L)))
        init = jnp.pad(init, ((0, 0), (0, Lp - L)))
    kern = functools.partial(
        _kernel, n=n, k_rel=float(k_rel), c_att=float(c_att),
        absdet=absdet, emit=emit, curve=curve, unroll=_UNROLL)
    sig = pl.BlockSpec((n, bl), lambda b: (0, b))
    st = pl.BlockSpec((2, bl), lambda b: (0, b))
    out_specs = [st]
    out_shape = [jax.ShapeDtypeStruct((2, Lp), jnp.float32)]
    if emit != "finals":
        out_specs = [sig] + out_specs
        out_shape = [jax.ShapeDtypeStruct((n, Lp), jnp.float32)] + out_shape
    # index math in int32: the package runs with x64 on
    with jax.enable_x64(False):
        outs = pl.pallas_call(
            kern, grid=(Lp // bl,), in_specs=[sig, st],
            out_specs=out_specs, out_shape=out_shape,
            compiler_params=plgpu.CompilerParams(num_warps=bl // 32,
                                                 num_stages=1),
            interpret=interpret, name=f"xm_envelope_{emit}",
        )(xt.astype(jnp.float32), init.astype(jnp.float32))
    y = None if emit == "finals" else outs[0][:, :L]
    return y, outs[-1][:, :L]


def _affine_scan(v, p, init):
    """s[j] = v[j] + p * s[j-1] along the last axis, s[-1] = init."""
    def comb(lhs, rhs):
        return rhs[1] * lhs[0] + rhs[0], lhs[1] * rhs[1]

    s, pw = jax.lax.associative_scan(comb, (v, jnp.full_like(v, p)),
                                     axis=-1)
    return s + pw * init[..., None]


def _rows(x2d, init2, k_rel, c_att, *, absdet, emit, curve, segments,
          interpret):
    """Envelope/limiter over rows ``x2d`` (R, n) from states ``init2``
    (2, R). -> (y (R, n), (env_last, e2_last))."""
    R, n = x2d.shape
    S = pick_segments(R, n) if segments is None else int(segments)
    if S < 1 or n % S:
        raise ValueError(f"segments={S} must divide n={n} (exact state "
                         "corrections need equal segments)")
    seg = n // S
    # lane r*S + s holds segment s of row r, time-major
    xt = x2d.reshape(R * S, seg).T
    run = functools.partial(_run, xt, k_rel=k_rel, c_att=c_att,
                            absdet=absdet, curve=curve, interpret=interpret)
    init2 = init2.astype(jnp.float32)
    if S == 1:
        init = init2
    else:
        # exact incoming states (module docstring "Segments")
        zero = jnp.zeros((R, S), jnp.float32)
        _, f1 = run(jnp.zeros((2, R * S), jnp.float32), emit="finals")
        kp = float(k_rel) ** seg
        env_end = jax.lax.associative_scan(
            lambda l, r: (jnp.maximum(r[0], r[1] * l[0]), l[1] * r[1]),
            (f1[0].reshape(R, S), jnp.full((R, S), kp, jnp.float32)),
            axis=-1)[0]
        env_end = jnp.maximum(
            env_end, (kp ** np.arange(1, S + 1, dtype=np.float64)
                      ).astype(np.float32) * init2[0][:, None])
        e_in = jnp.concatenate([init2[0][:, None], env_end[:, :-1]], -1)
        _, f2 = run(jnp.stack([e_in.reshape(-1), zero.reshape(-1)]),
                    emit="finals")
        ap = (1.0 - float(c_att)) ** seg
        e2_end = _affine_scan(f2[1].reshape(R, S), ap, init2[1])
        s_in = jnp.concatenate([init2[1][:, None], e2_end[:, :-1]], -1)
        init = jnp.stack([e_in.reshape(-1), s_in.reshape(-1)])
    y, fin = run(init, emit=emit)
    last = fin.reshape(2, R, S)[:, :, -1]
    return y.T.reshape(R, n), (last[0], last[1])


def _init2(init, batch, R):
    if init is None:
        return jnp.zeros((2, R), jnp.float32)
    return jnp.stack([jnp.asarray(init[0], jnp.float32).reshape(R),
                      jnp.asarray(init[1], jnp.float32).reshape(R)])


def limiter_kernel(x, k_rel: float, c_att: float, threshold_db: float,
                   knee_db: float = 6.0, ceiling_db: float = 0.0,
                   ratio: float = float("inf"), makeup_db: float = 0.0,
                   init=None, segments=None, interpret: bool = False):
    """Soft-knee limiter of ``x`` shaped (..., ch, n), channels linked
    (``ops.limiter`` pinned semantics, f32, exp/log in the curve).

    One channel: detector, envelope, gain and clamp all run in the
    kernel's output pass, reading ``x`` and writing ``y``. Several
    channels: the linked detector ``max_ch |x|`` is one XLA reduction,
    the kernel emits the gain, and XLA applies it to every channel.
    Returns (y, (env_last, e2_last)) with states shaped (...,).
    """
    curve = (float(threshold_db), float(knee_db), float(ceiling_db),
             _knee_slope(ratio), float(makeup_db))
    x = jnp.asarray(x)
    batch, ch, n = x.shape[:-2], x.shape[-2], x.shape[-1]
    R = int(np.prod(batch)) if batch else 1
    xf = x.astype(jnp.float32)
    kw = dict(curve=curve, segments=segments, interpret=interpret)
    init2 = _init2(init, batch, R)
    if ch == 1:
        y, (el, sl) = _rows(xf.reshape(R, n), init2, k_rel, c_att,
                            absdet=True, emit="limit", **kw)
        y = y.reshape(x.shape)
    else:
        d = jnp.max(jnp.abs(xf), axis=-2).reshape(R, n)
        g, (el, sl) = _rows(d, init2, k_rel, c_att, absdet=False,
                            emit="gain", **kw)
        ceil_amp = 10.0 ** (float(ceiling_db) / 20.0)
        y = jnp.clip(xf * g.reshape(*batch, 1, n), -ceil_amp, ceil_amp)
    return y.astype(x.dtype), (el.reshape(batch), sl.reshape(batch))
