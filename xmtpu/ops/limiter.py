"""Soft-knee limiter: envelope follower + static gain curve + safety clamp.

Reference analogue: the output-protection limiter (``src/effects/``
[upstream, SURVEY.md §2.1], SoX-compand-style); rebuilt as a soft-knee
limiter per ``BASELINE.json:9``.

Pinned semantics (the numpy oracle mirrors these exactly):

1. **Detector** ``d[n] = max_ch |x[n]|`` — channels are linked (one gain
   for all channels, the standard choice to preserve stereo image).
   Input is ``(..., ch, n)``; only the channel axis (-2) is linked, so
   batched clips each get an independent envelope.
2. **Peak envelope, instant attack / exponential release**:
   ``env[n] = max(d[n], k_rel * env[n-1])``, ``k_rel = exp(-1/(release_ms
   * sr / 1000))``. A max-affine recurrence -> associative scan with
   elements ``(v, p)`` and combine ``(max(v2, p2*v1), p1*p2)``.
3. **Attack smoothing** (optional, ``attack_ms > 0``): one-pole low-pass
   of the envelope, ``e2[n] = (1-c) e2[n-1] + c env[n]`` — a *linear*
   recurrence, second associative scan. ``attack_ms = 0`` -> identity.
4. **Soft-knee static curve** in dB (threshold T, knee width W):
   reduction 0 below ``T - W/2``; ``(over + W/2)^2 / (2W)`` inside the
   knee; ``over`` above ``T + W/2``. ``gain = 10^(-reduction/20)``.
5. **Safety clamp** at ``ceiling_db``: ``y = clip(g*x, ±ceil)`` — makes
   the "no sample above ceiling" property exact (SURVEY.md §4.2) while
   the soft path does the musical work.

The XLA engine runs both recurrences as float64 associative scans; the
card's engine runs them as one f32 per-lane loop (``kernels/envelope.py``).
No lookahead (the reference has none); attack smoothing briefly
under-estimates the envelope on transients, which the clamp covers.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu import engine as _engine

_EPS = 1e-12


def _release_coeff(release_ms: float, sr: int) -> float:
    if release_ms <= 0:
        return 0.0
    return math.exp(-1.0 / (release_ms * sr / 1000.0))


def _attack_coeff(attack_ms: float, sr: int) -> float:
    if attack_ms <= 0:
        return 1.0  # identity smoothing
    return 1.0 - math.exp(-1.0 / (attack_ms * sr / 1000.0))


def _decay_max_combine(lhs, rhs):
    lv, lp = lhs
    rv, rp = rhs
    return jnp.maximum(rv, rp * lv), lp * rp


def decaying_max_scan(d, k: float, init):
    """env[n] = max(d[n], k*env[n-1]) over the last axis; init = env[-1].
    Returns (env, env_last)."""
    init = jnp.asarray(init, d.dtype)  # accept plain-float state like
    # the numpy oracle's documented (0.0, 0.0) default
    p = jnp.full_like(d, k)
    v, _ = jax.lax.associative_scan(_decay_max_combine, (d, p), axis=-1)
    # fold the initial condition: env[n] = max(v[n], k^(n+1) * init)
    npts = d.shape[-1]
    expo = jnp.arange(1, npts + 1, dtype=d.dtype)
    decay = jnp.exp(expo * jnp.log(jnp.asarray(k, d.dtype))) if k > 0 else jnp.zeros(
        npts, d.dtype
    )
    env = jnp.maximum(v, decay * init[..., None])
    return env, env[..., -1]


def _onepole_combine(lhs, rhs):
    lv, lp = lhs
    rv, rp = rhs
    return rp * lv + rv, lp * rp


def onepole_scan(u, c: float, init):
    """e[n] = (1-c) e[n-1] + c u[n] over the last axis; init = e[-1].
    Returns (e, e_last)."""
    init = jnp.asarray(init, u.dtype)  # accept plain-float state
    if c >= 1.0:
        return u, u[..., -1]
    a = 1.0 - c
    v, _ = jax.lax.associative_scan(
        _onepole_combine, (c * u, jnp.full_like(u, a)), axis=-1
    )
    npts = u.shape[-1]
    expo = jnp.arange(1, npts + 1, dtype=u.dtype)
    e = v + jnp.exp(expo * jnp.log(jnp.asarray(a, u.dtype))) * init[..., None]
    return e, e[..., -1]


def _knee_slope(ratio) -> float:
    """Reduction slope from a compression ratio; shared by the jax and
    numpy-oracle curves. ratio < 1 is expansion and ratio == 0 divided
    by zero (fuzz find: a compressor config leaked ZeroDivisionError)."""
    if not float(ratio) >= 1.0:  # also rejects NaN
        raise ValueError(f"ratio must be >= 1 (inf = limiter), got {ratio}")
    return 1.0 if ratio == float("inf") else 1.0 - 1.0 / float(ratio)


def soft_knee_gain_db(level_db, threshold_db: float, knee_db: float,
                      ratio: float = float("inf")):
    """Gain (<= 0 dB) from the soft-knee static curve. Elementwise.

    ``ratio``: compression ratio. inf = limiter (reduction == overshoot);
    finite r reduces by ``over * (1 - 1/r)`` above threshold — the
    SoX-compand-style downward compressor (SURVEY.md §2.1 "Limiter /
    compressor" row). The knee blends quadratically in both cases.
    """
    slope = _knee_slope(ratio)
    over = level_db - threshold_db
    w = max(float(knee_db), 1e-6)
    in_knee = slope * (over + 0.5 * w) ** 2 / (2.0 * w)
    red = jnp.where(
        over <= -0.5 * w, 0.0, jnp.where(over >= 0.5 * w, slope * over, in_knee)
    )
    return -red


def apply_gain_curve(x, e2, threshold_db: float, knee_db: float = 6.0,
                     ceiling_db: float = 0.0, ratio: float = float("inf"),
                     makeup_db: float = 0.0):
    """Steps 4-5 of the pinned limiter math: soft-knee static curve on
    the smoothed envelope ``e2`` (..., n), gain applied to ``x``
    (..., ch, n), safety clamp. Elementwise — fuses in XLA."""
    level_db = 20.0 * jnp.log10(jnp.maximum(e2, _EPS))
    g = jnp.power(
        10.0,
        (soft_knee_gain_db(level_db, threshold_db, knee_db, ratio) + makeup_db)
        / 20.0,
    )
    ceil_amp = 10.0 ** (ceiling_db / 20.0)
    return jnp.clip(x * g[..., None, :], -ceil_amp, ceil_amp)


def limiter(
    x: jnp.ndarray,
    sr: int,
    threshold_db: float = -3.0,
    knee_db: float = 6.0,
    attack_ms: float = 1.0,
    release_ms: float = 100.0,
    ceiling_db: float = 0.0,
    state=None,
    backend: str = "xla",
    ratio: float = float("inf"),
    makeup_db: float = 0.0,
):
    """Soft-knee limit ``x`` shaped (..., channels, n). Jittable.

    Channels (axis -2) are linked; leading axes are independent batch
    dims. Returns (y, state) where state = (env_last, smooth_last),
    shaped (...,), carried across streaming blocks (SURVEY.md §3.2
    state list).

    ``backend``: an engine name (``xmtpu.engine``). "xla" = float64
    associative scans (oracle-grade); "gpu" = the f32 Pallas Triton
    kernel of ``kernels/envelope.py`` with the curve applied in the
    kernel ("gpu_interpret" runs it in interpret mode); "auto" = the
    platform's engine.
    """
    eng, interpret = _engine.resolve(backend)
    k_rel = _release_coeff(release_ms, sr)
    c_att = _attack_coeff(attack_ms, sr)
    in_dtype = x.dtype
    if eng == _engine.GPU:
        from xmtpu.kernels.envelope import limiter_kernel

        return limiter_kernel(
            x, k_rel, c_att, threshold_db, knee_db=knee_db,
            ceiling_db=ceiling_db, ratio=ratio, makeup_db=makeup_db,
            init=state, interpret=interpret)
    xf = x.astype(jnp.float64)
    d = jnp.max(jnp.abs(xf), axis=-2)  # linked channels: (..., n)
    if state is None:
        z = jnp.zeros(d.shape[:-1], jnp.float64)
        state = (z, z)
    env_init, sm_init = (jnp.asarray(s, jnp.float64) for s in state)
    env, env_last = decaying_max_scan(d, k_rel, env_init)
    e2, sm_last = onepole_scan(env, c_att, sm_init)
    y = apply_gain_curve(xf, e2, threshold_db, knee_db, ceiling_db, ratio,
                         makeup_db)
    return y.astype(in_dtype), (env_last, sm_last)


# ---------------------------------------------------------------------------
# Numpy oracle (float64, sequential) — mirrors the pinned math exactly.
# ---------------------------------------------------------------------------


def limiter_np(
    x,
    sr,
    threshold_db=-3.0,
    knee_db=6.0,
    attack_ms=1.0,
    release_ms=100.0,
    ceiling_db=0.0,
    state=(0.0, 0.0),
    ratio=float("inf"),
    makeup_db=0.0,
):
    x = np.asarray(x, np.float64)
    k_rel = _release_coeff(release_ms, sr)
    c_att = _attack_coeff(attack_ms, sr)
    d = np.max(np.abs(x), axis=-2)  # (..., n): channels linked, batch free
    env_prev = np.broadcast_to(np.asarray(state[0], np.float64), d.shape[:-1]).copy()
    sm_prev = np.broadcast_to(np.asarray(state[1], np.float64), d.shape[:-1]).copy()
    n = d.shape[-1]
    env = np.empty_like(d)
    e2 = np.empty_like(d)
    for i in range(n):
        env_prev = np.maximum(d[..., i], k_rel * env_prev)
        env[..., i] = env_prev
        sm_prev = (1.0 - c_att) * sm_prev + c_att * env_prev if c_att < 1.0 else env_prev
        e2[..., i] = sm_prev
    level_db = 20.0 * np.log10(np.maximum(e2, _EPS))
    slope = _knee_slope(ratio)
    over = level_db - threshold_db
    w = max(float(knee_db), 1e-6)
    red = np.where(
        over <= -0.5 * w, 0.0,
        np.where(over >= 0.5 * w, slope * over,
                 slope * (over + 0.5 * w) ** 2 / (2 * w))
    )
    g = 10.0 ** ((-red + makeup_db) / 20.0)
    ceil_amp = 10.0 ** (ceiling_db / 20.0)
    y = np.clip(x * g[..., None, :], -ceil_amp, ceil_amp)
    return y, (env_prev, sm_prev)
