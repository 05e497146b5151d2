"""Mixing primitives: gain, fade ramps, N-track sum, normalization.

Reference analogue: the mixer C loops (``src/effects/mixer_effects/`` —
``mixer_mix``, ``fade_in/fade_out``, ``check_fade_in_out``, volume and
normalization helpers [upstream, SURVEY.md §2.1]).

Design: fades are piecewise-linear ramps computed **in the fused
elementwise pass from scalar parameters** (iota + clip), never
materialized as device arrays (SURVEY.md §3.4); the whole mix is one fused elementwise
pass that XLA combines with the surrounding format conversions.

Pinned ramp semantics (tested against the numpy oracle sample-by-sample):

* fade-in over ``F`` samples: sample ``i`` (0-based from track start)
  gets gain ``min(1, (i+1)/F)`` — the first sample is ``1/F``, sample
  ``F-1`` is the first at unity.
* fade-out over ``F`` samples of a track of length ``N``: sample ``i``
  gets gain ``min(1, (N-i)/F)`` — the last sample is ``1/F``.
* both ramps multiply (a short track may be inside both windows).

Normalization (``BASELINE.json:5,8``):

* ``peak``: scale so max |sample| == target amplitude (always rescales,
  up or down; silence is passed through).
* ``rms`` (legacy alias ``loudness``): scale so plain unweighted RMS ==
  target amplitude (same silence rule).
* ``lufs``: ITU-R BS.1770 gated loudness — see ``ops.loudness``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def fade_ramp(n: int, fade_in: int, fade_out: int, length: int,
              offset: int = 0, dtype=jnp.float32) -> jnp.ndarray:
    """Gain ramp for samples [offset, offset+n) of a length-`length` track.

    All parameters are static Python ints (config-derived), so the ramp
    folds into the surrounding fused elementwise computation.
    """
    # f64 indices: an f32 arange cannot represent integers above 2^24
    # (~6 min at 48 kHz), quantizing fade gains into plateaus on long
    # tracks/offsets (round-2 review find); the gain itself casts back
    # to the compute dtype
    i = jnp.arange(offset, offset + n, dtype=jnp.float64)
    g = jnp.ones(n, jnp.float64)
    if fade_in > 0:
        g = g * jnp.clip((i + 1.0) / float(fade_in), None, 1.0)
    if fade_out > 0:
        g = g * jnp.clip((float(length) - i) / float(fade_out), 0.0, 1.0)
    return g.astype(dtype)


def apply_gain_fade(x: jnp.ndarray, gain: float, fade_in: int, fade_out: int,
                    offset: int = 0, length: int | None = None) -> jnp.ndarray:
    """gain * ramp * x over the last axis. Static scalar params."""
    n = x.shape[-1]
    if length is None:
        length = offset + n
    ramp = fade_ramp(n, fade_in, fade_out, length, offset, x.dtype)
    return x * (ramp * jnp.asarray(gain, x.dtype))


def mix_sum(tracks: jnp.ndarray) -> jnp.ndarray:
    """Sum already-gained/faded/aligned tracks: [T, ..., n] -> [..., n].

    The reference clips the int16 sum; xmtpu sums in f32 and leaves
    protection to normalize/limiter (clipping happens only at the final
    f32->int16 conversion, which is clip-safe by definition).
    """
    return jnp.sum(tracks, axis=0)


def peak_normalize(x: jnp.ndarray, target_amp: float,
                   where=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scale so max|x| == target_amp. Returns (scaled, scale_used).

    ``where``: optional bool mask (True = real sample) so padded batch
    entries don't contribute to the peak (SURVEY.md §7.3 ragged rule).
    """
    ax = jnp.abs(x)
    if where is not None:
        ax = jnp.where(where, ax, 0)
    peak = jnp.max(ax)
    scale = jnp.where(peak > 0, jnp.asarray(target_amp, x.dtype) / peak, 1.0)
    return x * scale, scale


def rms_normalize(x: jnp.ndarray, target_amp: float,
                  where=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scale so RMS == target_amp ('loudness' mode). Returns (scaled, scale)."""
    sq = jnp.square(x)
    if where is not None:
        n = jnp.maximum(jnp.sum(where), 1)
        ms = jnp.sum(jnp.where(where, sq, 0)) / n
    else:
        ms = jnp.mean(sq)
    rms = jnp.sqrt(ms)
    scale = jnp.where(rms > 0, jnp.asarray(target_amp, x.dtype) / rms, 1.0)
    return x * scale, scale


def db_to_amp(db: float) -> float:
    return float(10.0 ** (db / 20.0))


def duck_gain_block(
    voice_bus: jnp.ndarray,
    sr: int,
    state,
    threshold_db: float = -40.0,
    depth_db: float = 12.0,
    knee_db: float = 10.0,
    attack_ms: float = 10.0,
    release_ms: float = 300.0,
):
    """Stateful ducking gain for one block (..., n) -> (gain, state).

    ``state``: (env_last, smooth_last) shaped (...,) f64 — the streaming
    session carries it across frames so streaming ducking == offline
    (same scans as :func:`duck_gain`, which is this with zero state).
    """
    from xmtpu.ops import limiter as _lim

    d = jnp.abs(voice_bus.astype(jnp.float64))
    k_rel = _lim._release_coeff(release_ms, sr)
    c_att = _lim._attack_coeff(attack_ms, sr)
    if state is None:
        z = jnp.zeros(d.shape[:-1], d.dtype)
        state = (z, z)
    env, env_last = _lim.decaying_max_scan(d, k_rel, state[0])
    e2, sm_last = _lim.onepole_scan(env, c_att, state[1])
    env_db = 20.0 * jnp.log10(jnp.maximum(e2, 1e-12))
    x = jnp.clip((env_db - threshold_db) / knee_db + 0.5, 0.0, 1.0)
    return jnp.power(10.0, -depth_db * x / 20.0), (env_last, sm_last)


def duck_gain(
    voice_bus: jnp.ndarray,
    sr: int,
    threshold_db: float = -40.0,
    depth_db: float = 12.0,
    knee_db: float = 10.0,
    attack_ms: float = 10.0,
    release_ms: float = 300.0,
) -> jnp.ndarray:
    """Side-chain ducking gain from a voice bus (..., n) -> gain (..., n).

    Reference analogue: the mixer's BGM-under-voice ducking [upstream,
    SURVEY.md §2.1 Mixer row]. Pinned xmtpu semantics (the upstream
    snapshot is a stub, so these ARE the spec, mirrored by
    :func:`duck_gain_np`):

    1. envelope of |voice| with instant-attack/exp-release decaying max
       then one-pole attack smoothing (the limiter's detector machinery,
       ops.limiter);
    2. soft-edged gate: x = clip((env_db - threshold_db)/knee_db + 0.5,
       0, 1); gain_db = -depth_db * x — full depth when the voice is
       clearly above threshold, unity when clearly below, linear blend
       across the knee.
    """
    g, _ = duck_gain_block(voice_bus, sr, None, threshold_db, depth_db,
                           knee_db, attack_ms, release_ms)
    return g


def duck_gain_np(voice_bus, sr, threshold_db=-40.0, depth_db=12.0,
                 knee_db=10.0, attack_ms=10.0, release_ms=300.0):
    """Sequential float64 oracle for :func:`duck_gain`."""
    from xmtpu.ops import limiter as _lim

    d = np.abs(np.asarray(voice_bus, np.float64))
    k_rel = _lim._release_coeff(release_ms, sr)
    c_att = _lim._attack_coeff(attack_ms, sr)
    env_prev = np.zeros(d.shape[:-1])
    sm_prev = np.zeros(d.shape[:-1])
    e2 = np.empty_like(d)
    for i in range(d.shape[-1]):
        env_prev = np.maximum(d[..., i], k_rel * env_prev)
        sm_prev = (1 - c_att) * sm_prev + c_att * env_prev if c_att < 1.0 \
            else env_prev
        e2[..., i] = sm_prev
    env_db = 20.0 * np.log10(np.maximum(e2, 1e-12))
    x = np.clip((env_db - threshold_db) / knee_db + 0.5, 0.0, 1.0)
    return 10.0 ** (-depth_db * x / 20.0)


# ---------------------------------------------------------------------------
# Numpy oracle (float64) — the golden reference for all mixer tests
# (SURVEY.md §4.2 "20-line numpy reference; exact ramp-boundary indices").
# ---------------------------------------------------------------------------


def fade_ramp_np(n, fade_in, fade_out, length, offset=0):
    i = np.arange(offset, offset + n, dtype=np.float64)
    g = np.ones(n)
    if fade_in > 0:
        g *= np.minimum((i + 1.0) / fade_in, 1.0)
    if fade_out > 0:
        g *= np.clip((length - i) / fade_out, 0.0, 1.0)
    return g


def mix_oracle_np(tracks, gains, fades_in, fades_out, normalize=None,
                  target_amp=None):
    """tracks: list of equal-length f64 arrays already aligned in time."""
    out = np.zeros_like(np.asarray(tracks[0], np.float64))
    for x, g, fi, fo in zip(tracks, gains, fades_in, fades_out):
        x = np.asarray(x, np.float64)
        out = out + g * fade_ramp_np(len(x), fi, fo, len(x)) * x
    if normalize == "peak":
        peak = np.max(np.abs(out))
        if peak > 0:
            out = out * (target_amp / peak)
    elif normalize == "loudness":
        rms = np.sqrt(np.mean(out**2))
        if rms > 0:
            out = out * (target_amp / rms)
    return out
