"""ITU-R BS.1770-4 loudness (LUFS) measurement + normalization.

Reference analogue: the "loudness normalization" half of the
normalization row (``src/effects/`` [upstream, SURVEY.md §2.1];
``BASELINE.json:5,8`` "peak/loudness normalization"). Round 1 shipped
plain RMS under the name "loudness"; this module is the real
K-weighted, gated measurement.

Algorithm (BS.1770-4):

1. K-weighting pre-filter: a +4 dB high-shelf (the "head" stage) then a
   high-pass (the RLB stage), cascaded biquads. The standard tabulates
   coefficients at 48 kHz only; for other rates the filters are
   re-designed from the underlying analog parameters (the pyloudnorm /
   De Man parameterization), which reproduces the 48 kHz table to 1e-6.
2. Mean-square over 400 ms blocks, 75% overlap (100 ms hop); block
   loudness l_j = -0.691 + 10 log10(sum_ch G_ch z_j,ch), G=1 for
   mono/stereo channels.
3. Absolute gate at -70 LUFS, then a relative gate 10 LU below the
   power-mean of surviving blocks; integrated loudness = power-mean of
   the doubly-gated blocks.

The device path computes block mean-squares from one cumulative sum
(O(n) elementwise + a strided gather — no per-block loops) and the
K-weighting through the float64 biquad scan; gates are masked
reductions. ``measure_lufs_np`` is the float64 scipy oracle.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

ABS_GATE_LUFS = -70.0
REL_GATE_LU = -10.0
BLOCK_S = 0.400
HOP_S = 0.100


def k_weighting_sos(sr: int) -> np.ndarray:
    """K-weighting cascade as a (2, 6) sos array at sample rate ``sr``.

    Stage 1 (shelf) and stage 2 (high-pass) from the BS.1770 analog
    prototype (De Man parameterization); at sr=48000 this reproduces
    the coefficient table printed in BS.1770-4 itself.
    """
    # stage 1: high shelf f0=1681.97 Hz, G=+3.9998 dB, Q=0.7072
    f0, g_db, q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    k = math.tan(math.pi * f0 / sr)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_sh = [
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
    ]
    a_sh = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]

    # stage 2: high pass f0=38.135 Hz, Q=0.5003
    f0, q = 38.13547087613982, 0.5003270373253953
    k = math.tan(math.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    b_hp = [1.0, -2.0, 1.0]  # the standard's table keeps these unscaled
    a_hp = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]

    return np.array([b_sh + a_sh, b_hp + a_hp], np.float64)


def _block_geometry(n: int, sr: int):
    block = int(round(BLOCK_S * sr))
    hop = int(round(HOP_S * sr))
    if n < block:  # short-signal fallback: one block of everything
        return n, max(n, 1), 1
    return block, hop, (n - block) // hop + 1


def measure_lufs(x: jnp.ndarray, sr: int) -> jnp.ndarray:
    """Integrated loudness (LUFS) of ``x`` shaped (n,) or (ch, n).

    jit-safe; the K-weighting is the float64 biquad scan on every
    platform. Silence (no block passes the absolute gate) returns -inf.
    """
    from xmtpu.ops import biquad as _biquad
    from xmtpu.ops import convert as _convert

    x = jnp.asarray(x)
    if x.dtype == jnp.int16:
        # int16 straight through astype(f32) read ~90.3 dB too loud
        # (review find); use the pinned PCM scaling like every other
        # public op
        x = _convert.pcm16_to_f32(x)
    if x.ndim == 1:
        x = x[None]
    n = x.shape[-1]
    sos = k_weighting_sos(sr)
    xw, _ = _biquad.sosfilt_scan(sos, x.astype(jnp.float32),
                                 state_dtype=jnp.float64)

    block, hop, nblk = _block_geometry(n, sr)
    cs = jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (1,), jnp.float64),
         jnp.cumsum(jnp.square(xw.astype(jnp.float64)), axis=-1)], axis=-1
    )
    starts = jnp.arange(nblk) * hop
    z = (cs[..., starts + block] - cs[..., starts]) / block  # (ch, nblk)
    power = jnp.sum(z, axis=0)  # channel weights G=1 (mono/stereo)
    l_blk = -0.691 + 10.0 * jnp.log10(jnp.maximum(power, 1e-30))

    abs_mask = l_blk > ABS_GATE_LUFS
    n_abs = jnp.maximum(jnp.sum(abs_mask), 1)
    p_abs = jnp.sum(jnp.where(abs_mask, power, 0.0)) / n_abs
    rel_thresh = -0.691 + 10.0 * jnp.log10(jnp.maximum(p_abs, 1e-30)) \
        + REL_GATE_LU
    mask = abs_mask & (l_blk > rel_thresh)
    n_g = jnp.maximum(jnp.sum(mask), 1)
    p_g = jnp.sum(jnp.where(mask, power, 0.0)) / n_g
    lufs = -0.691 + 10.0 * jnp.log10(jnp.maximum(p_g, 1e-30))
    return jnp.where(jnp.any(abs_mask), lufs, -jnp.inf)


def lufs_normalize(x: jnp.ndarray, sr: int, target_lufs: float = -23.0):
    """Scale ``x`` so its integrated loudness hits ``target_lufs``.
    Returns (scaled, linear_gain). Silence passes through (gain 1)."""
    from xmtpu.ops import convert as _convert

    x = jnp.asarray(x)
    was_i16 = x.dtype == jnp.int16
    xf = _convert.pcm16_to_f32(x) if was_i16 else x
    lufs = measure_lufs(xf, sr)
    gain = jnp.where(
        jnp.isfinite(lufs),
        jnp.power(10.0, (target_lufs - lufs) / 20.0),
        1.0,
    ).astype(jnp.float32)
    # gain stays f32: casting it to the INPUT dtype truncated e.g.
    # 0.03 to int16 zero and returned all-silence (review find);
    # int16 callers get pinned-converted int16 back instead
    y = xf * gain
    if was_i16:
        y = _convert.f32_to_pcm16(y)
    return y, gain


# ---------------------------------------------------------------------------
# float64 scipy oracle
# ---------------------------------------------------------------------------


def measure_lufs_np(x, sr: int) -> float:
    from scipy import signal as sps

    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None]
    n = x.shape[-1]
    xw = sps.sosfilt(k_weighting_sos(sr), x, axis=-1)
    block, hop, nblk = _block_geometry(n, sr)
    power = np.array([
        np.sum(np.mean(xw[:, j * hop : j * hop + block] ** 2, axis=-1))
        for j in range(nblk)
    ])
    l_blk = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))
    abs_mask = l_blk > ABS_GATE_LUFS
    if not np.any(abs_mask):
        return float("-inf")
    p_abs = np.mean(power[abs_mask])
    rel = -0.691 + 10.0 * np.log10(p_abs) + REL_GATE_LU
    mask = abs_mask & (l_blk > rel)
    if not np.any(mask):
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(np.mean(power[mask])))
