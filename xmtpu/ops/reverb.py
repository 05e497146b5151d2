"""FIR reverb: impulse-response convolution via FFT overlap machinery.

Reference analogue: ``src/effects/reverb/`` [upstream, SURVEY.md §2.1] —
upstream used a SoX-derived algorithmic reverb; the rebuild pins reverb
as **FIR convolution with an impulse response** per ``BASELINE.json:5,9``
(0.5 s IR @ 48 kHz stereo is the headline config).

Design: at 24k taps, FFT convolution beats time-domain by orders of
magnitude (SURVEY.md §3.5); the whole-clip path is one
``jnp.fft.rfft``/``irfft`` pair in XLA, and the block path (streaming /
fused pipeline) is overlap-add with a carried tail — the tail is the
FIR analogue of IIR state for cross-block sequence decomposition
(SURVEY.md §5 "long-context").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def os_block(m: int) -> int:
    """Overlap-save FFT block for an m-tap IR: the smallest power of two
    >= 4*(m-1) (useful hop >= 3/4 of the block), floored at 32768.
    Shared by the batch steps and the effect chains."""
    b = 32768
    while b < 4 * max(1, m - 1):
        b *= 2
    return b


def trim_ir_tail(h: np.ndarray, rel: float = 1e-6) -> np.ndarray:
    """Drop the numerically-dead tail of a host-side impulse response:
    keep taps through the last index whose REMAINING l1 mass exceeds
    ``rel`` x the total l1 mass (~-120 dB of residual energy at the
    default). Composed IRs (e.g. the LTI fold's h_eq (*) ir) can decay
    sooner than len(a)+len(b)-1, and an untrimmed tap count can push
    the overlap-save block past a power-of-two boundary the trimmed
    one would not cross — shared by graph.fx._fold_lti
    and batch._combined_ir so the two fold paths cannot drift."""
    h = np.asarray(h)
    tail = np.cumsum(np.abs(h[::-1]))[::-1]
    if tail.size == 0 or tail[0] <= 0:
        return h
    over = np.nonzero(tail > rel * tail[0])[0]
    return h[: (int(over[-1]) + 1 if over.size else 1)]


def fir_convolve_full(x: jnp.ndarray, ir: jnp.ndarray) -> jnp.ndarray:
    """Full linear convolution of the last axis with a 1-D IR via FFT.

    ``x``: (..., n) float; ``ir``: (m,) float. Returns (..., n + m - 1)
    in x.dtype. Compute is f32 (f64 for f64 input); the headroom vs the
    f64 oracle is far below the -80 dB budget (see tests).
    """
    n = x.shape[-1]
    m = ir.shape[-1]
    nfft = _next_pow2(n + m - 1)
    dt = jnp.float32 if x.dtype != jnp.float64 else jnp.float64
    X = jnp.fft.rfft(x.astype(dt), n=nfft, axis=-1)
    H = jnp.fft.rfft(ir.astype(dt), n=nfft, axis=-1)
    y = jnp.fft.irfft(X * H, n=nfft, axis=-1)[..., : n + m - 1]
    return y.astype(x.dtype)


def fir_convolve_os(x: jnp.ndarray, ir: jnp.ndarray, block: int = 65536):
    """Same-length causal convolution via overlap-save FFT blocks.

    Each block FFT is size ``block`` instead of next_pow2(n+m-1) —
    fewer FFT flops at the headline shapes (and much less live memory);
    the blocks stack into ONE batched FFT. Requires block > len(ir); falls back to the full
    transform otherwise. Output matches :func:`fir_convolve_full`[:n]
    to f32 rounding (tested).
    """
    n = x.shape[-1]
    m = ir.shape[-1]
    if block <= 2 * (m - 1) or n <= block:
        return fir_convolve_full(x, ir)[..., :n]
    hop = block - (m - 1)  # useful samples per block
    nblk = -(-n // hop)
    batch = x.shape[:-1]
    dt = jnp.float32 if x.dtype != jnp.float64 else jnp.float64
    # block b covers output [b*hop, b*hop + hop); needs input
    # [b*hop - (m-1), b*hop + hop) -> left-pad by m-1 and frame by hop
    pad = [(0, 0)] * (x.ndim - 1) + [(m - 1, nblk * hop - n)]
    xp = jnp.pad(x.astype(dt), pad)  # (..., m-1 + nblk*hop)
    frames = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(xp, b * hop, block, axis=-1)
         for b in range(nblk)],
        axis=-2,
    )  # (..., nblk, block)
    H = jnp.fft.rfft(ir.astype(dt), n=block, axis=-1)
    Y = jnp.fft.irfft(jnp.fft.rfft(frames, axis=-1) * H, n=block, axis=-1)
    y = Y[..., m - 1 :]  # valid region of each block: (..., nblk, hop)
    y = y.reshape(*batch, nblk * hop)[..., :n]
    return y.astype(x.dtype)


def reverb(
    x: jnp.ndarray, ir: jnp.ndarray, wet: float = 0.3, dry: float = 0.7,
    block: int | None = None, prescale=None,
) -> jnp.ndarray:
    """Wet/dry reverb, output length == input length (tail truncated —
    the reference's same-length PCM-in/PCM-out convention).

    ``block``: use overlap-save FFT blocks of this size (None = one
    full-size transform). The FFTs are XLA's (cuFFT on the GPU).

    ``prescale``: broadcastable gain applied to the INPUT by linearity
    — ``reverb(s*x) == s*reverb(x)`` exactly, so the multiply rides the
    post-convolution wet/dry combine (one fused elementwise pass)."""
    n = x.shape[-1]
    if block is not None:
        w = fir_convolve_os(x, ir, block)
    else:
        w = fir_convolve_full(x, ir)[..., :n]
    dry_g = jnp.asarray(dry, x.dtype)
    wet_g = jnp.asarray(wet, x.dtype)
    if dry == 0.0:  # combined-IR callers (LTI fold): pure convolution —
        # don't emit the 0*x term (XLA can't DCE it under f32 semantics)
        if prescale is not None:
            return (jnp.asarray(prescale, x.dtype) * wet_g) * w
        return wet_g * w if wet != 1.0 else w
    if prescale is not None:
        s = jnp.asarray(prescale, x.dtype)
        return (s * dry_g) * x + (s * wet_g) * w
    return dry_g * x + wet_g * w


def reverb_block(x, ir, tail, wet: float = 0.3, dry: float = 0.7):
    """One block of streaming reverb with carried tail (overlap-add).

    ``x``: (..., n) block; ``tail``: (..., m-1) carry from the previous
    block. Returns (y, new_tail): y is wet/dry same-length output;
    new_tail feeds the next block. Blockwise output equals the offline
    :func:`reverb` exactly in exact arithmetic (tested to f32 tolerance).
    """
    n = x.shape[-1]
    m = ir.shape[-1]
    full = fir_convolve_full(x, ir)  # (..., n + m - 1)
    pad = [(0, 0)] * (x.ndim - 1)
    tail_pad = jnp.pad(tail, pad + [(0, n)])  # (..., n + m - 1)
    acc = full + tail_pad
    y = jnp.asarray(dry, x.dtype) * x + jnp.asarray(wet, x.dtype) * acc[..., :n]
    new_tail = acc[..., n:]
    return y, new_tail


def reverb_tail_init(batch_shape, ir_len: int, dtype=jnp.float32):
    return jnp.zeros(tuple(batch_shape) + (ir_len - 1,), dtype)


# ---------------------------------------------------------------------------
# IR synthesis (host) — the default when no IR file is given. The
# reference bundles fixed reverb presets; the rebuild's preset is an
# exponentially-decaying noise IR, the standard synthetic room model.
# ---------------------------------------------------------------------------


def synthetic_ir(
    seconds: float, sr: int, rt60: float | None = None, seed: int = 7
) -> np.ndarray:
    """Exp-decaying white-noise IR, unit direct path, -60 dB at rt60."""
    n = max(1, int(round(seconds * sr)))
    rt60 = rt60 if rt60 is not None else seconds
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    env = 10.0 ** (-3.0 * t / max(rt60, 1e-6))  # -60 dB at rt60
    ir = rng.standard_normal(n) * env
    ir[0] = 1.0
    # normalize wet energy so wet/dry ratios are IR-independent
    ir /= np.sqrt(np.sum(ir**2))
    return ir.astype(np.float64)


# ---------------------------------------------------------------------------
# Numpy oracle (float64): direct fftconvolve-based reference.
# ---------------------------------------------------------------------------


def reverb_np(x, ir, wet=0.3, dry=0.7):
    from scipy import signal as _sig

    x = np.asarray(x, np.float64)
    ir = np.asarray(ir, np.float64)
    w = _sig.fftconvolve(x, np.broadcast_to(ir, x.shape[:-1] + ir.shape), axes=-1)
    return dry * x + wet * w[..., : x.shape[-1]]
