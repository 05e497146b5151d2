"""Biquad EQ: RBJ coefficient design + IIR filtering as associative scans.

Reference analogue: the equalizer C loop (cascaded 2nd-order IIR
sections, RBJ-style peaking/shelf, ``src/effects/`` [upstream, SURVEY.md
§2.1]; 5-band per ``BASELINE.json:9``).

Design (SURVEY.md §7.3/§7.4 "IIR on a SIMD machine"):

* A biquad in transposed direct form II is a 2-state affine recurrence
  ``z[n] = A z[n-1] + g x[n]``, ``y[n] = b0 x[n] + z1[n-1]``. The scan
  over affine maps ``(M, v)`` with combine ``(M2 M1, M2 v1 + v2)`` is
  associative -> ``jax.lax.associative_scan`` gives log-depth parallel
  IIR as elementwise device code.
* The 2x2 combines are written as **scalar arithmetic, never matmul**:
  a reduced-precision matrix product (TF32 is the GPU's f32 default)
  can push near-unit-circle poles outside the unit circle -> NaN
  (SURVEY.md §7.4①).
* State runs in **float64** (f32 I/O): f32 scan arithmetic floors at
  -77 dB vs the f64 oracle, just missing the -80 dB target; f64 reaches
  -152 dB at negligible cost (measured, SURVEY.md §7.4②).

This module is the oracle-grade op and the only IIR engine; on the
card's engine an EQ next to a reverb folds into the reverb's FIR
instead (``graph.fx`` LTI fold).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# RBJ Audio-EQ-Cookbook coefficient design (host, float64).
# ---------------------------------------------------------------------------

_RBJ_KINDS = (
    "peaking",
    "lowshelf",
    "highshelf",
    "lowpass",
    "highpass",
    "bandpass",
    "notch",
)


def rbj_coeffs(
    kind: str, freq_hz: float, sr: int, q: float = 0.7071, gain_db: float = 0.0
) -> np.ndarray:
    """One RBJ biquad section -> sos row [b0, b1, b2, 1, a1, a2] (float64).

    Formulas follow the RBJ Audio EQ Cookbook exactly; ``gain_db`` is
    meaningful for peaking/shelf kinds only.
    """
    if kind not in _RBJ_KINDS:
        raise ValueError(f"unknown biquad kind {kind!r}; known: {_RBJ_KINDS}")
    if not (0.0 < freq_hz < sr / 2.0):
        raise ValueError(f"freq_hz must be in (0, sr/2), got {freq_hz} at sr={sr}")
    if not q > 0.0:
        # q <= 0 flips alpha's sign and pushes poles outside the unit
        # circle: a silently diverging filter (round-2 review find)
        raise ValueError(f"q must be > 0, got {q}")
    if not math.isfinite(gain_db):
        # a NaN/inf gain poisons every output sample downstream with no
        # error anywhere (fuzz find) — reject at design time
        raise ValueError(f"gain_db must be finite, got {gain_db}")
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * freq_hz / sr
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)

    if kind == "peaking":
        b = [1 + alpha * A, -2 * cw, 1 - alpha * A]
        a = [1 + alpha / A, -2 * cw, 1 - alpha / A]
    elif kind == "lowshelf":
        sq = 2.0 * math.sqrt(A) * alpha
        b = [
            A * ((A + 1) - (A - 1) * cw + sq),
            2 * A * ((A - 1) - (A + 1) * cw),
            A * ((A + 1) - (A - 1) * cw - sq),
        ]
        a = [
            (A + 1) + (A - 1) * cw + sq,
            -2 * ((A - 1) + (A + 1) * cw),
            (A + 1) + (A - 1) * cw - sq,
        ]
    elif kind == "highshelf":
        sq = 2.0 * math.sqrt(A) * alpha
        b = [
            A * ((A + 1) + (A - 1) * cw + sq),
            -2 * A * ((A - 1) + (A + 1) * cw),
            A * ((A + 1) + (A - 1) * cw - sq),
        ]
        a = [
            (A + 1) - (A - 1) * cw + sq,
            2 * ((A - 1) - (A + 1) * cw),
            (A + 1) - (A - 1) * cw - sq,
        ]
    elif kind == "lowpass":
        b = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "highpass":
        b = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "bandpass":  # constant 0 dB peak gain
        b = [alpha, 0.0, -alpha]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    else:  # notch
        b = [1.0, -2 * cw, 1.0]
        a = [1 + alpha, -2 * cw, 1 - alpha]

    a0 = a[0]
    return np.array(
        [b[0] / a0, b[1] / a0, b[2] / a0, 1.0, a[1] / a0, a[2] / a0], np.float64
    )


def eq_sos(bands, sr: int) -> np.ndarray:
    """Build an [S, 6] sos cascade from EQ band dicts.

    Each band: {"freq_hz": f, "gain_db": g, "q": q, "kind": "peaking"}
    (kind optional; the reference's 5-band EQ is all-peaking).
    """
    _KEYS = {"freq_hz", "gain_db", "q", "kind"}
    rows = []
    for b in bands:
        if not isinstance(b, dict) or "freq_hz" not in b:
            # a typo'd freq key leaked a bare KeyError; a typo'd gain
            # key silently built a 0 dB (no-op) band (review find)
            raise ValueError(
                f"EQ band needs 'freq_hz' (and optional gain_db/q/kind),"
                f" got {b!r}")
        unknown = set(b) - _KEYS
        if unknown:
            raise ValueError(
                f"EQ band has unknown key(s) {sorted(unknown)}: {b!r}")
        rows.append(rbj_coeffs(
            b.get("kind", "peaking"),
            float(b["freq_hz"]),
            sr,
            q=float(b.get("q", 0.7071)),
            gain_db=float(b.get("gain_db", 0.0)),
        ))
    return np.stack(rows) if rows else np.zeros((0, 6), np.float64)


# ---------------------------------------------------------------------------
# Device filtering: cascaded sections, each an associative scan.
# ---------------------------------------------------------------------------


def _affine_combine(lhs, rhs):
    """Compose affine maps z -> M z + v: rhs AFTER lhs. Scalar math only
    (never einsum/matmul — a reduced-precision product destabilizes IIR
    poles, SURVEY.md §7.4①)."""
    lm11, lm12, lm21, lm22, lv1, lv2 = lhs
    rm11, rm12, rm21, rm22, rv1, rv2 = rhs
    return (
        rm11 * lm11 + rm12 * lm21,
        rm11 * lm12 + rm12 * lm22,
        rm21 * lm11 + rm22 * lm21,
        rm21 * lm12 + rm22 * lm22,
        rm11 * lv1 + rm12 * lv2 + rv1,
        rm21 * lv1 + rm22 * lv2 + rv2,
    )


def section_cums(x, b0, b1, b2, a1, a2):
    """Cumulative affine maps of one section: z[n] = M[n] z[-1] + v[n].

    Returns (m11, m12, m21, m22, v1, v2), each shaped like ``x`` —
    the building block shared by :func:`_section_scan` and the
    sequence-parallel cross-shard state chain (xmtpu.parallel.sp).
    """
    g1 = b1 - a1 * b0
    g2 = b2 - a2 * b0
    shape = x.shape
    ones = jnp.ones(shape, x.dtype)
    elems = (
        (-a1) * ones,  # m11
        ones,  # m12
        (-a2) * ones,  # m21
        jnp.zeros(shape, x.dtype),  # m22
        g1 * x,  # v1
        g2 * x,  # v2
    )
    return jax.lax.associative_scan(_affine_combine, elems, axis=-1)


def _section_scan(x, b0, b1, b2, a1, a2, zi):
    """One biquad section over the last axis via associative scan.

    ``x``: (..., n) float64. ``zi``: (..., 2) float64 initial DF2T state.
    Returns (y, zf) with zf the final state (for streaming block carry,
    SURVEY.md §5 "IIR across blocks").
    """
    m11, m12, m21, m22, v1, v2 = section_cums(x, b0, b1, b2, a1, a2)
    zi1 = zi[..., 0:1]
    zi2 = zi[..., 1:2]
    z1 = m11 * zi1 + m12 * zi2 + v1
    z2 = m21 * zi1 + m22 * zi2 + v2
    # y[n] = b0 x[n] + z1[n-1], with z1[-1] = zi1
    z1_prev = jnp.concatenate([zi1, z1[..., :-1]], axis=-1)
    y = b0 * x + z1_prev
    zf = jnp.concatenate([z1[..., -1:], z2[..., -1:]], axis=-1)
    return y, zf


def sosfilt_scan(sos, x, zi=None, state_dtype=jnp.float64):
    """Cascaded-biquad filter over the last axis. Jittable.

    ``sos``: [S, 6] (scipy layout b0 b1 b2 a0 a1 a2, a0 == 1).
    ``x``: (..., n) any float dtype; compute runs in ``state_dtype``
    (float64 by default per SURVEY.md §7.4②), output cast back.
    ``zi``: [S, ..., 2] initial DF2T state or None for zeros.
    Returns (y, zf) with zf shaped like zi.
    """
    sos = jnp.asarray(sos, state_dtype)
    S = sos.shape[0]
    in_dtype = x.dtype
    y = x.astype(state_dtype)
    if zi is None:
        zi = jnp.zeros((S,) + x.shape[:-1] + (2,), state_dtype)
    else:
        zi = jnp.asarray(zi, state_dtype)
    if S == 0:  # empty cascade is the identity (zero-band EQ)
        return x, jnp.zeros((0,) + x.shape[:-1] + (2,), state_dtype)
    zfs = []
    for s in range(S):  # cascade is short (5 bands) — unrolled python loop
        y, zf = _section_scan(
            y, sos[s, 0], sos[s, 1], sos[s, 2], sos[s, 4], sos[s, 5], zi[s]
        )
        zfs.append(zf)
    return y.astype(in_dtype), jnp.stack(zfs)


# ---------------------------------------------------------------------------
# Numpy oracle (float64, sequential) — golden reference for scan tests.
# scipy.signal.sosfilt is the external cross-check; this mirrors its DF2T
# math exactly, including the state layout.
# ---------------------------------------------------------------------------


def sosfilt_np(sos: np.ndarray, x: np.ndarray, zi=None):
    """Sequential float64 DF2T cascade. Returns (y, zf)."""
    sos = np.asarray(sos, np.float64)
    x = np.asarray(x, np.float64)
    S = sos.shape[0]
    if zi is None:
        zi = np.zeros((S,) + x.shape[:-1] + (2,))
    z = np.array(zi, np.float64, copy=True)
    y = x.copy()
    for s in range(S):
        b0, b1, b2, _, a1, a2 = sos[s]
        z1 = z[s, ..., 0].copy()
        z2 = z[s, ..., 1].copy()
        out = np.empty_like(y)
        for n in range(y.shape[-1]):
            xn = y[..., n]
            yn = b0 * xn + z1
            z1_new = b1 * xn - a1 * yn + z2
            z2 = b2 * xn - a2 * yn
            z1 = z1_new
            out[..., n] = yn
        y = out
        z[s, ..., 0] = z1
        z[s, ..., 1] = z2
    return y, z


def sos_impulse_np(sos, tol: float = 1e-6, max_len: int = 1 << 21):
    """Truncated impulse response of the cascade (f64, host-side).

    The cascade is LTI, so at an l1-tail tolerance its action equals a
    finite FIR: worst-case truncation error of ``conv(x, h)`` vs the
    exact IIR is ``||x||_inf * sum(|h[cut:]|) <= tol * sum(|h|)`` —
    the default 1e-6 is a -120 dB budget, far under the chain's -80 dB
    gate. This is what lets the fx graph fold an EQ into an adjacent
    FIR reverb and run the whole LTI run as ONE FFT convolution
    (``graph.fx`` LTI fold; reference analogue: the separate EQ and
    reverb loops of the voice chain, SURVEY.md §2.1).

    Adaptive length: simulate, cut where the l1 tail mass drops below
    ``tol`` of the total, doubling the window until the cut converges.
    Returns None if the response has not decayed within ``max_len``
    samples (unstable or pathologically resonant design) — callers
    must then keep the exact IIR path.
    """
    from scipy import signal as sps

    sos = np.asarray(sos, np.float64)
    if sos.shape[0] == 0:
        return np.ones(1, np.float64)
    n = 4096
    while True:
        x = np.zeros(n, np.float64)
        x[0] = 1.0
        h = sps.sosfilt(sos, x)
        if not np.all(np.isfinite(h)):
            return None
        tail = np.cumsum(np.abs(h[::-1]))[::-1]  # tail[i] = sum_{t>=i} |h|
        total = tail[0]
        if total == 0.0:
            return h[:1]
        over = np.nonzero(tail > tol * total)[0]
        cut = int(over[-1]) + 1 if over.size else 1
        if cut < n:  # the discarded tail is genuinely below tolerance
            return np.ascontiguousarray(h[:cut])
        if n >= max_len:
            return None
        n *= 2
