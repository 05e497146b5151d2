"""Polyphase-FIR sample-rate conversion (e.g. 44.1 kHz -> 16 kHz).

Reference analogue: the resampler C loop under ``lib-audio-utils/src/
effects/`` [upstream, SURVEY.md §2.1] — a windowed-sinc polyphase FIR per
``BASELINE.json:5,7``.

Accelerator design (not a translation of the C inner loop):

* **Filter design** happens once on the host (scipy Kaiser window),
  cached; only the polyphase tap table ships to the device.
* **Pinned semantics** (SURVEY.md §7.3 "Rate-conversion length
  semantics"): the filter is odd-length symmetric, so its group delay is
  an integer number of upsampled samples; output sample ``j`` is the
  upsampled-domain convolution evaluated at ``t = j*M + (ntaps-1)//2``,
  and ``out_len = ceil(n * L / M)``. These match
  ``scipy.signal.resample_poly`` for odd-length filters.
* **Phase-grouped dense compute**: output index ``j = c*L + r``
  decomposes so that phase and window offset depend only on ``r`` —
  the whole resample becomes ``einsum('...clk,lk->...cl')`` over a
  frame tensor built from static slices + reshapes. No gathers, no
  dynamic shapes; every matrix product runs at ``precision=HIGHEST``
  because the GPU's default f32 product is TF32 (about 10 mantissa
  bits), which spends the whole -80 dB accuracy budget.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as _sig


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=64)
def design_polyphase_filter(
    L: int, M: int, taps_per_phase: int = 24, beta: float = 9.0
) -> np.ndarray:
    """Design the odd-length Kaiser-window lowpass for L/M resampling.

    Cutoff is min(pi/L, pi/M) in the L-upsampled domain; gain is L to
    compensate the energy lost to zero-insertion. Returned as float64,
    length ``taps_per_phase * L (+1 to make it odd)``.
    """
    nt = taps_per_phase * L
    if nt % 2 == 0:
        nt += 1
    cutoff = 1.0 / max(L, M)  # fraction of the upsampled Nyquist
    h = _sig.firwin(nt, cutoff, window=("kaiser", beta))
    return (L * h).astype(np.float64)


@dataclass(frozen=True)
class ResamplePlan:
    """Static plan for one (L, M, filter) combination.

    All tables are computed with host numpy at build time and enter the
    jitted computation as constants — nothing here is traced.
    """

    L: int
    M: int
    taps: np.ndarray  # full filter, float64, odd length
    K2: int  # taps per phase (padded)
    base: int  # min window start (folded into the left pad)
    width: int  # frame width needed to cover all phases
    col_start: np.ndarray  # [L] window start inside a frame, per residue
    hsel: np.ndarray  # [L, K2] reversed taps for residue r's phase
    hbank: np.ndarray  # [width, L] dense filter bank (hsel placed at col_start)
    pad_left: int

    @property
    def ntaps(self) -> int:
        return len(self.taps)


@lru_cache(maxsize=64)
def _make_plan(L: int, M: int, taps_per_phase: int, beta: float) -> ResamplePlan:
    h = design_polyphase_filter(L, M, taps_per_phase, beta)
    nt = len(h)
    offset = (nt - 1) // 2  # integer group delay in upsampled samples
    K2 = _cdiv(nt, L)
    hpad = np.zeros(K2 * L, np.float64)
    hpad[:nt] = h
    # polyphase decomposition: hpoly[p, q] = h[p + q*L]
    hpoly = hpad.reshape(K2, L).T  # [L, K2]

    # For output j = c*L + r: t = j*M + offset; phase p(r) = t mod L and
    # window base B(r) = (t - p)/L - c*M depend only on r.
    r = np.arange(L)
    t0 = r * M + offset
    p = t0 % L
    B = (t0 - p) // L
    # window for (c, r) = x[c*M + B[r] - q], q=0..K2-1  (ascending slice of
    # K2 samples ending at c*M + B[r]); taps therefore enter reversed.
    pad_left = K2  # guarantees start indices are >= 0 after padding
    S = B - K2 + 1 + pad_left
    base = int(S.min())
    width = int(S.max()) - base + K2
    hsel = hpoly[p][:, ::-1]  # [L, K2] reversed taps for residue r
    col_start = (S - base).astype(np.int64)
    # Dense filter bank: hbank[u, r] = hsel[r, u - col_start[r]] (0 outside).
    # Turns the whole resample into ONE matmul F[nj, width] @ hbank (the
    # ~(1 - K2/width) zero-FLOP overhead is cheap next to the matmul's
    # bandwidth win over gathered windows).
    hbank = np.zeros((width, L), np.float64)
    for r in range(L):
        hbank[col_start[r] : col_start[r] + K2, r] = hsel[r]
    return ResamplePlan(
        L=L,
        M=M,
        taps=h,
        K2=K2,
        base=base,
        width=width,
        col_start=col_start,
        hsel=np.ascontiguousarray(hsel, dtype=np.float64),
        hbank=hbank,
        pad_left=pad_left,
    )


make_plan = _make_plan  # public alias (streaming resampler uses plans directly)


def resample_output_len(n: int, L: int, M: int) -> int:
    """Pinned output-length rule: ceil(n * L / M) (matches resample_poly)."""
    return _cdiv(n * L, M)


def check_rates(sr_in: int, sr_out: int) -> None:
    """Typed sanity gate for a polyphase rate pair — THE one copy of
    the rule the CLI ``--rate`` flags and the batch runner's per-clip
    header check both apply (they used to carry diverging copies: the
    runner bounded only the clip side of the ratio, so a huge bus rate
    sailed through into a thousands-of-phase filter-bank compile;
    review find). Both rates must lie in [4000, 192000] and neither
    side of the reduced ratio may exceed 2048 phases. Raises
    :class:`ConfigError` (message keeps the 'unreasonable' wording
    callers match on)."""
    from xmtpu.utils.errors import ConfigError

    for r, nm in ((sr_in, "input rate"), (sr_out, "output rate")):
        if not (4000 <= int(r) <= 192000):
            raise ConfigError(
                f"unreasonable {nm} {r}: must be in [4000, 192000]")
    g = math.gcd(int(sr_in), int(sr_out))
    if sr_in // g > 2048 or sr_out // g > 2048:
        raise ConfigError(
            f"unreasonable polyphase ratio {sr_out // g}/{sr_in // g} "
            f"for {sr_in} -> {sr_out} Hz")


def polyphase_resample(
    x: jnp.ndarray,
    sr_in: int,
    sr_out: int,
    taps_per_phase: int = 24,
    beta: float = 9.0,
    dtype=jnp.float32,
    method: str = "banded",
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Resample the last axis of ``x`` from sr_in to sr_out. Jittable.

    ``x``: float array shaped (..., n). Returns (..., ceil(n*L/M)).
    ``method``: "banded" (two dense matmuls — fastest, see _apply_plan),
    "conv" (stride-M conv_general_dilated) or "window" (explicit frame
    matmul). ``precision``: matrix-product precision (HIGHEST default;
    on the GPU, HIGH and DEFAULT are TF32).
    """
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    if L == M:
        return x.astype(dtype)
    plan = _make_plan(L, M, taps_per_phase, beta)
    return _apply_plan(x, plan, dtype, method=method, precision=precision)


def plan_rows(plan: ResamplePlan, nj: int) -> int:
    """Input rows (of M samples) needed to emit nj output blocks."""
    nslab = _cdiv(plan.width, plan.M) + 1
    return nj + nslab


def resample_window(xs: jnp.ndarray, plan: ResamplePlan, nj: int, dtype=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST):
    """Core matmul compute: contiguous input window -> nj*L output samples.

    ``xs``: (..., plan_rows(plan, nj) * M) where ``xs[k]`` is input sample
    ``x[k + c0*M + base - pad_left]`` for first output block c0 (zeros
    where that index is out of range). Shared by the offline path
    (c0 = 0) and the streaming path (c0 = block clock) so the two are
    bit-identical per block (SURVEY.md §3.2 streaming==offline invariant).

    Frames F[..., c, u] = xs[..., c*M + u] for u in [0, width); the
    window for output (c, r) is F[..., c, col_start[r]:col_start[r]+K2].
    """
    L, M = plan.L, plan.M
    batch = xs.shape[:-1]
    rows = plan_rows(plan, nj)
    nslab = rows - nj
    A = xs.astype(dtype).reshape(*batch, rows, M)
    F = jnp.concatenate([A[..., i : i + nj, :] for i in range(nslab)], axis=-1)
    F = F[..., : plan.width]
    # one matmul: [..., nj, width] @ [width, L] -> [..., nj, L]
    hbank = jnp.asarray(plan.hbank, dtype=dtype)
    out2d = jnp.matmul(F, hbank, precision=precision)
    return out2d.reshape(*batch, nj * L)


@dataclass(frozen=True)
class AlignedTables:
    """Filter tables for the frame-ALIGNED banded formulation (n % M
    == 0): output frame c = A[c] @ H1 plus two narrow edge corrections
    against neighbor frames — A[c-1]'s last |lo| samples patch output
    phases [0, r0) via H0, A[c+1]'s first hi samples patch phases
    [r2, L) via H2."""

    H1: np.ndarray  # (M, L) f64
    H0: np.ndarray  # (-lo, r0) f64 (empty-dim if lo == 0)
    H2: np.ndarray  # (hi, L - r2) f64 (empty-dim if hi == 0)
    lo: int
    hi: int
    r0: int
    r2: int


def aligned_tables(plan: ResamplePlan) -> AlignedTables:
    key = (plan.L, plan.M, plan.K2, plan.taps.tobytes())
    hit = _ALIGNED_CACHE.get(key)
    if hit is not None:
        return hit
    delta = plan.base - plan.pad_left
    s = delta + plan.col_start  # [L] window start relative to c*M
    K2 = plan.K2
    M = plan.M
    lo = int(s.min())  # < 0: first |lo| taps live in row c-1
    hi = int(s.max()) + K2 - M  # > 0: last hi taps live in row c+1
    Hfull = np.zeros((M + max(hi, 0) - min(lo, 0), plan.L), np.float64)
    for r in range(plan.L):
        Hfull[int(s[r]) - min(lo, 0): int(s[r]) - min(lo, 0) + K2, r] \
            = plan.hsel[r]
    off = -min(lo, 0)
    r0 = int(np.sum(s < 0))  # s monotone: phases [0, r0)
    r2 = int(np.argmax(s + K2 > M)) if np.any(s + K2 > M) else plan.L
    t = AlignedTables(H1=Hfull[off: off + M], H0=Hfull[:off, :r0],
                      H2=Hfull[off + M:, r2:], lo=lo, hi=hi, r0=r0, r2=r2)
    _ALIGNED_CACHE[key] = t
    return t


_ALIGNED_CACHE: dict = {}


def _apply_aligned(A: jnp.ndarray, plan: ResamplePlan, dtype,
                   precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Aligned banded resample on a PRE-FRAMED input ``A`` shaped
    (..., nc, M) (frame c = input samples [c*M, (c+1)*M)). Returns
    (..., nc, L) output frames.

    Exposed (via :func:`polyphase_resample_framed`) so producers can
    write the frame tensor DIRECTLY: when the (.., n) -> (.., nc, M)
    reshape happens after an elementwise producer, XLA's layout
    assignment materializes it as a full copy between the producer's
    row-major output and the matmul's frame-minor operand layout (the
    'free reshape' is only free if the producer fuses into it). Framing the
    int16 INPUTS first (a true bitcast) lets the convert+mix fusion
    write the matmul's layout directly — one pass over the bytes.
    """
    t = aligned_tables(plan)
    _HI = jax.lax.Precision.HIGHEST if precision is None else precision
    A = A.astype(dtype)
    Mp = A.shape[-1]  # >= plan.M: lanes beyond M are pad (any value —
    # the padded H1 rows below are zero, and the correction dots slice
    # only real lanes, so pad contents never reach the output)
    H1 = t.H1
    if Mp > plan.M:
        H1 = np.concatenate(
            [H1, np.zeros((Mp - plan.M, H1.shape[1]), H1.dtype)])
    out = jnp.matmul(A, jnp.asarray(H1, dtype), precision=_HI)
    if t.lo < 0:
        C0 = jnp.matmul(A[..., plan.M + t.lo: plan.M],
                        jnp.asarray(t.H0, dtype), precision=_HI)
        out = out.at[..., 1:, : t.r0].add(C0[..., :-1, :])
    if t.hi > 0:
        C2 = jnp.matmul(A[..., : t.hi], jnp.asarray(t.H2, dtype),
                        precision=_HI)
        out = out.at[..., :-1, t.r2:].add(C2[..., 1:, :])
    return out


def aligned_supported(n: int, sr_in: int, sr_out: int,
                      taps_per_phase: int = 24, beta: float = 9.0) -> bool:
    """True if the zero-copy aligned banded path applies to length n."""
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    if L == M or n % M or n < 2 * M:
        return False
    plan = _make_plan(L, M, taps_per_phase, beta)
    out_len = resample_output_len(n, L, M)
    return plan.width <= 2 * M and _cdiv(out_len, L) * L == out_len


def polyphase_resample_framed(
    A: jnp.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24,
    beta: float = 9.0, dtype=jnp.float32,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Aligned banded resample of pre-framed input (..., nc, M) ->
    (..., nc, L) frames (see :func:`_apply_aligned`; gate applicability
    with :func:`aligned_supported` on n = nc*M first). Jittable.

    The last axis may exceed M (padding); lanes beyond M are ignored
    (zero filter rows)."""
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    if A.shape[-1] < M:
        raise ValueError(f"framed input last axis {A.shape[-1]} < M={M}")
    plan = _make_plan(L, M, taps_per_phase, beta)
    if plan.width > 2 * M:
        # aligned_supported() geometry: the filter band must fit within
        # one frame plus its neighbours, else the correction dots are
        # shape-inconsistent and fail with an opaque dot_general error
        # deep in _apply_aligned (review find) — name the real cause
        raise ValueError(
            f"rate pair {sr_in}->{sr_out} (L={L}, M={M}, filter width "
            f"{plan.width} > 2*M) is outside the aligned banded "
            "formulation; use polyphase_resample() instead")
    return _apply_aligned(A, plan, dtype, precision)


def _apply_plan(x: jnp.ndarray, plan: ResamplePlan, dtype,
                method: str = "banded",
                precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    L, M = plan.L, plan.M
    n = x.shape[-1]
    out_len = resample_output_len(n, L, M)
    nj = _cdiv(out_len, L)  # number of L-sample output blocks

    x = x.astype(dtype)
    batch = x.shape[:-1]

    def _windowed():
        # window xs[k] = x[k + base - pad_left], zeros outside [0, n) —
        # built lazily: the aligned fast path below reads x directly,
        # and eager (non-jit) callers must not pay this pad+slice copy
        # of the whole input (jit would DCE it; eager would not)
        need = plan_rows(plan, nj) * M
        pad_r = max(0, plan.base + need - (n + plan.pad_left))
        xpad = jnp.pad(x, [(0, 0)] * len(batch) + [(plan.pad_left, pad_r)])
        return jax.lax.slice_in_dim(xpad, plan.base, plan.base + need,
                                    axis=-1)

    if method == "banded" and plan.width > 2 * M:
        method = "conv"  # tiny M (upsampling): band spans many rows
    if method == "banded" and n % M == 0 and n >= 2 * M and nj * L == out_len:
        # Zero-copy aligned fast path: the pad/slice prep of the
        # windowed paths copies the whole input; when n divides by M the frame
        # matrix A[c] = x[c*M:(c+1)*M] is a FREE reshape. Windows still
        # reach a few samples into rows c-1 / c+1 (the filter's group-
        # delay offset delta and the band tail), but only for the first
        # r0 / last L-r2 output phases -- two small side matmuls against
        # narrow lane slices patch exactly those output columns.
        bshape = x.shape[:-1]
        A = x.reshape(*bshape, n // M, M)
        out = _apply_aligned(A, plan, dtype, precision)
        return out.reshape(*bshape, nj * L)
    if method == "banded":
        # The filter band spans u in [0, width) with width < 2M, so
        # F[c, :] = [A[c] | A[c+1, :width-M]] and the whole resample is
        # TWO plain dense matmuls on (near) zero-copy reshapes of xs —
        # no frame concat (the 'window' path's 3x traffic), no strided
        # conv. The zero-flop overhead of the banded-but-dense filter
        # table is cheap next to the traffic, ~1x input + 1x output.
        assert plan.width <= 2 * M, (plan.width, M)
        bshape = x.shape[:-1]
        xs = _windowed()
        A = xs[..., : nj * M].reshape(*bshape, nj, M)
        out = jnp.matmul(A, jnp.asarray(plan.hbank[:M], dtype),
                         precision=precision)
        if plan.width > M:
            k2 = plan.width - M
            A1 = xs[..., M : (nj + 1) * M].reshape(*bshape, nj, M)[..., :k2]
            out = out + jnp.matmul(A1, jnp.asarray(plan.hbank[M:], dtype),
                                   precision=precision)
        return out.reshape(*bshape, nj * L)[..., :out_len]
    xs = _windowed()
    if method == "conv":
        # out[.., c, r] = sum_u xs[.., c*M + u] * hbank[u, r]: a stride-M
        # conv with L output channels — the conv never materializes the
        # frame tensor (the matmul path writes ~3.5x the input bytes)
        R = int(np.prod(batch)) if batch else 1
        lhs = xs.reshape(R, -1, 1)  # NWC
        rhs = jnp.asarray(plan.hbank, dtype)[:, None, :]  # WIO (width,1,L)
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(M,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"),
            precision=precision,
        )  # (R, nj', L) with nj' >= nj
        out = out[:, :nj, :].reshape(*batch, nj * L)
        return out[..., :out_len]
    return resample_window(xs, plan, nj, dtype,
                           precision=precision)[..., :out_len]


# ---------------------------------------------------------------------------
# Host oracle (float64, scipy) — the golden reference for all resample tests.
# ---------------------------------------------------------------------------


def resample_oracle_np(
    x: np.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24, beta: float = 9.0
) -> np.ndarray:
    """Float64 host implementation of the EXACT pinned semantics.

    Uses scipy.signal.upfirdn; the group-delay offset is folded into the
    filter by pre-padding zeros so the M-strided output lands on
    ``t = j*M + offset`` (SURVEY.md §7.3 delay-semantics rule).
    """
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    if L == M:
        return x.astype(np.float64)
    h = design_polyphase_filter(L, M, taps_per_phase, beta)
    nt = len(h)
    offset = (nt - 1) // 2
    out_len = resample_output_len(x.shape[-1], L, M)
    s = (-offset) % M
    d = (offset + s) // M
    h2 = np.concatenate([np.zeros(s), h])
    z = _sig.upfirdn(h2, x.astype(np.float64), up=L, down=M, axis=-1)
    y = z[..., d : d + out_len]
    if y.shape[-1] < out_len:  # upfirdn's conv can end before our last sample
        padw = [(0, 0)] * (y.ndim - 1) + [(0, out_len - y.shape[-1])]
        y = np.pad(y, padw)
    return y
