"""Noise suppression: STFT Wiener gain (spectral subtraction family).

Reference analogue: the WebRTC-NS-style voice denoiser
(``src/effects/noise_suppression/`` [upstream, SURVEY.md §2.1] — marked
optional/stretch in SURVEY.md §7.5; this is the rebuild's take, NOT a
WebRTC port).

Pinned xmtpu semantics (mirrored by :func:`suppress_np`, the oracle):

1. STFT: sqrt-Hann window (analysis AND synthesis, so the windows'
   product is Hann and overlap-adds to exactly 1 at 50% hop), ``nfft``
   (default 512); frames zero-padded at the clip edges so output
   length == input and reconstruction is exact everywhere.
2. Noise PSD — two modes (``noise_update``):
   * ``"frozen"`` (default): median of the first ``noise_frames``
     frame PSDs, then fixed (or the caller passes ``noise_psd``).
   * ``"adaptive"`` (the reference's continuously-updated WebRTC-style
     estimator, SURVEY.md §2.1 NS row): seeded by the same lead-in
     median, then per frame and per bin a speech-presence gate — a bin
     whose instantaneous PSD is within ``presence_thresh`` (linear
     power ratio) of the current noise estimate is deemed
     noise-dominated and updates it through a one-pole,
     ``noise[t] = a_n noise[t-1] + (1-a_n) psd[t]`` (a_n =
     ``noise_smooth``); speech-dominated bins RISE by the slow
     multiplicative leak ``up_leak`` per frame (minimum-statistics-
     style escape: a step INCREASE in the noise floor looks like
     speech to the ratio gate and would otherwise freeze the estimate
     forever; the leak climbs it into the gate's capture range, and
     genuine speech pauses pull it back down through the fast branch).
     Tracks drifting noise floors on long recordings; offline and
     streaming run the IDENTICAL recursion (exact parity after the
     lead-in, tested).
3. Per-frame PSD smoothing: one-pole over frames,
   ``P[t] = a P[t-1] + (1-a) |X[t]|^2`` (a = ``smooth``).
4. Wiener gain with floor: ``snr = max(P/noise - 1, 0)``;
   ``G = max(snr / (1 + snr), floor)``.
5. iSTFT: overlap-add with the same Hann window (gain applied to the
   complex spectrum, phase untouched).

Everything is batched FFTs + elementwise math + one tiny scan over
frames — no hand-written kernel needed (the FFT is the hot op and XLA
owns it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_DEF_NFFT = 512
_DEF_FLOOR = 0.1


def _win(nfft: int, dtype=np.float64) -> np.ndarray:
    # sqrt of periodic Hann: w^2 (analysis*synthesis) COLA-sums to 1 at 50%
    h = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nfft) / nfft)
    return np.sqrt(h).astype(dtype)


def _frame_count(n: int, nfft: int) -> int:
    hop = nfft // 2
    return -(-n // hop) + 1  # cover the tail, plus one lead frame of pad


def stft(x: jnp.ndarray, nfft: int = _DEF_NFFT):
    """(..., n) -> complex frames (..., T, nfft//2+1); sqrt-Hann, 50%
    hop, half-window zero padding on both edges."""
    hop = nfft // 2
    n = x.shape[-1]
    T = _frame_count(n, nfft)
    pad = [(0, 0)] * (x.ndim - 1) + [(hop, (T - 1) * hop + nfft - (n + hop))]
    xp = jnp.pad(x, pad)
    frames = _gather_frames(xp, T, hop, nfft)
    w = jnp.asarray(_win(nfft), x.dtype)
    return jnp.fft.rfft(frames * w, axis=-1)


def _gather_frames(xp, T, hop, nfft):
    # static strided framing via reshape trick: frames overlap 50%, so
    # two interleaved non-overlapping framings cover all frames.
    batch = xp.shape[:-1]
    even = xp[..., : (T + 1) // 2 * nfft]
    even = even.reshape(*batch, (T + 1) // 2, nfft)
    odd = xp[..., hop : hop + (T // 2) * nfft]
    odd = odd.reshape(*batch, T // 2, nfft)
    frames = jnp.zeros(batch + (T, nfft), xp.dtype)
    frames = frames.at[..., 0::2, :].set(even)
    frames = frames.at[..., 1::2, :].set(odd)
    return frames


def istft(F: jnp.ndarray, n: int, nfft: int = _DEF_NFFT):
    """Inverse of :func:`stft` (sqrt-Hann synthesis, exact COLA)."""
    hop = nfft // 2
    frames = jnp.fft.irfft(F, n=nfft, axis=-1)
    w = jnp.asarray(_win(nfft), frames.dtype)
    frames = frames * w  # synthesis window; w^2 sums to 1 at 50% hop
    T = frames.shape[-2]
    batch = frames.shape[:-2]
    total = (T - 1) * hop + nfft
    out = jnp.zeros(batch + (total,), frames.dtype)
    # overlap-add the two interleaved framings
    even = frames[..., 0::2, :].reshape(*batch, -1)
    out = out.at[..., : even.shape[-1]].add(even)
    odd = frames[..., 1::2, :].reshape(*batch, -1)
    out = out.at[..., hop : hop + odd.shape[-1]].add(odd)
    return out[..., hop : hop + n]


def _onepole_frames(psd, a):
    """P[t] = a P[t-1] + (1-a) psd[t] over axis -2 (frames)."""
    def combine(l, r):
        lv, lp = l
        rv, rp = r
        return rp * lv + rv, lp * rp

    v, _ = jax.lax.associative_scan(
        combine, ((1 - a) * psd, jnp.full_like(psd, a)), axis=-2
    )
    return v


def _adaptive_noise_step(noise, psd_t, a_n: float, thresh: float,
                         up_leak: float):
    """One frame of the pinned adaptive noise recursion (shared —
    literally this function — by the offline scan, the streaming step
    and, in f64, the numpy oracle). See module docstring item 2."""
    ratio = psd_t / jnp.maximum(noise, 1e-20)
    upd = a_n * noise + (1.0 - a_n) * psd_t
    return jnp.where(ratio < thresh, upd, noise * up_leak)


def _adaptive_noise_track(psd, noise_frames: int, a_n: float, thresh: float,
                          up_leak: float):
    """Per-frame noise estimates (..., T, F) from the adaptive rule.

    Seeded by the lead-in median (the frozen-mode estimate); the
    recursion starts AT frame ``noise_frames`` — lead frames hold the
    seed — so a streaming session, which can only know the seed once
    its lead buffer fills, runs the identical state sequence from
    there (exact offline==streaming parity after the lead-in, tested).
    """
    seed = jnp.median(psd[..., :noise_frames, :], axis=-2)
    T = psd.shape[-2]

    def step(noise, xs):
        pt, t = xs
        new = _adaptive_noise_step(noise, pt, a_n, thresh, up_leak)
        noise = jnp.where(t >= noise_frames, new, noise)
        return noise, noise

    _, noise_t = jax.lax.scan(
        step, seed, (jnp.moveaxis(psd, -2, 0), jnp.arange(T)))
    return jnp.moveaxis(noise_t, 0, -2)


def suppress(
    x: jnp.ndarray,
    nfft: int = _DEF_NFFT,
    noise_frames: int = 8,
    smooth: float = 0.7,
    floor: float = _DEF_FLOOR,
    noise_psd: jnp.ndarray | None = None,
    noise_update: str = "frozen",
    noise_smooth: float = 0.95,
    presence_thresh: float = 4.0,
    up_leak: float = 1.02,
):
    """Suppress stationary noise in (..., n) float PCM. Jittable.

    ``noise_update="adaptive"`` tracks a drifting noise floor (module
    docstring item 2) — the reference's continuously-updated estimator.
    """
    in_dtype = x.dtype
    was_i16 = in_dtype == jnp.int16
    if was_i16:
        # pinned PCM16 conversion, not raw astype: the bare cast skipped
        # the /32768 scaling in and truncated toward zero out (wrapping
        # past full scale after iSTFT ringing) — the same class as the
        # measure_lufs int16 fix (review find)
        from xmtpu.ops.convert import pcm16_to_f32

        x = pcm16_to_f32(x)
    if noise_update not in ("frozen", "adaptive"):
        raise ValueError(
            f"noise_update must be 'frozen' or 'adaptive', got "
            f"{noise_update!r}")
    if noise_psd is not None and noise_update == "adaptive":
        # an explicit PSD pins the estimate — combining it with the
        # adaptive tracker would silently ignore one of the two
        # (stream_suppress raises on the same input)
        raise ValueError("noise_psd pins the estimate; it cannot be "
                         "combined with noise_update='adaptive'")
    X = stft(x.astype(jnp.float32), nfft)
    psd = jnp.square(jnp.abs(X))
    P = _onepole_frames(psd, jnp.float32(smooth))
    if noise_psd is not None:
        noise = jnp.asarray(noise_psd, jnp.float32)[..., None, :]
    elif noise_update == "adaptive":
        noise = _adaptive_noise_track(psd, noise_frames,
                                      float(noise_smooth),
                                      float(presence_thresh),
                                      float(up_leak))
    else:  # "frozen" (the only value left after the check above)
        noise = jnp.median(psd[..., :noise_frames, :], axis=-2, keepdims=True)
    snr = jnp.maximum(P / jnp.maximum(noise, 1e-20) - 1.0, 0.0)
    G = jnp.maximum(snr / (1.0 + snr), jnp.float32(floor))
    y = istft(X * G, x.shape[-1], nfft)
    if was_i16:
        from xmtpu.ops.convert import f32_to_pcm16

        return f32_to_pcm16(y)
    return y.astype(in_dtype)


# ---------------------------------------------------------------------------
# Streaming (causal) suppression with carried state.
# ---------------------------------------------------------------------------


def stream_init(batch_shape, nfft: int = _DEF_NFFT, noise_frames: int = 8):
    """Initial streaming-NS state pytree.

    ``batch_shape``: the block's leading dims — an int ``nch`` (the
    single-session (ch, n) case) or a full tuple, e.g. ``(B, ch)`` for
    batched streaming. State arrays carry the same leading dims.

    Fields: input carry (last nfft-hop samples), output OLA tail,
    lead-in PSD buffer (median -> frozen noise estimate, same pinned
    rule as offline), PSD smoother state, PER-ITEM frame counters
    (shaped ``batch_shape`` — so resetting one item's state slices,
    counter included, re-runs that item's noise lead-in while the rest
    of the batch keeps its estimates; a scalar shared counter could
    never restore a late (re)joined item's lead-in once it had passed
    ``noise_frames``).
    """
    bs = ((int(batch_shape),) if isinstance(batch_shape, (int, np.integer))
          else tuple(int(b) for b in batch_shape))
    hop = nfft // 2
    F = nfft // 2 + 1
    return {
        "carry": jnp.zeros(bs + (nfft - hop,), jnp.float32),
        "ola": jnp.zeros(bs + (nfft - hop,), jnp.float32),
        "lead": jnp.zeros((noise_frames,) + bs + (F,), jnp.float32),
        "psd_s": jnp.zeros(bs + (F,), jnp.float32),
        "noise": jnp.zeros(bs + (F,), jnp.float32),  # running estimate
        "count": jnp.zeros(bs, jnp.int32),
    }


def stream_suppress(x, state, nfft: int = _DEF_NFFT, noise_frames: int = 8,
                    smooth: float = 0.7, floor: float = _DEF_FLOOR,
                    noise_update: str = "frozen", noise_smooth: float = 0.95,
                    presence_thresh: float = 4.0, up_leak: float = 1.02):
    """Causal streaming twin of :func:`suppress` for (..., n) blocks.

    Any leading batch dims — (ch, n) for a single session, (B, ch, n)
    for batched streaming — with matching state from
    :func:`stream_init`. A block call feeds every item the same number
    of frames (the SessionPool/batched-session model), but the lead-in
    frame counters are PER ITEM: resetting one item's state slices
    (counter included) re-runs that item's noise lead-in, so a late
    (re)joined item builds a fresh estimate instead of silently
    no-op'ing on a zero one. Legacy scalar-counter states (pre round
    5) are accepted and broadcast.

    Semantics (pinned): output is DELAYED by nfft-hop samples (the OLA
    synthesis latency); frames seen during the ``noise_frames`` lead-in
    pass through at unity gain while their PSDs build the median noise
    estimate — identical to the offline estimate, so after the lead-in
    the streaming gains equal the offline gains exactly (tested).
    ``noise_update="adaptive"`` then keeps updating the estimate with
    the same per-frame recursion the offline path runs (module
    docstring item 2; exact parity preserved). ``n`` must be a multiple
    of hop (= nfft/2).

    Returns (y (..., n), new_state).
    """
    if noise_update not in ("frozen", "adaptive"):
        raise ValueError(
            f"noise_update must be 'frozen' or 'adaptive', got "
            f"{noise_update!r}")
    if state["lead"].shape[0] != noise_frames:
        # a mismatched noise_frames used to be silently absorbed by
        # JAX index clamping — frames past the smaller lead buffer
        # overwrote its last row and the "median of noise_frames"
        # was computed over the wrong window (review find)
        raise ValueError(
            f"noise_frames={noise_frames} does not match the state's "
            f"lead buffer ({state['lead'].shape[0]} frames from "
            "stream_init); pass the same value to both")
    hop = nfft // 2
    n = x.shape[-1]
    if n % hop:
        raise ValueError(f"stream_suppress needs n % {hop} == 0, got {n}")
    bs = x.shape[:-1]
    if state["carry"].shape[:-1] != bs:
        raise ValueError(
            f"state batch shape {state['carry'].shape[:-1]} does not "
            f"match input batch shape {bs}; stream_init(batch_shape) "
            "must be built for the same leading dims")
    if jnp.ndim(state["count"]) == 0 and bs:
        # legacy (pre round 5) saved states carried one shared scalar
        # counter; broadcast it to per-item counters
        state = dict(state)
        state["count"] = jnp.broadcast_to(
            jnp.asarray(state["count"], jnp.int32), bs)
    w = jnp.asarray(_win(nfft), jnp.float32)
    k = n // hop
    was_i16 = x.dtype == jnp.int16
    if was_i16:  # pinned conversion, like suppress() (review find)
        from xmtpu.ops.convert import pcm16_to_f32

        xf = pcm16_to_f32(x)
    else:
        xf = x.astype(jnp.float32)
    buf = jnp.concatenate([state["carry"], xf], axis=-1)
    frames = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(buf, j * hop, nfft, axis=-1)
         for j in range(k)], axis=0
    )  # (k, ..., nfft)

    def step(st, frame):
        X = jnp.fft.rfft(frame * w, axis=-1)
        psd = jnp.square(jnp.abs(X))
        psd_s = smooth * st["psd_s"] + (1.0 - smooth) * psd
        cnt = st["count"]  # (bs,) int32 — per-item lead-in counters
        in_lead = cnt < noise_frames  # (bs,) bool
        # per-item lead-buffer update via a one-hot frame mask over the
        # noise_frames axis (O(noise_frames) cheap work). A scalar
        # dynamic_update forced every item onto ONE shared counter —
        # the round-4 late-join hole: a per-item state reset could
        # never re-run the joiner's lead-in once the shared counter
        # had passed noise_frames.
        idx = jnp.minimum(cnt, noise_frames - 1)
        iota = jax.lax.broadcasted_iota(
            jnp.int32, (noise_frames,) + cnt.shape, 0)
        sel = (iota == idx[None]) & in_lead[None]
        lead = jnp.where(sel[..., None], psd[None], st["lead"])
        if noise_update == "adaptive":
            # during the lead-in the running estimate tracks the
            # partial-lead median (== the offline seed once full); past
            # it, the SAME recursion the offline scan runs — so the two
            # state sequences are identical from frame noise_frames on
            noise = jnp.where(
                in_lead[..., None],
                jnp.median(lead, axis=0),
                _adaptive_noise_step(st["noise"], psd,
                                     float(noise_smooth),
                                     float(presence_thresh),
                                     float(up_leak)),
            )
        else:
            noise = jnp.median(lead, axis=0)  # frozen once lead stops
        snr = jnp.maximum(psd_s / jnp.maximum(noise, 1e-20) - 1.0, 0.0)
        G = jnp.maximum(snr / (1.0 + snr), jnp.float32(floor))
        G = jnp.where(in_lead[..., None], 1.0, G)  # unity during lead-in
        yf = jnp.fft.irfft(X * G, n=nfft, axis=-1) * w
        # at 50% hop, ola is exactly hop wide
        out = yf[..., :hop] + st["ola"]
        new = dict(st)
        new["psd_s"] = psd_s
        new["lead"] = lead
        new["noise"] = noise
        new["count"] = cnt + 1
        new["ola"] = yf[..., hop:]
        return new, out

    st = {k2: v for k2, v in state.items() if k2 != "carry"}
    st, outs = jax.lax.scan(step, st, frames)
    y = jnp.moveaxis(outs, 0, -2).reshape(bs + (k * hop,))
    new_state = dict(st)
    new_state["carry"] = buf[..., -(nfft - hop):]
    if was_i16:
        from xmtpu.ops.convert import f32_to_pcm16

        return f32_to_pcm16(y), new_state
    return y.astype(x.dtype), new_state


# ---------------------------------------------------------------------------
# Numpy oracle (float64) — mirrors the pinned math exactly.
# ---------------------------------------------------------------------------


def suppress_np(x, nfft=_DEF_NFFT, noise_frames=8, smooth=0.7,
                floor=_DEF_FLOOR, noise_psd=None, noise_update="frozen",
                noise_smooth=0.95, presence_thresh=4.0, up_leak=1.02):
    x = np.asarray(x, np.float64)
    hop = nfft // 2
    n = x.shape[-1]
    T = _frame_count(n, nfft)
    pad = [(0, 0)] * (x.ndim - 1) + [(hop, (T - 1) * hop + nfft - (n + hop))]
    xp = np.pad(x, pad)
    w = _win(nfft)
    frames = np.stack([xp[..., t * hop : t * hop + nfft] for t in range(T)],
                      axis=-2)
    X = np.fft.rfft(frames * w, axis=-1)
    psd = np.abs(X) ** 2
    P = np.empty_like(psd)
    acc = np.zeros_like(psd[..., 0, :])
    for t in range(T):
        acc = smooth * acc + (1 - smooth) * psd[..., t, :]
        P[..., t, :] = acc
    if noise_psd is not None:
        noise = np.asarray(noise_psd)[..., None, :]
    elif noise_update == "adaptive":
        nz = np.median(psd[..., :noise_frames, :], axis=-2)
        noise = np.empty_like(psd)
        for t in range(T):
            if t >= noise_frames:  # pinned: recursion starts post-lead
                pt = psd[..., t, :]
                ratio = pt / np.maximum(nz, 1e-20)
                upd = noise_smooth * nz + (1 - noise_smooth) * pt
                nz = np.where(ratio < presence_thresh, upd, nz * up_leak)
            noise[..., t, :] = nz
    else:
        noise = np.median(psd[..., :noise_frames, :], axis=-2, keepdims=True)
    snr = np.maximum(P / np.maximum(noise, 1e-20) - 1.0, 0.0)
    G = np.maximum(snr / (1.0 + snr), floor)
    yf = np.fft.irfft(X * G, n=nfft, axis=-1) * w
    total = (T - 1) * hop + nfft
    out = np.zeros(x.shape[:-1] + (total,))
    for t in range(T):
        out[..., t * hop : t * hop + nfft] += yf[..., t, :]
    return out[..., hop : hop + n]
