"""Batched offline pipeline (layer N6; BASELINE.json:10 config 4).

Reference analogue: processing many clips by invoking the C library once
per clip [upstream has no batch mode — SURVEY.md §2.2]. The accelerator
replacement is a **batch axis**: a [B, n] clip tensor runs the whole
decode-side chain (resample -> mix -> EQ -> reverb -> limiter -> i16)
as ONE jitted computation; clips shard over chips via a ``("dp",)``
mesh (``jax.sharding.NamedSharding``), the data-parallel strategy of
SURVEY.md §2.2.

``flagship_step`` is the framework's headline computation: it is what
``bench.py`` times and what ``__graft_entry__`` compile-checks.
"""

from __future__ import annotations


import math as _math

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu import engine as _engine
from xmtpu.ops import biquad as _biquad
from xmtpu.ops import convert as _convert
from xmtpu.ops import limiter as _limiter
from xmtpu.ops import mix as _mix
from xmtpu.ops import resample as _resample
from xmtpu.ops import reverb as _reverb

DEFAULT_BANDS = (
    {"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
    {"freq_hz": 400.0, "gain_db": -3.0, "q": 1.2},
    {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
    {"freq_hz": 4000.0, "gain_db": -2.0, "q": 1.1},
    {"freq_hz": 7000.0, "gain_db": 3.0, "q": 0.8},
)


# Limiter detector time constants shared by every batch path and the
# oracle — one source of truth so the paths stay the same filter (they
# are compared to -80 dB in tests).
LIM_RELEASE_MS = 100.0
LIM_ATTACK_MS = 1.0


def _combined_ir(sos, ir, wet: float, dry: float):
    """Host-precomputed combined impulse response of EQ -> reverb.

    LTI fold: the EQ cascade is LTI, so on the card's engine it folds
    into the reverb convolution — ``dry*h_eq + wet*(h_eq (*) ir)`` with
    ``h_eq`` truncated at a -120 dB l1 tail (``ops.biquad.
    sos_impulse_np``). The FFT convolution then does the EQ for free
    and no EQ recurrence runs at all. Same math as
    ``graph.fx.FusedLTIFx``; parity gated in tests/test_batch.py.
    Returns None (caller runs the EQ scan) if the cascade's response
    will not truncate."""
    h_eq = _biquad.sos_impulse_np(sos)
    if h_eq is None:
        return None
    c = wet * np.convolve(h_eq, np.asarray(ir, np.float64))
    c[: len(h_eq)] += dry * h_eq
    # re-trim (shared helper, see ops.reverb.trim_ir_tail): the
    # composition can decay sooner than len(h_eq)+len(ir)-1, and the
    # dead tail can push the overlap-save block past a power of two
    return _reverb.trim_ir_tail(c).astype(np.float32)


def flagship_oracle_np(voice_i16, bgm_i16, sr_in: int = 44100,
                       sr_bus: int = 16000, bands=DEFAULT_BANDS,
                       ir_seconds: float = 0.25, wet: float = 0.25,
                       dry: float = 0.75, bgm_gain: float = 0.4,
                       fade_ms: float = 250.0,
                       threshold_db: float = -3.0) -> np.ndarray:
    """Float64 HOST oracle of the full flagship chain — no jax, pure
    numpy/scipy composition of the per-op pinned oracles
    (``resample_oracle_np``/``sosfilt_np``/``reverb_np``/``limiter_np``).
    This is the accuracy reference bench.py reports ``accuracy_db``
    against (round-4 VERDICT item 4: the end-to-end margin must land in
    a driver artifact, not just in tests). Math mirrors
    :func:`make_flagship_step`: mixfirst is exact (the resampler is LTI
    and both tracks share the fade window), and the EQ<->reverb fold
    commutes exactly, so ONE oracle covers every production backend.
    Python-loop oracles are O(n) per clip — pass one clip, not a batch.
    """
    v = np.asarray(voice_i16)
    b = np.asarray(bgm_i16)
    x = (v.astype(np.float64) + bgm_gain * b.astype(np.float64)) / 32768.0
    m = _resample.resample_oracle_np(x, sr_in, sr_bus)
    nb = m.shape[-1]
    fade = int(round(fade_ms * sr_bus / 1000.0))
    out = m * _mix.fade_ramp_np(nb, fade, fade, nb)
    peak = np.max(np.abs(out), axis=-1, keepdims=True)
    scale = np.where(peak > 0, _mix.db_to_amp(-1.0) / np.maximum(peak, 1e-30),
                     1.0)
    out = out * scale
    sos = _biquad.eq_sos(list(bands), sr_bus)
    out, _ = _biquad.sosfilt_np(sos, out)
    ir = _reverb.synthetic_ir(ir_seconds, sr_bus).astype(np.float64)
    out = _reverb.reverb_np(out, ir, wet=wet, dry=dry)
    y, _ = _limiter.limiter_np(out[..., None, :], sr_bus,
                               threshold_db=threshold_db,
                               release_ms=LIM_RELEASE_MS,
                               attack_ms=LIM_ATTACK_MS)
    return _convert.f32_to_pcm16_np(y[..., 0, :].astype(np.float32))


def _front_mixfirst(voice_i16, bgm_i16, sr_in, sr_bus, bgm_gain):
    """int16 voice + BGM -> mixed f32 bus at sr_bus, before the fade.

    Mix BEFORE the rate conversion: both tracks share the fade window
    and the resampler is LTI, so resample(voice) + g*resample(bgm) ==
    resample(voice + g*bgm) exactly, at half the resample rows. When n
    frames evenly, the int16 inputs are framed first (a bitcast), so
    the convert+mix fusion writes the resample product's operand layout
    directly."""
    B_, n_in = voice_i16.shape
    gmix = jnp.float32(bgm_gain)
    if _resample.aligned_supported(n_in, sr_in, sr_bus):
        Mloc = sr_in // _math.gcd(sr_in, sr_bus)
        v3 = voice_i16.reshape(B_, n_in // Mloc, Mloc)
        b3 = bgm_i16.reshape(B_, n_in // Mloc, Mloc)
        m3 = _convert.pcm16_to_f32(v3) + gmix * _convert.pcm16_to_f32(b3)
        return _resample.polyphase_resample_framed(
            m3, sr_in, sr_bus,
            precision=jax.lax.Precision.HIGHEST).reshape(B_, -1)
    m = _convert.pcm16_to_f32(voice_i16) + gmix * _convert.pcm16_to_f32(bgm_i16)
    return _resample.polyphase_resample(m, sr_in, sr_bus)


def _make_fx(sos, ir, wet, dry, threshold_db, sr_bus, engine, lti_fold):
    """fx(x, scale) -> limited f32 bus: EQ -> reverb -> limiter on the
    normalized bus, by engine (``xmtpu.engine``)."""
    eng, _ = _engine.resolve(engine)
    ir_comb = (_combined_ir(sos, ir, wet, dry)
               if lti_fold and eng == _engine.GPU else None)

    def fx(x, scale):
        from xmtpu.utils.profiling import stage

        if ir_comb is not None:
            with stage("eq+reverb"):
                # LTI fold: EQ rides the reverb convolution (one combined
                # IR); the peak-normalize gain rides its epilogue
                out = _reverb.reverb(x, ir_comb, wet=1.0, dry=0.0,
                                     block=_reverb.os_block(len(ir_comb)),
                                     prescale=scale)
        else:
            with stage("eq"):
                out, _ = _biquad.sosfilt_scan(sos, x * scale,
                                              state_dtype=jnp.float64)
            with stage("reverb"):
                out = _reverb.reverb(out, ir, wet=wet, dry=dry,
                                     block=_reverb.os_block(len(ir)))
        with stage("limiter"):
            out, _ = _limiter.limiter(
                out[..., None, :], sr_bus, threshold_db=threshold_db,
                release_ms=LIM_RELEASE_MS, attack_ms=LIM_ATTACK_MS,
                backend=engine)
        return out[..., 0, :]

    return fx


def make_flagship_step(
    sr_in: int = 44100,
    sr_bus: int = 16000,
    bands=DEFAULT_BANDS,
    ir_seconds: float = 0.25,
    wet: float = 0.25,
    dry: float = 0.75,
    bgm_gain: float = 0.4,
    fade_ms: float = 250.0,
    threshold_db: float = -3.0,
    engine: str | None = None,
    lti_fold: bool = True,
):
    """Build the full-chain step fn(voice_i16[B,n], bgm_i16[B,n]) -> i16[B,m].

    Chain per BASELINE.json:5: int16->f32, polyphase resample sr_in->
    sr_bus, voice+BGM mix with gain/fade, peak normalize, 5-band EQ,
    FIR reverb, soft-knee limiter, f32->int16 — all in one jit.

    ``engine``: an ``xmtpu.engine`` name (None = the platform's). The
    card's engine folds the EQ into the reverb and runs the limiter
    envelope kernel; the XLA engine runs the f64 scans. ``lti_fold=
    False`` keeps the EQ scan on the card's engine too.
    """
    sos = _biquad.eq_sos(list(bands), sr_bus)
    ir = _reverb.synthetic_ir(ir_seconds, sr_bus).astype("float32")
    fx = _make_fx(sos, ir, wet, dry, threshold_db, sr_bus, engine, lti_fold)

    def step(voice_i16: jnp.ndarray, bgm_i16: jnp.ndarray) -> jnp.ndarray:
        from xmtpu.utils.profiling import stage

        fade = int(round(fade_ms * sr_bus / 1000.0))
        with stage("mixfirst"):
            m = _front_mixfirst(voice_i16, bgm_i16, sr_in, sr_bus, bgm_gain)
            out = m * _mix.fade_ramp(m.shape[-1], fade, fade, m.shape[-1])
        with stage("normalize"):
            # per-clip peak normalize (NOT global: clips are independent,
            # and dp-sharded must match single-chip bit-for-bit); the gain
            # is applied by the next stage's input or epilogue
            peak = jnp.max(jnp.abs(out), axis=-1, keepdims=True)
            scale = jnp.where(
                peak > 0, _mix.db_to_amp(-1.0) / jnp.maximum(peak, 1e-30), 1.0
            )
        return _convert.f32_to_pcm16(fx(out, scale))

    return step


def make_batch_step(
    sr_in: int = 44100,
    sr_bus: int = 16000,
    bands=DEFAULT_BANDS,
    ir_seconds: float = 0.25,
    wet: float = 0.25,
    dry: float = 0.75,
    bgm_gain: float = 0.4,
    fade_ms: float = 250.0,
    threshold_db: float = -3.0,
    engine: str | None = None,
    lti_fold: bool = True,
):
    """Masked flagship step for RAGGED clip batches (BASELINE.json:10).

    fn(voice_i16[B,n_pad], bgm_i16[B,n_pad], lengths[B]) -> i16[B,m_pad].
    Clips are zero-padded to a common n_pad; ``lengths`` carries each
    clip's true sample count so fades, the peak scan and the output mask
    ignore pad (SURVEY.md §7.3 "Ragged clip lengths"). Values in
    [0, out_len_i) match the unbatched flagship step on the lone clip.
    ``engine``/``lti_fold``: as :func:`make_flagship_step`.
    """
    sos = _biquad.eq_sos(list(bands), sr_bus)
    ir = _reverb.synthetic_ir(ir_seconds, sr_bus).astype("float32")
    fx = _make_fx(sos, ir, wet, dry, threshold_db, sr_bus, engine, lti_fold)
    g = _math.gcd(sr_in, sr_bus)
    L, M = sr_bus // g, sr_in // g

    def step(voice_i16, bgm_i16, lengths):
        # mixfirst front (see _front_mixfirst): the gain/ramp/mask all
        # apply at the bus rate, so mixing at the native rate and
        # resampling ONCE is exact by LTI commutation
        v = (_convert.pcm16_to_f32(voice_i16)
             + jnp.float32(bgm_gain) * _convert.pcm16_to_f32(bgm_i16))
        v = _resample.polyphase_resample(v, sr_in, sr_bus)
        n = v.shape[-1]
        # per-clip output lengths at the bus rate: ceil(len * L / M).
        # int64: int32 lengths*L wraps negative for clips >= ~304 s at
        # 44.1k->16k (L=160), silently zero-masking the whole clip.
        out_len = -(-(lengths.astype(jnp.int64) * L) // M)  # [B] ceil —
        # parens matter: -(-a*L)//M is floor, dropping the last sample
        # f64 index: f32 arange is exact only below 2^24 (~17 min @16k)
        i = jnp.arange(n, dtype=jnp.float64)[None, :]  # [1, n]
        lenf = out_len.astype(jnp.float64)[:, None]  # [B, 1]
        mask = i < lenf
        fade = float(round(fade_ms * sr_bus / 1000.0))
        if fade > 0:
            ramp = (jnp.minimum((i + 1.0) / fade, 1.0) * jnp.clip(
                (lenf - i) / fade, 0.0, 1.0
            )).astype(jnp.float32)
        else:  # no 0/0 NaN (would poison the peak normalize)
            ramp = jnp.float32(1.0)
        out = v * ramp * mask  # v already carries the mixed bgm
        peak = jnp.max(jnp.abs(out), axis=-1, keepdims=True)  # pad is 0
        scale = jnp.where(
            peak > 0, _mix.db_to_amp(-1.0) / jnp.maximum(peak, 1e-30), 1.0
        )
        return _convert.f32_to_pcm16(fx(out, scale) * mask)

    return step


def shard_over_batch(n_devices: int | None = None):
    """1-D data-parallel mesh over clips (SURVEY.md §2.2 DP row)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    mesh = jax.sharding.Mesh(np.asarray(devs[:n]), ("dp",))
    return mesh, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("dp", None)
    )


def flagship_step_sharded(mesh, **kw):
    """Flagship step SPMD over the ``dp`` (clip batch) mesh axis via
    shard_map: each device runs the identical per-shard program (the
    envelope kernel included); no collectives needed for pure DP
    (SURVEY.md §2.2 — peak stats stay per-clip, not global), so the
    result equals one device's bit for bit."""
    P = jax.sharding.PartitionSpec
    step = make_flagship_step(**kw)
    return jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P("dp", None), P("dp", None)),
        out_specs=P("dp", None),
        check_vma=False,  # pallas_call outputs carry no vma annotation
    ))
