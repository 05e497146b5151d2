"""Golden tests for mixing (config 2, BASELINE.json:8): fades, gain,
N-track sum, normalization, timeline placement, looping."""

import numpy as np
import jax.numpy as jnp
import pytest

from xmtpu import api
from xmtpu.ops import mix as M
from tests.conftest import rms_db

TARGET_DB = -80.0


def test_fade_ramp_boundary_samples():
    """Pinned ramp rule: first sample 1/F, sample F-1 unity; last sample 1/F."""
    g = np.asarray(M.fade_ramp(10, 4, 3, 10))
    want = M.fade_ramp_np(10, 4, 3, 10)
    np.testing.assert_allclose(g, want, rtol=1e-6)
    assert want[0] == pytest.approx(1 / 4)
    assert want[3] == pytest.approx(1.0)
    assert want[-1] == pytest.approx(1 / 3)
    assert want[-3] == pytest.approx(1.0)


def test_fade_ramp_offset_blocks():
    """Ramp computed block-by-block (offset) == ramp computed whole."""
    whole = np.asarray(M.fade_ramp(1000, 100, 200, 1000))
    parts = np.concatenate(
        [np.asarray(M.fade_ramp(250, 100, 200, 1000, offset=o))
         for o in range(0, 1000, 250)]
    )
    np.testing.assert_allclose(parts, whole, rtol=1e-6)


@pytest.mark.parametrize("normalize", [None, "peak", "loudness"])
def test_mix_golden(rng, normalize):
    n = 16000
    voice = (0.4 * rng.standard_normal(n)).astype(np.float32)
    bgm = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000)).astype(np.float32)
    gains = [1.0, 0.5]
    fi = [160, 800]
    fo = [320, 1600]
    want = M.mix_oracle_np([voice, bgm], gains, fi, fo,
                           normalize=normalize, target_amp=M.db_to_amp(-1.0))
    got = api.mix(
        [
            dict(pcm=voice, sr=16000, gain=1.0, fade_in_ms=10, fade_out_ms=20),
            dict(pcm=bgm, sr=16000, gain=0.5, fade_in_ms=50, fade_out_ms=100),
        ],
        16000,
        normalize=normalize,
        target_db=-1.0,
    )
    assert got.shape == want.shape
    assert rms_db(got - want, want) <= TARGET_DB


def test_mix_peak_normalize_hits_target(rng):
    x = (0.1 * rng.standard_normal(8000)).astype(np.float32)
    out = api.mix([dict(pcm=x, sr=16000)], 16000, normalize="peak", target_db=-1.0)
    assert np.max(np.abs(out)) == pytest.approx(M.db_to_amp(-1.0), rel=1e-4)


def test_mix_placement_and_loop(rng):
    """BGM placed at 500 ms and looped to fill the voice duration."""
    sr = 16000
    voice = np.ones(sr, np.float32) * 0.5  # 1 s
    bgm = np.full(1600, 0.25, np.float32)  # 100 ms, loops
    out = api.mix(
        [
            dict(pcm=voice, sr=sr),
            dict(pcm=bgm, sr=sr, start_ms=500, loop=True),
        ],
        sr,
        normalize=None,
    )
    assert len(out) == sr
    np.testing.assert_allclose(out[:8000], 0.5, atol=1e-6)  # voice only
    np.testing.assert_allclose(out[8000:], 0.75, atol=1e-6)  # voice + looped bgm


def test_mix_int16_in_out(rng):
    x = (rng.standard_normal(8000) * 8000).astype(np.int16)
    out = api.mix([dict(pcm=x, sr=16000)], 16000, normalize=None)
    assert out.dtype == np.int16
    # gain-1 single-track mix == i16->f32->i16 roundtrip == identity
    np.testing.assert_array_equal(out, x)


def test_mix_resamples_tracks(rng):
    """A 44.1k track mixed onto a 16k bus arrives resampled."""
    from xmtpu.ops import resample as R

    x = (0.3 * rng.standard_normal(44100)).astype(np.float32)
    out = api.mix([dict(pcm=x, sr=44100)], 16000, normalize=None)
    want = R.resample_oracle_np(x, 44100, 16000)
    assert out.shape == want.shape
    assert rms_db(out - want, want) <= TARGET_DB


def test_mix_mono_upmix_to_stereo(rng):
    mono = (0.2 * rng.standard_normal(4000)).astype(np.float32)
    st = np.stack([mono, -mono], axis=1)
    out = api.mix([dict(pcm=st, sr=16000), dict(pcm=mono, sr=16000)],
                  16000, normalize=None)
    assert out.shape == (4000, 2)
    np.testing.assert_allclose(out[:, 0], 2 * mono, atol=1e-6)
    np.testing.assert_allclose(out[:, 1], np.zeros_like(mono), atol=1e-6)


def test_mix_silence_normalize_noop():
    x = np.zeros(1000, np.float32)
    out = api.mix([dict(pcm=x, sr=16000)], 16000, normalize="peak")
    np.testing.assert_array_equal(out, x)


def test_mix_rejects_empty():
    with pytest.raises(ValueError):
        api.mix([], 16000)


def test_mix_accepts_pcm_sr_pairs(rng):
    # (pcm, sr) shorthand == dict(pcm=, sr=) track-for-track
    a = (rng.standard_normal(1600) * 0.2).astype(np.float32)
    b = (rng.standard_normal(1600) * 0.1).astype(np.float32)
    want = api.mix([dict(pcm=a, sr=16000), dict(pcm=b, sr=16000)], 16000)
    got = api.mix([(a, 16000), [b, 16000]], 16000)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_mix_rejects_bare_array_track():
    from xmtpu.utils.errors import ConfigError

    with pytest.raises(ConfigError, match=r"\(pcm, sr\) pair"):
        api.mix([np.zeros(100, np.float32)], 16000)


# --- side-chain ducking (reference BGM-under-voice; pinned in ops.mix) -----


def test_duck_gain_matches_oracle(signals):
    import jax.numpy as jnp
    from xmtpu.ops import mix as mops

    v = signals(16000, 16000)["noise"]  # 1 s voice
    v[:4000] = 0.0  # silence, then speech
    g = np.asarray(mops.duck_gain(jnp.asarray(v), 16000), np.float64)
    ref = mops.duck_gain_np(v, 16000)
    assert rms_db(g - ref, ref) <= -80.0


def test_mix_side_duck_attenuates_bgm(signals):
    from xmtpu.graph import mixer as mixg
    from xmtpu.ops import mix as mops

    sr = 16000
    n = sr  # 1 s
    voice = np.zeros(n, np.float32)
    voice[n // 2 :] = signals(n // 2, sr)["noise"]  # speech in 2nd half
    t = np.arange(n) / sr
    bgm = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    out = mixg.mix(
        [
            mixg.MixTrack(pcm=voice, sr=sr, kind="voice"),
            mixg.MixTrack(pcm=bgm, sr=sr, kind="bgm", side_duck=True),
        ],
        sr,
        normalize=None,
        duck_params={"depth_db": 12.0, "threshold_db": -40.0,
                     "attack_ms": 5.0, "release_ms": 50.0},
    )
    # numpy oracle: same pinned math
    g = mops.duck_gain_np(voice.astype(np.float64), sr, depth_db=12.0,
                          threshold_db=-40.0, attack_ms=5.0, release_ms=50.0)
    ref = voice.astype(np.float64) + bgm.astype(np.float64) * g
    assert rms_db(out.astype(np.float64) - ref, ref) <= -80.0
    # behavioural: bgm loud while voice silent, ducked ~12 dB under voice
    head = out[1000 : n // 2 - 1000]
    tail = (out - voice)[n // 2 + 2000 :]
    ratio_db = 20 * np.log10(np.abs(tail).max() / np.abs(head).max())
    assert -13.5 < ratio_db < -10.5, ratio_db


def test_mix_track_placed_past_end_is_silence(signals):
    """Regression: a track starting at/after the mix end must contribute
    silence, not crash the jitted build."""
    from xmtpu.graph import mixer as mixg

    x = signals(8000, 16000)["noise"]
    out = mixg.mix(
        [
            mixg.MixTrack(pcm=x, sr=16000),
            mixg.MixTrack(pcm=x, sr=16000, start_ms=2000.0),  # past 1 s end
        ],
        16000, normalize=None, duration_ms=500.0,
    )
    ref = x[:8000][: len(out)]
    np.testing.assert_allclose(out, ref[: len(out)], atol=1e-6)


def test_mix_duration_voice_offset_with_loop(rng):
    """Duration = end of the last NON-loop track including start_ms;
    a looped BGM must neither truncate nor extend it (round-2 review
    find: the old sentinel cut offset voices and let long loop sources
    extend the program)."""
    sr = 16000
    voice = np.ones(sr, np.float32) * 0.5           # 1 s voice
    bgm = np.full(4 * sr, 0.25, np.float32)         # 4 s loop source
    out = api.mix(
        [
            dict(pcm=voice, sr=sr, start_ms=500),   # ends at 1.5 s
            dict(pcm=bgm, sr=sr, loop=True),
        ],
        sr,
        normalize=None,
    )
    assert len(out) == sr + sr // 2  # 1.5 s: voice end, not the 4 s loop
    np.testing.assert_allclose(out[: sr // 2], 0.25, atol=1e-6)
    np.testing.assert_allclose(out[sr // 2 :], 0.75, atol=1e-6)


def test_mix_all_loop_duration_one_pass(rng):
    """All-loop config: one pass of the longest placed source."""
    sr = 16000
    bgm = np.full(3200, 0.25, np.float32)  # 200 ms
    out = api.mix([dict(pcm=bgm, sr=sr, loop=True)], sr, normalize=None)
    assert len(out) == 3200


def test_fade_ramp_exact_past_2_24(rng):
    """Fade indices stay exact above 2^24 samples (f64 iota; round-2
    review find: f32 arange plateaued in 16-sample steps)."""
    n, length, fade = 64, 2**24 + 4096, 1000
    off = length - n
    g = np.asarray(M.fade_ramp(n, 0, fade, length, offset=off))
    i = np.arange(off, off + n, dtype=np.float64)
    ref = np.clip((length - i) / fade, 0.0, 1.0)
    np.testing.assert_allclose(g, ref.astype(np.float32), rtol=0, atol=1e-7)
    assert len(np.unique(g)) == n  # strictly decreasing, no plateaus


def test_partial_channel_mismatch_rejected(rng):
    """1 < ch < nch has no defined upmix; it used to die in jnp.stack
    deep inside the jit trace with an opaque shape error (review
    find)."""
    import pytest

    from xmtpu.graph.mixer import mix
    from xmtpu.utils.errors import ConfigError

    stereo = (rng.standard_normal((1000, 2)) * 0.1).astype(np.float32)
    quad = (rng.standard_normal((1000, 4)) * 0.1).astype(np.float32)
    with pytest.raises(ConfigError, match="only mono tracks upmix"):
        mix([{"pcm": stereo, "sr": 16000}, {"pcm": quad, "sr": 16000}],
            16000)


def test_mix_rejects_negative_placement_and_bad_rate(rng):
    from xmtpu.utils.errors import ConfigError

    x = (rng.standard_normal(1600) * 0.2).astype(np.float32)
    # negative start_ms used to die as an opaque negative-pad trace
    # error deep inside jit (review find)
    with pytest.raises(ConfigError, match="start_ms"):
        api.mix([dict(pcm=x, sr=16000, start_ms=-50.0)], 16000)
    with pytest.raises(ConfigError, match="duration_ms"):
        api.mix([dict(pcm=x, sr=16000)], 16000, duration_ms=-1.0)
    # a pathological header rate (coprime with the bus) used to design
    # a 16000-phase filter bank and stall the compiler
    with pytest.raises(ConfigError, match="unreasonable"):
        api.mix([dict(pcm=x, sr=44101)], 16000)
    with pytest.raises(ConfigError, match="unreasonable"):
        api.resample(x, 44101, 16000)


def test_mix_jit_cache_is_lru_and_holds_no_pcm(rng):
    """The plan cache must bump recency on hit — under real eviction
    pressure: 66 rotating cold plans overflow the 64-entry bound, and
    a FIFO .get (the pre-fix code) evicts the hot plan despite its
    hits (review find). Closures must not pin track PCM (slim-meta
    copy, checked white-box)."""
    import xmtpu.graph.mixer as mixer_mod

    mixer_mod._MIX_JIT_CACHE.clear()
    x = (rng.standard_normal(160) * 0.2).astype(np.float32)
    hot = [dict(pcm=x, sr=16000)]
    api.mix(hot, 16000)
    key0, fn0 = next(iter(mixer_mod._MIX_JIT_CACHE.items()))
    # fill to the 64-entry bound with direct dummy inserts (cheap: no
    # compiles; 60+ real cold mixes would be slow). Hot is now OLDEST.
    for i in range(63):
        mixer_mod._MIX_JIT_CACHE[("dummy", i)] = None
    api.mix(hot, 16000)  # hit MUST bump recency (pop+reinsert)
    api.mix([dict(pcm=x, sr=16000, gain=1.5)], 16000)  # overflow: evicts
    # the oldest entry — a dummy under LRU; the pre-fix .get left hot
    # oldest and evicted IT here
    assert mixer_mod._MIX_JIT_CACHE.get(key0) is fn0
    assert ("dummy", 0) not in mixer_mod._MIX_JIT_CACHE
    mixer_mod._MIX_JIT_CACHE.clear()  # drop the dummies
    # the cached closure's meta must carry pcm=None MixTracks
    build = fn0.__wrapped__
    meta = build.__closure__[
        build.__code__.co_freevars.index("meta")].cell_contents
    assert all(t.pcm is None for (_, _, t) in meta)
