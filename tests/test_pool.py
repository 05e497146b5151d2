"""SessionPool (serving mode): K concurrent sessions == K independent
StreamSessions, with per-slot join/leave/seek and no retracing.

Reference usage model: many independent xm_audio_utils handles in one
process (SURVEY.md §3.2); round-2 VERDICT directive #2.
"""

from __future__ import annotations

import numpy as np
import pytest

import xmtpu  # noqa: F401
from xmtpu.config.schema import EffectConfig, PipelineConfig, TrackConfig
from xmtpu.graph.pool import SessionPool
from xmtpu.graph.streaming import StreamSession
from xmtpu.utils.errors import ConfigError

from .conftest import rms_db

SR = 16000


def _cfg(effects=True):
    eff = (
        EffectConfig("equalizer", {"bands": [
            {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0},
            {"freq_hz": 3000.0, "gain_db": -3.0, "q": 0.8}]}),
        EffectConfig("limiter", {}),
    ) if effects else ()
    return PipelineConfig(
        tracks=(TrackConfig(url="v", fade_in_ms=50.0, fade_out_ms=80.0),),
        effects=eff,
        sample_rate=SR, normalize=None,
    )


def _voices(rng, k, sr=44100, seconds=1.0):
    return [
        {"v": ((0.3 * rng.standard_normal(
            int(sr * (seconds + 0.2 * i)))).astype(np.float32), sr)}
        for i in range(k)
    ]


def test_pool_drops_host_pcm_after_upload(rng):
    """Sources are device-resident: the decoded host PCM must not stay
    pinned in _slot_tracks/_geom after the one-time upload (a 32-slot
    pool of long clips pinned GBs of host RAM redundantly; review
    find). Geometry fields keep working — reads stay correct."""
    K = 2
    srcs = _voices(rng, K, seconds=0.3)
    pool = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    for tracks in pool._slot_tracks:
        assert tracks is not None
        assert all(ts.pcm is None for ts in tracks)
    out = pool.read(2)
    assert np.any(out != 0)
    pool.join(1, srcs[1])  # re-join still works post-drop
    assert all(ts.pcm is None for ts in pool._slot_tracks[1])


def test_pool_matches_independent_sessions(rng):
    """K pooled slots == K independent sessions <= -80 dB, int16 out."""
    K = 3
    srcs = _voices(rng, K)
    pool = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    sessions = [StreamSession(_cfg(), frame_ms=20.0, sources=s)
                for s in srcs]
    assert pool.frame_out == sessions[0].frame_out
    for _ in range(3):  # several groups: state carries across reads
        got = pool.read(8)  # (K, 8*frame, ch)
        for i, sess in enumerate(sessions):
            ref = sess.read_many(8)
            g = got[i].astype(np.float64) / 32768.0
            r = ref.astype(np.float64) / 32768.0
            assert rms_db(g - r, r + 1e-12) <= -80.0, i


def test_pool_join_leave_seek(rng):
    K = 3
    srcs = _voices(rng, K)
    # max_seconds: slot 2's later join brings a LONGER clip than any
    # at construction — the device source buffers must be sized for it
    pool = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs[:2],
                       max_seconds=2.0)
    # slot 2 empty -> exact silence
    out = pool.read(4)
    assert np.all(out[2] == 0)
    assert pool.active() == [0, 1]
    # join slot 2 mid-stream: matches a fresh session from 0
    pool.join(2, srcs[2])
    sess = StreamSession(_cfg(), frame_ms=20.0, sources=srcs[2])
    got = pool.read(6)[2].astype(np.float64) / 32768.0
    ref = sess.read_many(6).astype(np.float64) / 32768.0
    assert rms_db(got - ref, ref + 1e-12) <= -80.0
    # leave: silence again, others unaffected and state-continuous
    sess0 = StreamSession(_cfg(), frame_ms=20.0, sources=srcs[0])
    sess0.read_many(10)  # advance to the pool's slot-0 clock
    pool.leave(1)
    out = pool.read(4)
    assert np.all(out[1] == 0)
    ref0 = sess0.read_many(4).astype(np.float64) / 32768.0
    got0 = out[0].astype(np.float64) / 32768.0
    assert rms_db(got0 - ref0, ref0 + 1e-12) <= -80.0
    # seek: frame-aligned reposition + state reset, like the reference
    pool.seek(0, 200.0)
    sess0b = StreamSession(_cfg(), frame_ms=20.0, sources=srcs[0])
    sess0b.seek(200.0)
    got = pool.read(4)[0].astype(np.float64) / 32768.0
    ref = sess0b.read_many(4).astype(np.float64) / 32768.0
    assert rms_db(got - ref, ref + 1e-12) <= -80.0


def test_pool_geometry_validation(rng):
    srcs = _voices(rng, 1)
    pool = SessionPool(_cfg(), 2, sources=srcs)
    with pytest.raises(ConfigError, match="polyphase"):
        pool.join(1, {"v": (np.zeros(8000, np.float32), 48000)})
    with pytest.raises(ConfigError, match="slot"):
        pool.seek(7, 0.0)


def test_pool_ducking_parity(rng):
    """Side-chain ducking state is carried per slot."""
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),
                TrackConfig(url="b", kind="bgm", side_duck=True, loop=True)),
        sample_rate=SR, normalize=None,
    )
    v = (0.3 * rng.standard_normal(32000)).astype(np.float32)
    b = (0.2 * np.sin(np.arange(8000) / 20.0)).astype(np.float32)
    srcs = [{"v": (v, SR), "b": (b, SR)},
            {"v": (0.5 * v[::-1].copy(), SR), "b": (b, SR)}]
    pool = SessionPool(cfg, 2, frame_ms=20.0, sources=srcs)
    sessions = [StreamSession(cfg, frame_ms=20.0, sources=s) for s in srcs]
    got = pool.read(10)
    for i, sess in enumerate(sessions):
        ref = sess.read_many(10).astype(np.float64) / 32768.0
        g = got[i].astype(np.float64) / 32768.0
        assert rms_db(g - ref, ref + 1e-12) <= -80.0, i


def test_pool_buffer_capacity_guard(rng):
    srcs = _voices(rng, 1, seconds=0.5)
    pool = SessionPool(_cfg(), 2, sources=srcs)
    with pytest.raises(ConfigError, match="max_seconds"):
        pool.join(1, _voices(rng, 1, seconds=3.0)[0])


def test_pool_dispatch_snapshots_host_clocks(rng):
    """Regression (round-3 race find): ``_dispatch`` must hand jax
    COPIES of the host-side clock/length arrays. ``read`` mutates
    ``_frame_idx`` in place right after dispatching, and the
    host->device transfer can read the source buffer asynchronously —
    without the snapshot, a group intermittently computed with the
    post-advance clocks (slot output k frames ahead, ~25% of CPU
    runs). Forcing the mutation to garbage between dispatch and fetch
    makes any surviving alias fail loudly."""
    srcs = _voices(rng, 2)
    pool = SessionPool(_cfg(), 2, frame_ms=20.0, sources=srcs)
    sessions = [StreamSession(_cfg(), frame_ms=20.0, sources=s)
                for s in srcs]
    pend = pool._dispatch(4)
    pool._frame_idx[:] = 10**6  # stale alias would read clocks far
    pool._n_nat[0][:] = 0       # past the clip -> silence
    out = np.asarray(pend[2])   # fetch AFTER the mutation
    for i, sess in enumerate(sessions):
        ref = sess.read_many(4)
        g = out[i].astype(np.float64) / 32768.0
        r = np.moveaxis(ref, 0, 1).astype(np.float64) / 32768.0
        assert rms_db(g - r, r + 1e-12) <= -80.0, i


def test_pool_checkpoint_resume(rng, tmp_path):
    """Serving failover: save_state mid-stream, restore into a FRESH
    pool (same config + sources re-joined), and the stream continues
    bit-for-bit where the snapshot left off (SURVEY.md §5
    checkpoint/resume at serving scale)."""
    K = 3
    srcs = _voices(rng, K)
    pool = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    pool.read(6)  # advance: filter/limiter state + clocks are nonzero
    path = tmp_path / "pool_state.npz"
    pool.save_state(path)
    expect = pool.read(4)  # the uninterrupted continuation

    pool2 = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    pool2.load_state_file(path)
    got = pool2.read(4)
    assert np.array_equal(got, expect)

    # restore validation: a pool with a different slot mask refuses
    pool3 = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs[:2])
    with pytest.raises(ConfigError, match="active-slot"):
        pool3.load_state_file(path)
    # different sources in the same slots refuse too
    other = _voices(rng, K, seconds=1.7)
    pool4 = SessionPool(_cfg(), K, frame_ms=20.0, sources=other,
                        max_seconds=2.0)
    with pytest.raises(ConfigError, match="source lengths"):
        pool4.load_state_file(path)
    # a different effects chain builds a different state tree: typed
    # refuse, not a KeyError from the missing npz leaves
    pool5 = SessionPool(_cfg(effects=False), K, frame_ms=20.0, sources=srcs)
    with pytest.raises(ConfigError, match="state leaves"):
        pool5.load_state_file(path)
    # a different TRACK count: typed refuse on the track-table shape,
    # not an IndexError from indexing the snapshot's n_nat rows
    cfg2 = PipelineConfig(
        tracks=(TrackConfig(url="v", fade_in_ms=50.0, fade_out_ms=80.0),
                TrackConfig(url="w")),
        effects=(), sample_rate=SR, normalize=None)
    srcs2 = [dict(s, w=s["v"]) for s in srcs]
    pool6 = SessionPool(cfg2, K, frame_ms=20.0, sources=srcs2)
    with pytest.raises(ConfigError, match="track table shape"):
        pool6.load_state_file(path)


def _dp_mesh(min_devices=2):
    import jax

    devs = jax.devices()
    if len(devs) < min_devices:
        pytest.skip("needs a multi-device mesh (XLA_FLAGS="
                    "--xla_force_host_platform_device_count=8)")
    ndp = 4 if len(devs) >= 4 else 2
    return jax.sharding.Mesh(np.array(devs[:ndp]), ("dp",)), ndp


def test_pool_dp_mesh_parity(rng):
    """K slots sharded over a dp mesh == the single-device pool
    (SURVEY.md §2.2 DP row applied to serving: the slot axis is pure
    data parallelism, so partitioning the one jitted step must not
    change any slot's math)."""
    mesh, ndp = _dp_mesh()
    K = 2 * ndp
    srcs = _voices(rng, K, seconds=0.3)
    pool_m = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs, mesh=mesh)
    pool_1 = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    for _ in range(2):  # two groups: sharded STATE carries across reads
        got = pool_m.read(4)
        ref = pool_1.read(4)
        g = got.astype(np.float64) / 32768.0
        r = ref.astype(np.float64) / 32768.0
        assert rms_db(g - r, r + 1e-12) <= -80.0
    # slot lifecycle on the sharded pool: leave silences its lanes,
    # join reattaches, seek repositions — all host-side scatters into
    # the sharded arrays, no retrace of the SPMD step
    n_exec = len(pool_m._scan_steps)
    pool_m.leave(1)
    out = pool_m.read(4)
    assert np.all(out[1] == 0)
    pool_m.join(1, srcs[1])
    pool_m.seek(0, 100.0)
    sess = StreamSession(_cfg(), frame_ms=20.0, sources=srcs[1])
    got = pool_m.read(4)[1].astype(np.float64) / 32768.0
    ref = sess.read_many(4).astype(np.float64) / 32768.0
    assert rms_db(got - ref, ref + 1e-12) <= -80.0
    assert len(pool_m._scan_steps) == n_exec


def test_pool_mesh_validation(rng):
    mesh, ndp = _dp_mesh()
    srcs = _voices(rng, 1, seconds=0.2)
    with pytest.raises(ConfigError, match="divide evenly"):
        SessionPool(_cfg(), ndp + 1, sources=srcs, mesh=mesh)
    with pytest.raises(ConfigError, match="no axis"):
        SessionPool(_cfg(), ndp, sources=srcs, mesh=mesh, mesh_axis="tp")


def test_pool_parity_at_32_sessions(rng):
    """Parity at the judged serving scale (round-2 VERDICT directive
    #2: 32 concurrent 20 ms sessions): every one of 32 pooled slots
    matches its independent StreamSession <= -80 dB. Shorter sources
    and one group keep the CPU cost of the 32 reference sessions sane;
    the pool's throughput is measured by benchmarks.config5_streaming."""
    K = 32
    srcs = _voices(rng, K, seconds=0.3)
    pool = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    got = pool.read(4)  # (K, 4*frame, ch)
    for i in range(K):  # EVERY lane — a spot-check left sublane-tile
        # bugs in unchecked lanes invisible (review find)
        sess = StreamSession(_cfg(), frame_ms=20.0, sources=srcs[i])
        ref = sess.read_many(4)
        g = got[i].astype(np.float64) / 32768.0
        r = ref.astype(np.float64) / 32768.0
        assert rms_db(g - r, r + 1e-12) <= -80.0, i


def test_pool_thread_safety_join_leave_during_reads(rng):
    """Serving shape: one thread pumps read() while another churns
    join/leave/seek on other slots. The internal lock must keep every
    group internally consistent — no exceptions, correct shapes, and a
    slot that was left (and not rejoined) reads silence afterwards."""
    import threading

    K = 4
    srcs = _voices(rng, K, seconds=0.4)
    pool = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs)
    errs: list = []
    stop = threading.Event()

    def churn():
        try:
            for i in range(30):
                s = 1 + (i % (K - 1))  # never slot 0
                pool.leave(s)
                pool.seek(0, 40.0 * (i % 3))
                pool.join(s, srcs[s])
            pool.leave(K - 1)
        except Exception as e:  # noqa: BLE001 — surface to the main thread
            errs.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=churn)
    t.start()
    outs = []
    while not stop.is_set():
        outs.append(pool.read(4))  # k=4: reuses the suite's executable
    t.join()
    assert not errs, errs
    assert all(o.shape == outs[0].shape for o in outs)
    # Re-seek slot 0 before asserting it is audible: how many read(4)
    # calls the main loop lands between churn steps is scheduling-
    # dependent, and each one advances slot 0 by 80 ms — on a fast run
    # the 0.4 s source is already past its end here, which read as a
    # thread-safety failure (flaky-by-timing; fixed 2026-08-18).
    pool.seek(0, 0.0)
    out = pool.read(4)  # post-churn: K-1 was left last and stays silent
    assert np.all(out[K - 1] == 0)
    assert np.any(out[0] != 0)


def test_pool_with_noise_suppression_matches_sessions(rng):
    """A pool whose config includes noise_suppression == K independent
    sessions (round-3 VERDICT directive #5: NS was the one effect
    excluded from the serving surface)."""
    K = 2
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        effects=(EffectConfig("noise_suppression", {"nfft": 320}),),
        sample_rate=SR, normalize=None,
    )
    srcs = _voices(rng, K, seconds=0.8)
    pool = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    sessions = [StreamSession(cfg, frame_ms=20.0, sources=s) for s in srcs]
    for _ in range(2):
        got = pool.read(8)
        for i, sess in enumerate(sessions):
            ref = sess.read_many(8)
            g = got[i].astype(np.float64) / 32768.0
            r = ref.astype(np.float64) / 32768.0
            assert rms_db(g - r, r + 1e-12) <= -80.0, i


def test_pool_restore_accepts_legacy_scalar_ns_counter(rng, tmp_path):
    """Round-5 review find: pre-round-5 NS snapshots carry one shared
    lead-in counter per slot ((K,)) where the state now holds per-item
    counters ((K, ch)) — failover restore across the upgrade must
    broadcast, not refuse (ops.ns accepts the same legacy states)."""
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        effects=(EffectConfig("noise_suppression", {"nfft": 320}),),
        sample_rate=SR, normalize=None,
    )
    K = 2
    srcs = _voices(rng, K, seconds=0.8)
    pool = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    # ONE read size throughout: each distinct (config, k) pool program
    # is a fresh compile
    pool.read(8)
    p = tmp_path / "st.npz"
    pool.save_state(p)
    expect = pool.read(8)
    # rewrite the snapshot into the pre-round-5 layout: squeeze the
    # per-item NS counter (K, ch) -> (K,) (all items share the value
    # in a lockstep pool, which is what the old scalar meant)
    z = dict(np.load(p))
    squeezed = 0
    for k, v in z.items():
        if k.startswith("leaf_") and v.dtype == np.int32 and v.ndim == 2:
            z[k] = v[:, 0]
            squeezed += 1
    assert squeezed == 1  # the NS counter leaf
    np.savez(p, **z)
    pool2 = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    pool2.load_state_file(p)
    got = pool2.read(8)
    assert np.array_equal(got, expect)
    # a FLOAT leaf with the wrong shape is still a typed refuse
    z2 = dict(np.load(p))
    for k, v in z2.items():
        if k.startswith("leaf_") and v.dtype != np.int32 and v.ndim >= 2:
            z2[k] = v[..., :1]
            break
    np.savez(p, **z2)
    pool3 = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    with pytest.raises(ConfigError, match="leaf"):
        pool3.load_state_file(p)


def test_pool_ns_late_join_reruns_leadin(rng):
    """Round-4 verdict directive 6: a slot joined AFTER the pool has
    advanced past the NS noise lead-in must re-run its own lead-in
    (per-slot state reset on join restores the per-slot counter) —
    its output must match a fresh independent session, not silently
    no-op against a zero noise estimate."""
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        effects=(EffectConfig("noise_suppression", {"nfft": 320}),),
        sample_rate=SR, normalize=None,
    )
    K = 2
    srcs = _voices(rng, K, seconds=0.8)
    pool = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    pool.leave(1)
    # advance well past the lead-in (noise_frames=8 STFT frames; each
    # 20 ms frame at 16 k = 2 STFT frames -> 8 reads = 16 frames)
    pool.read(8)
    pool.join(1, srcs[1])
    got = pool.read(8)
    sess = StreamSession(cfg, frame_ms=20.0, sources=srcs[1])
    ref = sess.read_many(8)
    g = got[1].astype(np.float64) / 32768.0
    r = ref.astype(np.float64) / 32768.0
    assert rms_db(g - r, r + 1e-12) <= -80.0


def test_pool_effects_backend_knob(rng):
    """effects_backend: "scan" (default) == explicit scan; bogus values
    raise typed ConfigError at construction; "gpu_interpret" (the card's
    engine, envelope kernel inside the vmapped step) builds and reads
    within the f32 budget of the f64 scans."""
    K = 2
    srcs = _voices(rng, K, seconds=0.3)
    ref = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs).read(2)
    got = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs,
                      effects_backend="scan").read(2)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ConfigError, match="effects_backend"):
        SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs,
                    effects_backend="cuda")
    pk = SessionPool(_cfg(), K, frame_ms=20.0, sources=srcs,
                     effects_backend="gpu_interpret")
    out = pk.read(2)
    assert out.shape == ref.shape
    db = rms_db(out.astype(np.float64) - ref.astype(np.float64),
                ref.astype(np.float64))
    assert db <= -60.0, db  # f32 kernels vs f64 scans on 2 frames
