"""PoolServer: heterogeneous-config serving over SessionPool buckets.

Reference usage model: one process, many independent xm_audio_utils
handles, each with its OWN config (SURVEY.md §3.2). Tests share server
fixtures and keep configs effect-free + sources at the bus rate so the
pool step programs stay tiny (each distinct program is a fresh
compile).
"""

from __future__ import annotations

import numpy as np
import pytest

import xmtpu  # noqa: F401
from xmtpu import PoolServer
from xmtpu.config.schema import PipelineConfig, TrackConfig
from xmtpu.graph.streaming import StreamSession
from xmtpu.utils.errors import ConfigError, XmtpuError

from .conftest import rms_db

SR = 16000


def _cfg(volume: float = 1.0) -> PipelineConfig:
    return PipelineConfig(
        tracks=(TrackConfig(url="v", volume=volume, fade_in_ms=30.0),),
        sample_rate=SR, normalize=None,
    )


def _src(rng, seconds: float = 0.5) -> dict:
    # clip to ±0.9 full scale: 0.3·σ noise crosses ±1.0 about once per
    # 1.2k samples, and a clipped-at-i16 sample breaks the
    # volume-linearity assertion below by ~1000 LSBs (the session-scoped
    # rng makes which draws land here depend on suite order — this
    # failed at −59.9 dB in one full-suite ordering, −85.9 standalone)
    pcm = (0.3 * rng.standard_normal(int(SR * seconds))).astype(np.float32)
    return {"v": (pcm.clip(-0.9, 0.9), SR)}


@pytest.fixture(scope="module")
def server():
    # ONE shared server -> most tests reuse one compiled pool step
    return PoolServer(n_slots=2, frame_ms=20.0, max_seconds=1.0)


def test_read_matches_independent_session(server, rng):
    srcs = [_src(rng), _src(rng)]
    sids = [server.open(_cfg(), s) for s in srcs]
    sess = StreamSession(_cfg(), frame_ms=20.0, sources=srcs[1])
    got = server.read(sids[1], 4)
    ref = np.concatenate([sess.read() for _ in range(4)], axis=0)
    assert got.shape == ref.shape
    assert rms_db(got.astype(np.float64) - ref, ref + 1e-12) <= -80.0
    # sid 0 advanced in the same groups: its frames are buffered, and
    # draining them costs no further pool advance
    s0 = server._sessions[sids[0]]
    fi_before = int(s0.pool._frame_idx[s0.slot])
    got0 = server.read(sids[0], 4)
    assert got0.shape == ref.shape and np.any(got0 != 0)
    assert int(s0.pool._frame_idx[s0.slot]) == fi_before
    for sid in sids:
        server.close(sid)


def test_pump_drains_every_session(server, rng):
    sids = [server.open(_cfg(), _src(rng)) for _ in range(2)]
    out = server.pump(2)
    assert set(out) == set(sids)
    for sid in sids:
        assert out[sid].shape[0] == 2 * server._sessions[sid].pool.frame_out
        assert np.any(out[sid] != 0)
    assert server.pump(1).keys() == set(sids)  # cadence continues
    for sid in sids:
        server.close(sid)
    assert server.pump(1) == {}  # nothing open -> nothing produced


def test_eos_short_tail_then_none(server, rng):
    # 0.205 s at 20 ms frames = 10 frames + a 5 ms tail frame
    sid = server.open(_cfg(), _src(rng, seconds=0.205))
    got = server.read(sid, 64)  # asks past the end: returns what exists
    assert got.shape[0] == 11 * server._sessions[sid].pool.frame_out
    assert server.at_end(sid)
    assert server.read(sid) is None  # reference get_frame <= 0 analogue
    server.close(sid)


def test_seek_drops_stale_buffer(server, rng):
    src = _src(rng)
    sids = [server.open(_cfg(), src), server.open(_cfg(), _src(rng))]
    server.read(sids[1], 3)  # sid 0 now has 3 stale frames buffered
    server.seek(sids[0], 0.0)
    assert server.stats()["buffered_frames"][sids[0]] == 0
    sess = StreamSession(_cfg(), frame_ms=20.0, sources=src)
    got = server.read(sids[0], 2)
    ref = np.concatenate([sess.read() for _ in range(2)], axis=0)
    assert rms_db(got.astype(np.float64) - ref, ref + 1e-12) <= -80.0
    for sid in sids:
        server.close(sid)


def test_close_frees_slot_for_reuse(server, rng):
    a = server.open(_cfg(), _src(rng))
    b = server.open(_cfg(), _src(rng))
    pools_before = server.stats()["pools"]
    server.close(a)
    c = server.open(_cfg(), _src(rng))  # reuses a's slot, no new pool
    assert server.stats()["pools"] == pools_before
    assert np.any(server.read(c, 1) != 0)
    with pytest.raises(XmtpuError, match="unknown session"):
        server.read(a)
    server.close(b)
    server.close(c)


def test_per_client_files_share_one_pool(server, rng):
    # THE serving shape: same pipeline, each client its own audio. The
    # step program never reads the url, so these must ride ONE pool
    # (urls used to be part of the bucket key: every client founded its
    # own K-slot pool and compiled a fresh step)
    cfg_w = PipelineConfig(
        tracks=(TrackConfig(url="w", volume=1.0, fade_in_ms=30.0),),
        sample_rate=SR, normalize=None,
    )
    src_w = {"w": ((0.3 * rng.standard_normal(SR // 2))
                   .astype(np.float32), SR)}
    a = server.open(_cfg(), _src(rng))
    pools_before = server.stats()["pools"]
    b = server.open(cfg_w, src_w)  # different url, same pipeline
    assert server.stats()["pools"] == pools_before
    sa, sb = server._sessions[a], server._sessions[b]
    assert sa.pool is sb.pool
    # and the joiner's audio was re-keyed correctly: b's output matches
    # an independent session over ITS OWN source
    got = server.read(b, 3)
    sess = StreamSession(cfg_w, frame_ms=20.0, sources=src_w)
    ref = np.concatenate([sess.read() for _ in range(3)], axis=0)
    assert rms_db(got.astype(np.float64) - ref, ref + 1e-12) <= -80.0
    server.close(a)
    server.close(b)


def test_heterogeneous_configs_bucket_separately(server, rng):
    src = _src(rng)
    a = server.open(_cfg(volume=1.0), src)
    b = server.open(_cfg(volume=0.5), src)  # different step program
    st = server.stats()
    assert st["buckets"] >= 2
    ga = server.read(a, 2).astype(np.float64)
    gb = server.read(b, 2).astype(np.float64)
    # same audio through both: the 0.5x config is ~6 dB down, not equal
    assert rms_db(gb - 0.5 * ga, ga + 1e-12) <= -80.0
    server.close(a)
    server.close(b)
    # released bucket machinery can be dropped once idle
    assert server.release_idle_pools() >= 1


def test_pool_growth_capacity_and_laggard(rng):
    srv = PoolServer(n_slots=1, frame_ms=20.0, max_buffer_frames=2)
    a = srv.open(_cfg(), _src(rng, seconds=0.3))
    b = srv.open(_cfg(), _src(rng, seconds=0.3))  # pool full -> grow
    assert srv.stats()["pools"] == 2
    srv.close(a)  # pool 1 now has a free slot sized for 0.3 s clips
    # a clip beyond that capacity must fall through the join refusal
    # (validated before mutation) and found a correctly-sized pool
    c = srv.open(_cfg(), _src(rng, seconds=0.9))
    assert srv.stats()["pools"] == 3
    assert np.any(srv.read(c, 1) != 0)
    srv.close(b)
    srv.close(c)
    # laggard refusal: n_slots=1 pools never co-buffer, so grow one
    # pool to 2 sessions via the shared-bucket path
    srv2 = PoolServer(n_slots=2, frame_ms=20.0, max_buffer_frames=2)
    x = srv2.open(_cfg(), _src(rng))
    y = srv2.open(_cfg(), _src(rng))
    srv2.read(x, 2)  # y now holds 2 unread frames == the cap
    with pytest.raises(XmtpuError, match="unread frames"):
        srv2.read(x, 1)
    srv2.read(y, 2)  # draining the laggard unblocks the pool
    assert np.any(srv2.read(x, 1) != 0)


def test_duplicate_file_urls_without_overrides(server, rng, tmp_path,
                                               monkeypatch):
    # two tracks sharing one file url, NO sources dict: sources are
    # keyed by url, so one decoded entry must serve both tracks (the
    # old fallback handed the pool sources=None and refused with
    # "needs sources for slot 0") — and the file must be DECODED once,
    # not once per track (open()'s own docstring; host decode is the
    # 1-core bottleneck in this env)
    from xmtpu.graph import pipeline as _pl
    from xmtpu.io import write_wav

    p = str(tmp_path / "bed.wav")
    write_wav(p, (6000 * rng.standard_normal(SR // 2))
              .clip(-32768, 32767).astype(np.int16), SR)
    cfg = PipelineConfig(
        tracks=(TrackConfig(url=p, volume=0.5),
                TrackConfig(url=p, volume=0.5)),
        sample_rate=SR, normalize=None,
    )
    n_decodes = 0
    real_open = _pl.open_audio

    def counting_open(url):
        nonlocal n_decodes
        n_decodes += 1
        return real_open(url)

    monkeypatch.setattr(_pl, "open_audio", counting_open)
    sid = server.open(cfg, None)
    assert n_decodes == 1
    got = server.read(sid, 2)
    assert got is not None and np.any(got != 0)
    server.close(sid)


def test_buffered_frames_do_not_pin_group_buffer(server, rng):
    # a laggard's buffered frames must be views into ITS OWN copied row,
    # not into the whole (K, k*frame, ch) group fetch (K x memory
    # amplification per buffered frame otherwise)
    sids = [server.open(_cfg(), _src(rng)) for _ in range(2)]
    server.read(sids[1], 3)  # sid 0 buffers 3 frames it hasn't read
    s0 = server._sessions[sids[0]]
    f = s0.pool.frame_out
    for frame in s0.frames:
        root = frame.base if frame.base is not None else frame
        # the root buffer is one session's (<=3*f, ch) row copy, not the
        # 3-D (K, 3*f, ch) group fetch
        assert root.ndim == 2
        assert root.nbytes <= 3 * f * frame.shape[1] * frame.itemsize
    for sid in sids:
        server.close(sid)


def test_server_dp_mesh_parity(rng):
    """Sharded serving == single-device serving (SURVEY.md §2.2 DP row
    through the PoolServer front end: every pool it founds rides the
    mesh)."""
    from .test_pool import _dp_mesh

    mesh, ndp = _dp_mesh()
    srcs = [_src(rng) for _ in range(ndp)]
    srv = PoolServer(n_slots=ndp, frame_ms=20.0, mesh=mesh)
    sids = [srv.open(_cfg(), s) for s in srcs]
    assert srv.stats()["pools"] == 1
    for sid, src in zip(sids, srcs):
        got = srv.read(sid, 3).astype(np.float64)
        sess = StreamSession(_cfg(), frame_ms=20.0, sources=src)
        ref = np.concatenate([sess.read() for _ in range(3)], axis=0)
        assert rms_db(got - ref.astype(np.float64), ref + 1e-12) <= -80.0
    with pytest.raises(ConfigError, match="divide evenly"):
        PoolServer(n_slots=ndp + 1, mesh=mesh)
    with pytest.raises(ConfigError, match="no axis"):
        PoolServer(n_slots=ndp, mesh=mesh, mesh_axis="tp")


def test_server_thread_safety_open_close_during_reads(rng):
    """One thread reads its own session while another churns open/
    close/seek — including co-resident slots in the reader's own pool
    and a second bucket. The server lock must keep every read
    consistent: no exceptions, stable shapes, correct bookkeeping."""
    import threading

    srv = PoolServer(n_slots=4, frame_ms=20.0, max_seconds=1.0,
                     max_buffer_frames=4096)
    loop_cfg = PipelineConfig(
        tracks=(TrackConfig(url="v", loop=True),),  # reader never ends
        sample_rate=SR, normalize=None,
    )
    src = _src(rng)
    r = srv.open(loop_cfg, src)
    errs: list = []
    stop = threading.Event()

    def churn():
        try:
            for i in range(20):
                sid = srv.open(loop_cfg, _src(rng))  # reader's pool
                other = srv.open(_cfg(volume=0.5), _src(rng))  # 2nd bucket
                srv.seek(sid, 20.0 * (i % 3))
                srv.close(sid)
                srv.close(other)
        except Exception as e:  # noqa: BLE001 — surface to main thread
            errs.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=churn)
    t.start()
    outs = []
    while not stop.is_set():
        outs.append(srv.read(r, 2))
    t.join()
    assert not errs, errs
    assert all(o.shape == outs[0].shape for o in outs)
    assert any(np.any(o != 0) for o in outs)
    st = srv.stats()
    assert st["sessions"] == 1  # every churned session closed cleanly
    srv.close(r)


def test_open_rejects_bad_inputs(server):
    with pytest.raises(ConfigError, match="no tracks"):
        server.open(PipelineConfig(sample_rate=SR), None)
    with pytest.raises(ConfigError, match="PipelineConfig or dict"):
        server.open("nonsense", None)
    with pytest.raises(XmtpuError, match="unknown session"):
        server.seek(10**9, 0.0)
    with pytest.raises(ConfigError, match="max_buffer_frames"):
        server.read(0, k=10**6)  # k-guard fires before the sid lookup
    with pytest.raises(ConfigError, match="max_buffer_frames"):
        server.pump(k=10**6)


def test_read_pumps_power_of_two_group_sizes(rng):
    """Every pool dispatch must use a pow2 group size: each distinct k
    is a distinct compiled scan program, so an 11-frame residual must
    ladder down {8, 2, 1}
    instead of minting a one-off k=11 program."""
    srv = PoolServer(n_slots=2, frame_ms=20.0, max_seconds=1.0)
    sid = srv.open(_cfg(), _src(rng, seconds=0.5))  # 25 frames
    got = srv.read(sid, 11)
    s = srv._sessions[sid]
    assert got.shape[0] == 11 * s.pool.frame_out
    sizes = set(s.pool._scan_steps)
    assert sizes and all(v & (v - 1) == 0 for v in sizes), sizes
    # the end-of-stream tail (14 frames left) ladders too
    tail = srv.read(sid, 1024 if srv.max_buffer_frames >= 1024 else 14)
    assert tail.shape[0] == 14 * s.pool.frame_out
    sizes = set(s.pool._scan_steps)
    assert all(v & (v - 1) == 0 for v in sizes), sizes
    srv.close(sid)


def test_pump_skips_laggard_pool_but_advances_others(rng):
    """One laggard must not break the serving cadence of unrelated
    pools: pump() skips the refused pool, advances the rest, and still
    drains everyone's backlog (which unblocks the laggard's pool)."""
    srv = PoolServer(n_slots=2, frame_ms=20.0, max_buffer_frames=2,
                     max_seconds=1.0)
    lag = srv.open(_cfg(), _src(rng))           # pool A
    a2 = srv.open(_cfg(), _src(rng))            # pool A co-resident
    other = srv.open(_cfg(volume=0.5), _src(rng))  # pool B (own bucket)
    srv.read(a2, 2)  # lag now buffers 2 == the cap; pool A is stuck
    out = srv.pump(1)
    assert other in out            # pool B advanced
    assert lag in out              # the laggard's BACKLOG still drains
    assert a2 not in out           # pool A itself did not advance
    out2 = srv.pump(1)             # drained -> pool A advances again
    assert {lag, a2, other} <= set(out2)
    for sid in (lag, a2, other):
        srv.close(sid)


def test_laggard_refusal_names_the_session(rng):
    srv = PoolServer(n_slots=2, frame_ms=20.0, max_buffer_frames=2,
                     max_seconds=1.0)
    x = srv.open(_cfg(), _src(rng))
    y = srv.open(_cfg(), _src(rng))
    srv.read(x, 2)
    with pytest.raises(XmtpuError, match=f"session {y} "):
        srv.read(x, 1)
    srv.close(x)
    srv.close(y)


def test_pump_costs_no_dispatch_when_all_ended(rng):
    """A pool whose sessions have all reached end-of-stream must not
    pay a device dispatch + blocking fetch per serving period just
    because nobody close()d."""
    srv = PoolServer(n_slots=2, frame_ms=20.0, max_seconds=1.0)
    sid = srv.open(_cfg(), _src(rng, seconds=0.2))  # 10 frames
    while srv.read(sid, 4) is not None:
        pass  # drive to end-of-stream without closing
    s = srv._sessions[sid]
    calls = []
    real_read = s.pool.read
    s.pool.read = lambda k=1: (calls.append(k), real_read(k))[1]
    assert srv.pump(1) == {}
    assert srv.pump(1) == {}
    assert calls == []  # ended pool: planned empty, never dispatched
    del s.pool.read
    srv.close(sid)


def test_open_upload_does_not_block_other_pools(rng):
    """open()'s device source upload (SessionPool construction / join)
    must run outside the server lock: a slow open of one config must
    not stall reads of sessions on unrelated pools."""
    import threading

    from xmtpu.graph import pool as _poolmod

    srv = PoolServer(n_slots=2, frame_ms=20.0, max_seconds=1.0)
    a = srv.open(_cfg(), _src(rng))
    gate = threading.Event()
    entered = threading.Event()
    real_pool = _poolmod.SessionPool

    class SlowPool(real_pool):
        def __init__(self, *args, **kw):
            entered.set()
            assert gate.wait(30.0), "test gate never opened"
            super().__init__(*args, **kw)

    _poolmod.SessionPool = SlowPool
    try:
        t = threading.Thread(
            target=lambda: srv.open(_cfg(volume=0.25), _src(rng)))
        t.start()
        assert entered.wait(30.0)  # the slow ctor is holding open()
        got = srv.read(a, 1)       # must not block behind it
        assert got is not None and got.shape[0] == 1 * (
            srv._sessions[a].pool.frame_out)
    finally:
        gate.set()
        t.join(60.0)
        _poolmod.SessionPool = real_pool
    assert not t.is_alive()
    assert srv.stats()["sessions"] == 2
    srv.close(a)


def test_open_failure_leaves_no_phantom_bucket(rng, monkeypatch):
    """A SessionPool constructor failure must not register an empty
    bucket (repeated failing opens used to accumulate phantom entries
    in stats())."""
    from xmtpu.graph import pool as _poolmod

    srv = PoolServer(n_slots=2, frame_ms=20.0, max_seconds=1.0)

    def boom(*a, **k):
        raise ConfigError("synthetic constructor failure")

    monkeypatch.setattr(_poolmod, "SessionPool", boom)
    for _ in range(3):
        with pytest.raises(ConfigError, match="synthetic"):
            srv.open(_cfg(), _src(rng))
    st = srv.stats()
    assert st["buckets"] == 0 and st["pools"] == 0 and st["sessions"] == 0
