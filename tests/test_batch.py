"""M5 tests: masked ragged batch step + batch runner (config 4,
BASELINE.json:10). Runs the card's engine on the CPU with its kernel
interpreted (engine "gpu_interpret").
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import xmtpu  # noqa: F401
from xmtpu import batch as xbatch
from xmtpu.io.wav import write_wav, read_wav
from xmtpu.runner import ClipJob, run_batch

from .conftest import rms_db

SR_IN = 44100
SR_BUS = 16000


def _clips(rng, lengths):
    return [
        (rng.standard_normal(n) * 9000).astype(np.int16) for n in lengths
    ]


def test_masked_batch_matches_unbatched(rng):
    """Each ragged clip in a padded batch == the same clip run alone
    (SURVEY.md §7.3 ragged rule)."""
    lengths = [30000, 44100, 12345]
    clips = _clips(rng, lengths)
    n_pad = max(lengths)
    B = len(clips)
    voice = np.zeros((B, n_pad), np.int16)
    for i, c in enumerate(clips):
        voice[i, : len(c)] = c
    bgm = np.zeros_like(voice)
    step = jax.jit(xbatch.make_batch_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                          engine="gpu_interpret"))
    out = np.asarray(step(jnp.asarray(voice), jnp.asarray(bgm),
                          jnp.asarray(lengths, jnp.int32)))
    solo_step = jax.jit(xbatch.make_batch_step(
        sr_in=SR_IN, sr_bus=SR_BUS, engine="gpu_interpret"))  # jit caches per shape
    for i, c in enumerate(clips):
        n = len(c)
        solo = np.asarray(solo_step(
            jnp.asarray(c[None]), jnp.asarray(np.zeros_like(c)[None]),
            jnp.asarray([n], jnp.int32)))[0]
        m = -(-(n * (SR_BUS // 100)) // (SR_IN // 100))  # ceil
        a = out[i, :m].astype(np.float64)
        b = solo[:m].astype(np.float64)
        db = rms_db(a - b, b)
        assert db <= -80.0, (i, db)
        # pad region is silent
        assert np.all(out[i, m:] == 0)


def test_long_clip_length_no_int32_overflow(rng):
    """Regression: lengths * L must not wrap int32 — a 13.4M-sample
    (~304 s @44.1k) length used to produce a negative out_len and an
    all-false mask, silently writing a silent WAV for long podcast
    clips. The padded data here is short; only the length value is
    huge, which is exactly where the old code wrapped. (n_pad reuses
    the 44100 shape already compiled by the suite.)"""
    n_pad = 44100
    voice = (rng.standard_normal((1, n_pad)) * 9000).astype(np.int16)
    bgm = np.zeros_like(voice)
    step = jax.jit(xbatch.make_batch_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                          engine="gpu_interpret"))
    # 13_500_000 * L(=160) = 2.16e9 > 2^31-1: actually crosses the
    # int32 wrap (13_420_000 * 160 = 2.1472e9 did NOT — the original
    # regression value sat 1,773 samples short of the threshold and
    # the test stayed green with the bug reverted; review find)
    assert 13_500_000 * (SR_BUS // 100) > 2**31 - 1
    out = np.asarray(step(jnp.asarray(voice), jnp.asarray(bgm),
                          jnp.asarray([13_500_000], jnp.int32)))
    # out_len >> n_pad, so every produced sample is in-range: non-silent
    assert np.any(out != 0)


def test_batch_runner_end_to_end(tmp_path, rng):
    lengths = [22050, 44100, 30000, 8000]
    jobs = []
    for i, c in enumerate(_clips(rng, lengths)):
        p = tmp_path / f"in_{i}.wav"
        write_wav(str(p), c, SR_IN)
        jobs.append(ClipJob(voice=str(p), out=str(tmp_path / f"out_{i}.wav")))
    rep = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                    step_kw={"engine": "gpu_interpret"})
    assert rep.done == 4 and not rep.failed
    assert rep.audio_sec > 0 and rep.realtime_factor > 0
    for i, n in enumerate(lengths):
        pcm, sr = read_wav(str(tmp_path / f"out_{i}.wav"))
        assert sr == SR_BUS
        assert pcm.shape[0] == -(-(n * 160) // 441)  # ceil(n*L/M)


def test_batch_runner_failure_isolation_and_resume(tmp_path, rng):
    good = _clips(rng, [16000, 20000])
    p0 = tmp_path / "g0.wav"
    p1 = tmp_path / "g1.wav"
    write_wav(str(p0), good[0], SR_IN)
    write_wav(str(p1), good[1], SR_IN)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    jobs = [
        ClipJob(voice=str(p0), out=str(tmp_path / "o0.wav")),
        ClipJob(voice=str(bad), out=str(tmp_path / "obad.wav")),
        ClipJob(voice=str(p1), out=str(tmp_path / "o1.wav")),
    ]
    rep = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS,
                    step_kw={"engine": "gpu_interpret"})
    assert rep.done == 2
    assert len(rep.failed) == 1 and "obad" in rep.failed[0][0]
    # resume: done clips skipped, bad retried (and fails again)
    rep2 = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS,
                     step_kw={"engine": "gpu_interpret"})
    assert rep2.skipped_resume == 2 and rep2.done == 0
    assert len(rep2.failed) == 1


def test_batch_runner_pipeline_equals_serial(tmp_path, rng):
    """The PP mode (decode thread -> SPSC ring -> dispatch -> writer
    thread, SURVEY.md §2.2 PP row) produces byte-identical WAVs to the
    serial mode."""
    lengths = [22050, 44100, 30000]
    jobs_p, jobs_s = [], []
    for i, c in enumerate(_clips(rng, lengths)):
        p = tmp_path / f"in_{i}.wav"
        write_wav(str(p), c, SR_IN)
        jobs_p.append(ClipJob(voice=str(p), out=str(tmp_path / f"p_{i}.wav")))
        jobs_s.append(ClipJob(voice=str(p), out=str(tmp_path / f"s_{i}.wav")))
    rp = run_batch(jobs_p, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                   step_kw={"engine": "gpu_interpret"}, pipeline=True)
    rs = run_batch(jobs_s, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                   step_kw={"engine": "gpu_interpret"}, pipeline=False)
    assert rp.done == rs.done == 3 and not rp.failed and not rs.failed
    for i in range(3):
        a, _ = read_wav(str(tmp_path / f"p_{i}.wav"))
        b, _ = read_wav(str(tmp_path / f"s_{i}.wav"))
        np.testing.assert_array_equal(a, b)


_DT_BASELINE: dict = {}  # decode_threads=1 outputs, computed ONCE for
# both parametrize cases (the duplicate baseline run cost a full
# pipeline pass per case; review find). Fixed local seed: the clips
# must be identical across cases for the cache to be the same audio.


@pytest.mark.parametrize("threads", [2, 4])
def test_batch_runner_decode_threads_identical_and_isolated(
        tmp_path, threads):
    """Threaded decode drains results in manifest order through the
    SPSC ring, so bucket packing and output WAVs are byte-identical to
    decode_threads=1; a corrupt clip still fails alone. threads=2 with
    6 jobs exercises the bounded-window mid-loop drain (window 2N=4);
    threads=4 exercises the end-of-stream drain only."""
    lengths = [22050, 44100, 30000, 16000, 20000]
    local = np.random.default_rng(20260819)
    clips = _clips(local, lengths)
    jobs = []
    for i, c in enumerate(clips):
        p = tmp_path / f"in_{i}.wav"
        write_wav(str(p), c, SR_IN)
        jobs.append(ClipJob(voice=str(p), out=str(tmp_path / f"b_{i}.wav")))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFgarbage")
    jobs.insert(2, ClipJob(voice=str(bad), out=str(tmp_path / "b_bad.wav")))
    if "outs" not in _DT_BASELINE:
        jobs_1 = [ClipJob(voice=j.voice, out=str(tmp_path / f"a_{i}.wav"))
                  for i, j in enumerate(jobs)]
        r1 = run_batch(jobs_1, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                       step_kw={"engine": "gpu_interpret"}, decode_threads=1)
        assert r1.done == 5 and len(r1.failed) == 1
        _DT_BASELINE["outs"] = [
            read_wav(str(tmp_path / f"a_{i}.wav"))[0]
            for i in (0, 1, 3, 4, 5)]  # index 2 is the bad clip
    r4 = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                   step_kw={"engine": "gpu_interpret"}, decode_threads=threads)
    assert r4.done == 5
    assert len(r4.failed) == 1 and "b_bad" in r4.failed[0][0]
    got = [read_wav(str(tmp_path / f"b_{i}.wav"))[0] for i in range(5)]
    for a, b in zip(_DT_BASELINE["outs"], got):
        np.testing.assert_array_equal(a, b)


def test_batch_report_peak_hbm_field(tmp_path, rng):
    # SURVEY.md §5 metrics row: the report carries a peak-device-memory
    # reading — an int where the backend reports (GPU), None on XLA:CPU
    # — and to_json always includes the key.
    p = tmp_path / "v.wav"
    write_wav(str(p), _clips(rng, [16000])[0], SR_IN)
    rep = run_batch([ClipJob(voice=str(p), out=str(tmp_path / "o.wav"))],
                    sr_in=SR_IN, sr_bus=SR_BUS, step_kw={"engine": "gpu_interpret"})
    import json

    import jax

    if jax.devices()[0].platform == "cpu":
        # XLA:CPU reports no memory stats — the field must be None, not
        # garbage
        assert rep.peak_hbm_bytes is None
    else:
        # the field is BEST-EFFORT (runner._peak_hbm_bytes docstring)
        assert rep.peak_hbm_bytes is None or rep.peak_hbm_bytes > 0
    assert "peak_hbm_bytes" in json.loads(rep.to_json())


def test_flagship_oversize_ir_typed_refuse(rng):
    """An engine the platform cannot run is refused TYPED at build time
    (a ConfigError naming the way out), not at the first step: on the
    CPU, the card's engine with a compiled kernel. An unknown engine
    name is refused the same way."""
    import jax

    from xmtpu.utils.errors import ConfigError

    if jax.default_backend() == "cpu":
        with pytest.raises(ConfigError, match="gpu_interpret"):
            xbatch.make_flagship_step(ir_seconds=2.5, engine="gpu")
    with pytest.raises(ConfigError, match="unknown engine"):
        xbatch.make_flagship_step(ir_seconds=2.5, engine="pallas")


def test_config6_file_batch_smoke():
    # the aux file-fed bench row runs end-to-end (decode->device->write)
    # and reports a positive wall-clock rate; WAV fallback keeps it
    # meaningful without the FFmpeg shim
    from xmtpu import benchmarks

    r = benchmarks.config6_file_batch(n_clips=2, seconds=0.5,
                                      step_kw={"engine": "gpu_interpret"})
    assert r["config"] == 6 and r["audio_sec_per_sec"] > 0


def test_batch_runner_rejects_bad_decode_threads(tmp_path):
    from xmtpu.utils.errors import ConfigError

    with pytest.raises(ConfigError, match="decode_threads"):
        run_batch([], decode_threads=0)


def test_batch_runner_rejects_nonpath_out_and_bad_bus_rate(tmp_path, rng):
    from xmtpu.utils.errors import ConfigError

    p = tmp_path / "v.wav"
    write_wav(str(p), _clips(rng, [16000])[0], SR_IN)
    # a non-path 'out' used to crash the run with a raw TypeError at
    # the resume probe (or write a file named by its repr)
    with pytest.raises(ConfigError, match="'out' must be a path"):
        run_batch([{"voice": str(p), "out": 3}])
    # whole-run rates fail typed BEFORE any decode: negative/zero rates
    # used to reach filter design; a huge bus-side ratio used to stall
    # the compiler (the old check bounded only the clip side)
    for bad in (0, -16000, 8_388_608):
        with pytest.raises(ConfigError, match="unreasonable"):
            run_batch([{"voice": str(p), "out": str(tmp_path / "o.wav")}],
                      sr_bus=bad)
    with pytest.raises(ConfigError, match="unreasonable"):
        run_batch([], sr_in=44101, sr_bus=16000)  # 44101-phase bank


def test_batch_runner_producer_crash_accounted(tmp_path, rng, monkeypatch):
    """A producer-stage crash OUTSIDE the per-clip decode isolation
    (chan.put failing) must mark the undelivered jobs failed — it used
    to close the channel cleanly and report success with jobs missing
    (review find)."""
    from xmtpu import native as native_mod

    p = tmp_path / "v.wav"
    write_wav(str(p), _clips(rng, [16000])[0], SR_IN)
    jobs = [ClipJob(voice=str(p), out=str(tmp_path / f"o{i}.wav"))
            for i in range(3)]
    calls = {"n": 0}
    real_put = native_mod.PcmChannel.put

    def boom(self, arrays, meta):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise MemoryError("simulated publish failure")
        return real_put(self, arrays, meta)

    monkeypatch.setattr(native_mod.PcmChannel, "put", boom)
    rep = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS,
                    step_kw={"engine": "gpu_interpret"}, resume=False)
    # job 0 published (may complete); jobs 1-2 must surface as failures
    assert rep.total == 3 and len(rep.failed) == 2
    assert all("decode stage failed" in msg for _, msg in rep.failed)


def test_batch_runner_with_bgm(tmp_path, rng):
    v = _clips(rng, [30000])[0]
    t = np.arange(11025) / SR_IN
    b = (np.sin(2 * np.pi * 220 * t) * 8000).astype(np.int16)
    pv = tmp_path / "v.wav"
    pb = tmp_path / "b.wav"
    write_wav(str(pv), v, SR_IN)
    write_wav(str(pb), b, SR_IN)
    rep = run_batch(
        [ClipJob(voice=str(pv), bgm=str(pb), out=str(tmp_path / "o.wav"))],
        sr_in=SR_IN, sr_bus=SR_BUS, step_kw={"engine": "gpu_interpret"},
    )
    assert rep.done == 1
    pcm, _ = read_wav(str(tmp_path / "o.wav"))
    assert np.max(np.abs(pcm)) > 1000  # non-silent mix


def test_batch_runner_mixed_rates(tmp_path, rng):
    """Clips at different native rates bucket by rate and all succeed."""
    c44 = _clips(rng, [22050])[0]
    c22 = (rng.standard_normal(11025) * 9000).astype(np.int16)
    p44 = tmp_path / "a44.wav"
    p22 = tmp_path / "a22.wav"
    write_wav(str(p44), c44, 44100)
    write_wav(str(p22), c22, 22050)
    rep = run_batch(
        [
            ClipJob(voice=str(p44), out=str(tmp_path / "o44.wav")),
            ClipJob(voice=str(p22), out=str(tmp_path / "o22.wav")),
        ],
        sr_in=44100, sr_bus=SR_BUS, step_kw={"engine": "gpu_interpret"},
    )
    assert rep.done == 2 and not rep.failed
    assert rep.buckets == 2  # one per rate
    for name, n, rate in (("o44.wav", 22050, 44100), ("o22.wav", 11025, 22050)):
        pcm, sr = read_wav(str(tmp_path / name))
        assert sr == SR_BUS
        g = np.gcd(rate, SR_BUS)
        assert pcm.shape[0] == -(-(n * (SR_BUS // g)) // (rate // g))


def test_batch_runner_rejects_unreasonable_rate(tmp_path, rng):
    """A coprime/corrupt header rate fails that clip only (SURVEY.md §5)."""
    good = _clips(rng, [16000])[0]
    pg = tmp_path / "g.wav"
    write_wav(str(pg), good, SR_IN)
    weird = tmp_path / "weird.wav"
    write_wav(str(weird), good, 44123)  # coprime with 16000
    rep = run_batch(
        [
            ClipJob(voice=str(pg), out=str(tmp_path / "og.wav")),
            ClipJob(voice=str(weird), out=str(tmp_path / "ow.wav")),
        ],
        sr_in=SR_IN, sr_bus=SR_BUS, step_kw={"engine": "gpu_interpret"},
    )
    assert rep.done == 1
    assert len(rep.failed) == 1 and "unreasonable" in rep.failed[0][1]


def test_batch_step_zero_fade_no_nan(rng):
    """Regression: fade_ms=0 must not 0/0-NaN the normalize."""
    c = (rng.standard_normal(20000) * 9000).astype(np.int16)
    step = jax.jit(xbatch.make_batch_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                          fade_ms=0.0, engine="gpu_interpret"))
    out = np.asarray(step(jnp.asarray(c[None]),
                          jnp.asarray(np.zeros_like(c)[None]),
                          jnp.asarray([15000], jnp.int32)))
    assert np.all(np.isfinite(out)) and np.max(np.abs(out)) > 1000


def test_batch_output_length_is_ceil(rng):
    """Regression: out_len must be ceil(n*L/M) — the last sample of a
    clip whose length isn't a multiple of M/gcd must survive."""
    n = 44101  # 44101*160/441 = 16000.36 -> ceil 16001
    c = (rng.standard_normal(n) * 9000).astype(np.int16)
    step = jax.jit(xbatch.make_batch_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                          engine="gpu_interpret"))
    out = np.asarray(step(jnp.asarray(c[None]),
                          jnp.asarray(np.zeros_like(c)[None]),
                          jnp.asarray([n], jnp.int32)))
    m = -(-(n * 160) // 441)
    assert m == 16001
    assert np.any(out[0, m - 3 : m] != 0)  # tail samples survive
    assert np.all(out[0, m:] == 0)


def test_large_batch_fused_path_matches_solo(rng):
    """A 128-row batch (envelope kernel segments picked for 128 rows)
    must match the same clip run alone (segments picked for one row)
    within the f32 rounding budget."""
    n = 22050
    clip = (rng.standard_normal(n) * 9000).astype(np.int16)
    voice = np.broadcast_to(clip, (128, n)).copy()
    bgm = np.zeros_like(voice)
    lengths = np.full(128, n, np.int32)
    step = jax.jit(xbatch.make_batch_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                          engine="gpu_interpret"))
    out = np.asarray(step(jnp.asarray(voice), jnp.asarray(bgm),
                          jnp.asarray(lengths)))
    solo_step = jax.jit(xbatch.make_batch_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                               engine="gpu_interpret"))
    solo = np.asarray(solo_step(jnp.asarray(clip[None]),
                                jnp.asarray(np.zeros_like(clip)[None]),
                                jnp.asarray([n], jnp.int32)))[0]
    m = -(-(n * (SR_BUS // 100)) // (SR_IN // 100))
    a = out[0, :m].astype(np.float64)
    b = solo[:m].astype(np.float64)
    db = rms_db(a - b, b)
    assert db <= -80.0, db
    # identical rows agree to the last bit-or-one: the reverb's
    # two-for-one complex packing rounds real-lane and imag-lane rows
    # differently (rr-ii vs ri+ir), so allow 1 int16 LSB
    assert np.max(np.abs(out.astype(np.int32) - out[0].astype(np.int32))) <= 1


def test_flagship_long_ir_block_scales(rng):
    """ir_seconds past the 32768 floor must build and run: the
    overlap-save block scales with the IR (``ops.reverb.os_block``) and
    has no upper cap on the XLA reverb."""
    from xmtpu.ops.reverb import os_block

    assert os_block(4000) == 32768
    assert os_block(16800) >= 4 * 16799
    assert os_block(10000) == 65536
    assert os_block(32769) == 131072
    assert os_block(40000) == 262144
    step = jax.jit(xbatch.make_flagship_step(ir_seconds=1.05,
                                             engine="gpu_interpret"))
    v = (rng.standard_normal((2, 44100)) * 8000).astype(np.int16)
    out = np.asarray(step(jnp.asarray(v), jnp.asarray(v)))
    assert out.shape[-1] == 16000 and np.abs(out).max() > 0


def test_flagship_mixfirst_backend_parity(rng):
    """The framed mixfirst front (int16 framed before the convert+mix,
    aligned banded resample) equals mixing first and running the
    generic polyphase resample."""
    from xmtpu.ops import convert, resample

    v = (rng.standard_normal((2, 44100)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 44100)) * 6000).astype(np.int16)
    assert resample.aligned_supported(44100, SR_IN, SR_BUS)
    got = np.asarray(jax.jit(lambda v, b: xbatch._front_mixfirst(
        v, b, SR_IN, SR_BUS, 0.4))(jnp.asarray(v), jnp.asarray(b)))
    m = convert.pcm16_to_f32(jnp.asarray(v)) \
        + jnp.float32(0.4) * convert.pcm16_to_f32(jnp.asarray(b))
    ref = np.asarray(resample.polyphase_resample(m, SR_IN, SR_BUS,
                                                 method="window"))
    assert got.shape == ref.shape
    assert rms_db(got.astype(np.float64) - ref, ref) < -120


@pytest.mark.parametrize("engine,lti_fold", [
    ("xla", True), ("gpu_interpret", True), ("gpu_interpret", False)])
def test_flagship_engines_match_oracle(rng, engine, lti_fold):
    """Both engines, and the card's engine with and without the LTI
    fold, match the float64 host oracle at the -80 dB gate."""
    v = (rng.standard_normal((2, 22050)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 22050)) * 6000).astype(np.int16)
    y = np.asarray(jax.jit(xbatch.make_flagship_step(
        sr_in=SR_IN, sr_bus=SR_BUS, engine=engine, lti_fold=lti_fold))(
        jnp.asarray(v), jnp.asarray(b)))
    ref = xbatch.flagship_oracle_np(v[1], b[1], sr_in=SR_IN, sr_bus=SR_BUS)
    db = rms_db((y[1] - ref).astype(np.float64) / 32768.0,
                ref.astype(np.float64) / 32768.0)
    assert db <= -80.0, db


def test_flagship_oracle_np_parity(rng):
    """The pure-host f64 oracle (batch.flagship_oracle_np — the
    reference bench.py reports accuracy_db against) agrees with the
    production chain at the -80 dB gate on BOTH clips of a batch."""
    v = (rng.standard_normal((2, 44100)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 44100)) * 6000).astype(np.int16)
    y = np.asarray(jax.jit(xbatch.make_flagship_step(
        sr_in=SR_IN, sr_bus=SR_BUS, engine="gpu_interpret"))(
        jnp.asarray(v), jnp.asarray(b)))
    ref = xbatch.flagship_oracle_np(v, b, sr_in=SR_IN, sr_bus=SR_BUS)
    assert y.shape == ref.shape
    for i in range(2):
        db = rms_db((y[i] - ref[i]).astype(np.float64) / 32768.0,
                    ref[i].astype(np.float64) / 32768.0)
        assert db <= -80.0, (i, db)


def test_bench_json_contract_has_accuracy(rng):
    """bench.py's JSON line must carry accuracy_db alongside throughput
    (driver artifact contract — an end-to-end precision regression must
    not ship invisibly). Tiny shape; same program family as entry()."""
    import bench

    res = bench.main(batch=2, clip_seconds=1.0, iters=1)
    assert set(res) >= {"metric", "value", "unit", "vs_baseline",
                        "accuracy_db"}
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert res["accuracy_db"] <= -80.0, res


def test_batch_runner_bad_out_path_isolated(tmp_path, rng):
    """One unwritable output path fails ONLY that job — recorded in
    report.failed, other jobs written, no writer-thread hang (round-2
    review find: the pipelined writer died outside its try/except)."""
    clips = _clips(rng, [22050, 30000])
    jobs = []
    for i, c in enumerate(clips):
        p = tmp_path / f"in_{i}.wav"
        write_wav(str(p), c, SR_IN)
        out = (str(tmp_path / "no_such_dir" / "x.wav") if i == 0
               else str(tmp_path / f"ok_{i}.wav"))
        jobs.append(ClipJob(voice=str(p), out=out))
    import os
    for pipeline in (False, True):
        for j in jobs:
            for f in (j.out, j.out + ".done"):
                try:
                    os.remove(f)
                except OSError:
                    pass
        rep = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                        step_kw={"engine": "gpu_interpret"}, pipeline=pipeline)
        assert rep.done == 1 and len(rep.failed) == 1, (pipeline, rep)
        assert read_wav(str(tmp_path / "ok_1.wav"))[0].size > 0


def test_batch_runner_step_kw_with_bands(tmp_path, rng):
    """A bands LIST in step_kw is a legal make_batch_step kwarg; the
    step cache key must hash it (round-2 review find)."""
    c = _clips(rng, [22050])[0]
    p = tmp_path / "in.wav"
    write_wav(str(p), c, SR_IN)
    jobs = [ClipJob(voice=str(p), out=str(tmp_path / "o.wav"))]
    rep = run_batch(
        jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=1,
        step_kw={"engine": "gpu_interpret",
                 "bands": [{"freq_hz": 300.0, "gain_db": 3.0, "q": 1.0}]})
    assert rep.done == 1 and not rep.failed


def test_load_mono_i16_downmix_consistent(rng):
    """Stereo int16 and float downmix identically (channel mean)."""
    from xmtpu.runner import _load_mono_i16

    st = (rng.standard_normal((1000, 2)) * 8000).astype(np.int16)
    a, _ = _load_mono_i16((st, SR_IN), SR_IN)
    b, _ = _load_mono_i16((st.astype(np.float32) / 32768.0, SR_IN), SR_IN)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_run_batch_malformed_manifest_raises_config_error():
    """Fuzz find: a malformed manifest entry died with a bare TypeError
    from the ClipJob dataclass call. A bad MANIFEST (vs a bad clip)
    fails the whole run with a typed ConfigError naming the entry."""
    from xmtpu.runner import run_batch
    from xmtpu.utils.errors import ConfigError

    with pytest.raises(ConfigError, match="list"):
        run_batch("not a list")
    with pytest.raises(ConfigError, match="voice"):
        run_batch([{"out": "/tmp/x.wav"}])
    with pytest.raises(ConfigError, match="voice"):
        run_batch(["a string"])
    with pytest.raises(ConfigError, match="unknown key"):
        run_batch([{"voice": "v.wav", "out": "o.wav", "vioce": "typo"}])


def test_run_batch_accepts_generators_and_deques(tmp_path, rng):
    """Second review pass: the manifest type guard must not reject
    previously-working sized/unsized iterables (generator, deque)."""
    import collections

    c = _clips(rng, [16000])[0]
    p = tmp_path / "v.wav"
    write_wav(str(p), c, SR_IN)
    rep = run_batch(
        (j for j in [ClipJob(voice=str(p), out=str(tmp_path / "g.wav"))]),
        sr_in=SR_IN, sr_bus=SR_BUS, step_kw={"engine": "gpu_interpret"})
    assert rep.done == 1
    rep2 = run_batch(
        collections.deque([ClipJob(voice=str(p),
                                   out=str(tmp_path / "d.wav"))]),
        sr_in=SR_IN, sr_bus=SR_BUS, step_kw={"engine": "gpu_interpret"})
    assert rep2.done == 1


def test_pipelined_writer_stage_crash_does_not_hang(tmp_path, rng, monkeypatch):
    """An unexpected exception OUTSIDE _write_chunk's per-job isolation
    must not kill the writer thread and deadlock the bounded queue —
    the run must finish with every job in report.failed (review find)."""
    from xmtpu import runner as _runner

    clips = _clips(rng, [22050, 30000, 15000])
    jobs = []
    for i, c in enumerate(clips):
        p = tmp_path / f"in_{i}.wav"
        write_wav(str(p), c, SR_IN)
        jobs.append(ClipJob(voice=str(p), out=str(tmp_path / f"o_{i}.wav")))

    def boom(*a, **kw):
        raise RuntimeError("synthetic write-stage failure")

    monkeypatch.setattr(_runner, "_write_chunk", boom)
    rep = run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                    step_kw={"engine": "gpu_interpret"}, pipeline=True)
    assert rep.done == 0 and len(rep.failed) == 3
    assert all("write stage failed" in msg for _, msg in rep.failed)
