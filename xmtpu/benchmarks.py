"""Benchmark harness: the five BASELINE configs (BASELINE.json:7-11).

Reference analogue: none — the upstream ships no benchmarks
(SURVEY.md §6); these definitions are the driver's config list.

Each config returns {"config", "desc", "audio_sec_per_sec", ...}; the
repo-root ``bench.py`` (driver contract) reports config 4's full-chain
number as the headline metric.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

def _timeit(fn, warmup=1, iters=20):
    """Steady-state seconds per iteration: ``warmup`` calls (compile
    included), then ``iters`` calls timed to ``block_until_ready`` of
    the last result."""
    import jax

    out = None
    for _ in range(warmup):
        out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def config1_resample(batch=32, seconds=10.0):
    """44.1k->16k mono polyphase + i16->f32 (BASELINE.json:7)."""
    import jax
    import jax.numpy as jnp
    from xmtpu.ops import convert, resample

    n = int(44100 * seconds)
    x = (np.random.default_rng(0).standard_normal((batch, n)) * 9000).astype(
        np.int16
    )
    xd = jax.device_put(jnp.asarray(x))

    @jax.jit
    def run(v):
        return resample.polyphase_resample(convert.pcm16_to_f32(v), 44100, 16000)

    dt = _timeit(lambda: run(xd))
    return {"config": 1, "desc": "44.1k->16k polyphase + i16->f32",
            "audio_sec_per_sec": batch * seconds / dt}


def config2_mix(batch=32, seconds=10.0, sr=16000):
    """2-track voice+BGM mix, gain/fade/normalize @16k (BASELINE.json:8)."""
    import jax
    import jax.numpy as jnp
    from xmtpu.ops import mix as mops

    n = int(sr * seconds)
    rng = np.random.default_rng(0)
    v = jnp.asarray((0.3 * rng.standard_normal((batch, n))).astype(np.float32))
    b = jnp.asarray((0.3 * rng.standard_normal((batch, n))).astype(np.float32))
    fade = int(0.25 * sr)

    @jax.jit
    def run(v, b):
        out = mops.apply_gain_fade(v, 0.9, fade, fade, length=n) \
            + mops.apply_gain_fade(b, 0.4, fade, fade, length=n)
        peak = jnp.max(jnp.abs(out), axis=-1, keepdims=True)
        return out * jnp.where(peak > 0, mops.db_to_amp(-1.0) / peak, 1.0)

    dt = _timeit(lambda: run(v, b))
    return {"config": 2, "desc": "2-track mix gain/fade/normalize",
            "audio_sec_per_sec": batch * seconds / dt}


def config3_effects(batch=16, seconds=10.0, sr=48000):
    """5-band EQ + 0.5 s FIR reverb + limiter, stereo 48k (BASELINE.json:9).

    Measures the PUBLIC ``xmtpu.effects()`` entry point (SURVEY.md §3.5
    defines config 3 as the api.effects stack) with the auto engine, so
    the number is what a user gets (``xmtpu.engine``).
    """
    import jax.numpy as jnp
    from xmtpu import effects
    from xmtpu.batch import DEFAULT_BANDS
    from xmtpu.ops import reverb

    n = int(sr * seconds)
    rng = np.random.default_rng(0)
    # public batched layout: (B, n, ch)
    x = jnp.asarray(
        (0.3 * rng.standard_normal((batch, n, 2))).astype(np.float32)
    )
    ir = reverb.synthetic_ir(0.5, sr).astype(np.float32)
    chain = [
        {"name": "equalizer", "params": {"bands": list(DEFAULT_BANDS)}},
        {"name": "reverb", "params": {"ir": ir, "wet": 0.3, "dry": 0.7}},
        {"name": "limiter", "params": {}},
    ]
    run = lambda: effects(x, sr, chain, device_out=True)  # noqa: E731
    dt = _timeit(run)
    return {"config": 3, "desc": "stereo 48k EQ+reverb+limiter "
                                 "(public xmtpu.effects entry)",
            "audio_sec_per_sec": batch * seconds / dt}


def config4_full_chain(batch=32, seconds=10.0):
    """Batched offline pipeline, fused per-block (BASELINE.json:10)."""
    import jax
    import jax.numpy as jnp
    from xmtpu import batch as xbatch

    n = int(44100 * seconds)
    rng = np.random.default_rng(0)
    v = jnp.asarray((rng.standard_normal((batch, n)) * 9000).astype(np.int16))
    b = jnp.asarray((np.sin(np.arange(n) / 50.0)[None].repeat(batch, 0) * 12000
                     ).astype(np.int16))
    step = jax.jit(xbatch.make_flagship_step())
    dt = _timeit(lambda: step(v, b))
    return {"config": 4, "desc": "full chain decode->resample->mix->FX",
            "audio_sec_per_sec": batch * seconds / dt}


def config5_streaming(seconds=4.0):
    """20 ms streaming frames through the full DSP graph (BASELINE.json:11)."""
    from xmtpu.config.schema import EffectConfig, PipelineConfig, TrackConfig
    from xmtpu.graph.streaming import StreamSession

    sr = 16000
    rng = np.random.default_rng(0)
    n_v = int(44100 * seconds)
    voice = (0.3 * rng.standard_normal(n_v)).astype(np.float32)
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        master_effects=(
            EffectConfig("equalizer", {"bands": [
                {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]}),
            EffectConfig("limiter", {}),
        ),
        sample_rate=sr, normalize=None,
    )
    sess = StreamSession(cfg, frame_ms=20.0, sources={"v": (voice, 44100)})
    n_frames = int(seconds * 1000 / 20) - 4
    sess.read()  # compile
    t0 = time.perf_counter()
    for _ in range(n_frames // 2):
        sess.read()
    dt = (time.perf_counter() - t0) / (n_frames // 2)
    # depth-3 dispatch-ahead: three frames in flight with eager
    # device->host copies
    sess_d = StreamSession(cfg, frame_ms=20.0, prefetch_depth=3,
                           sources={"v": (voice, 44100)})
    for _ in range(4):
        sess_d.read()  # compile + fill the 3-deep pipeline
    t0 = time.perf_counter()
    for _ in range(n_frames // 2):
        sess_d.read()
    dt_depth = (time.perf_counter() - t0) / (n_frames // 2)
    # grouped mode: identical 20 ms frame math, ONE lax.scan dispatch and
    # ONE transfer per 25-frame group (warm up with the SAME k: each k
    # compiles once)
    k = 25
    sess.seek(0.0)
    sess.read_many(k)  # compile for this k
    groups = max(1, (n_frames - k) // k)
    t0 = time.perf_counter()
    audio = 0.0
    for _ in range(groups):
        audio += sess.read_many(k).shape[0] / sess.sr
    dt_many = time.perf_counter() - t0

    # serving mode (round-2 VERDICT directive #2): 32 concurrent
    # same-config sessions batched into ONE vmapped step — the
    # reference's many-handles-per-process deployment shape. Aggregate
    # audio-sec/sec across the pool, grouped dispatch (one fetch per
    # K x k group).
    from xmtpu.graph.pool import SessionPool

    K = 32
    n_vp = int(44100 * 8.0)  # cover warmup + measured groups with audio
    srcs = [{"v": ((0.3 * rng.standard_normal(n_vp)).astype(np.float32),
                   44100)} for _ in range(K)]
    pool = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    kp = 50  # 1 s groups: one fetch per K*kp frames
    pool.read(kp)  # compile + fill the prefetch pipeline
    pool.read(kp)
    t0 = time.perf_counter()
    audio_pool = 0.0
    pg = 3
    for _ in range(pg):
        out = pool.read(kp)
        audio_pool += out.shape[0] * out.shape[1] / pool.sr
    dt_pool = time.perf_counter() - t0
    return {"config": 5, "desc": "20 ms streaming frames",
            "audio_sec_per_sec": round(audio / dt_many, 1),
            "pool32_audio_sec_per_sec": round(audio_pool / dt_pool, 1),
            "ms_per_frame_sequential": round(dt * 1e3, 2),
            "ms_per_frame_depth3": round(dt_depth * 1e3, 2),
            "note": "sequential reads pay one device->host fetch per "
                    "frame; pool32 = SessionPool serving mode, 32 "
                    "sessions per dispatch"}


def config6_file_batch(n_clips=64, seconds=10.0, fmt="flac",
                       decode_threads=1, step_kw=None):
    """AUX row (not a BASELINE.json config): FILE-fed batch end-to-end —
    compressed decode (host) -> full chain (device) -> WAV write (host),
    wall-clock INCLUDING all IO. Configs 1-5 measure device-side
    throughput on in-memory PCM; this is the real-workload number (host
    decode bounds it, so the device is idle most of the time here by
    design — the pipeline
    hides device time behind decode, not vice versa).
    Falls back to WAV inputs when the FFmpeg shim is absent.
    """
    import shutil
    import tempfile

    from xmtpu.io import HAVE_FFMPEG, encode_audio, write_wav
    from xmtpu.runner import run_batch

    if fmt != "wav" and not HAVE_FFMPEG:
        fmt = "wav"
    d = tempfile.mkdtemp(prefix="xmtpu_bench6_")
    try:
        rng = np.random.default_rng(0)
        sr = 44100
        n = int(sr * seconds)
        jobs = []
        for i in range(n_clips):
            pcm = (rng.standard_normal(n) * 9000).astype(np.int16)
            p = os.path.join(d, f"in_{i}.{fmt}")
            if fmt == "wav":
                write_wav(p, pcm, sr)
            else:
                encode_audio(p, pcm, sr)
            jobs.append({"voice": p, "out": os.path.join(d, f"out_{i}.wav")})
        # two passes, report the WARM one: the first pays the compile of
        # the bucket program. Same steady-state convention as configs
        # 1-5, which exclude compile via _timeit's warmup dispatch.
        cold = run_batch(jobs, sr_in=sr, sr_bus=16000, resume=False,
                         write_done_markers=False, step_kw=step_kw,
                         decode_threads=decode_threads)
        if cold.failed:
            raise RuntimeError(f"file-batch bench had failures: {cold.failed}")
        rep = run_batch(jobs, sr_in=sr, sr_bus=16000, resume=False,
                        write_done_markers=False, step_kw=step_kw,
                        decode_threads=decode_threads)
        if rep.failed:
            raise RuntimeError(f"file-batch bench had failures: {rep.failed}")
        return {"config": 6,
                "desc": f"file-fed batch ({fmt}, decode->device->write, "
                        f"decode_threads={decode_threads})",
                "audio_sec_per_sec": rep.audio_sec / rep.wall_sec,
                "cold_audio_sec_per_sec": cold.audio_sec / cold.wall_sec}
    finally:
        shutil.rmtree(d, ignore_errors=True)


_CONFIGS = {1: config1_resample, 2: config2_mix, 3: config3_effects,
            4: config4_full_chain, 5: config5_streaming,
            6: config6_file_batch}


def run(config: int | None = None):
    """Run one or all configs; prints a JSON line each (``xmtpu.cli
    bench`` runs each config in its own process, one after another)."""
    results = []
    for k in sorted(_CONFIGS) if config is None else [config]:
        r = _CONFIGS[k]()
        r["audio_sec_per_sec"] = round(r["audio_sec_per_sec"], 1)
        r["x_realtime"] = r["audio_sec_per_sec"]
        print(json.dumps(r))
        results.append(r)
    return results
