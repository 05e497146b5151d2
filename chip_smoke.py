"""End-to-end smoke run of xmtpu on an NVIDIA GPU.

Drives the main paths once at full size through the entry points a user
calls, and checks every result against the repo's float64 numpy
references (``ops.*_np``, ``batch.flagship_oracle_np``), each with its
tolerance stated: -80 dB RMS error for audio (BASELINE.json:2), 0.01 LU
for loudness.

One card (no arguments):

1. device       the card's name and power limit, JAX's devices/versions;
                exits non-zero unless JAX's platform is ``gpu``
2. flagship     ``jit(make_flagship_step())`` on 256 x 10 s int16
                voice+BGM at 44.1 kHz -> 16 kHz (config 4)
3. effects      ``xmtpu.effects()`` on (16, 480000, 2) f32 at 48 kHz:
                5-band EQ, 0.5 s reverb, limiter (config 3)
4. runner       ``runner.run_batch`` over ragged WAV files
5. serving      a 32-slot ``SessionPool`` against independent
                ``StreamSession``s, and a two-config ``PoolServer``
6. lufs         ``measure_lufs`` on a 10-minute stereo 48 kHz programme
7. cli          ``xmtpu.cli resample`` on a 440 Hz WAV, in this process
8. chip tests   ``pytest -m chip`` in this process (no xdist)

``--chips 4`` runs only the paths across devices, each against its
one-device result: the flagship over a ("dp",) mesh (bit for bit), a
mesh-sharded ``SessionPool``, and one 10-minute clip on the ("sp",) and
("dp", "sp") meshes against the float64 references.

Everything runs in this one process (a JAX process reserves most of a
card's memory); only the float64 reference of the 10-minute clip is
computed in a CPU-only child, beside the device work. Any failure exits
non-zero with no result line. The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: ``python chip_smoke.py [--chips 1|4] [--seed N]``
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GATE_DB = -80.0  # audio: RMS error vs the float64 reference (BASELINE.json:2)
LUFS_TOL = 0.01  # loudness: |LU| vs the float64 reference
SP_SECONDS = 600.0  # the long clip of the sp phase: 10 minutes


class PhaseError(AssertionError):
    """A phase's result is outside its stated tolerance."""


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="End-to-end smoke run of xmtpu on the GPU.")
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="1: the single-card phases (default); 4: only "
                        "the paths across four cards")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generated audio")
    return p.parse_args(argv)


def rms_db(got, ref) -> float:
    """RMS error of ``got`` vs ``ref`` in dB relative to ``ref``'s power."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    p_err = float(np.mean((got - ref) ** 2))
    if p_err == 0.0:
        return -math.inf
    return 10.0 * math.log10(p_err / float(np.mean(ref ** 2)))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def run_phase(name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    detail = fn(*args, **kw)
    print(f"[{name}] ok  {detail}  ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def _timed(fn):
    """(result, seconds) with the result ready on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# --- 1. device ----------------------------------------------------------------


def phase_device(chips: int) -> str:
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py: JAX's platform is {devs[0].platform!r}, not "
            f"'gpu'; this script runs only on the card")
    if len(devs) < chips:
        raise SystemExit(f"chip_smoke.py: --chips {chips} but JAX sees "
                         f"{len(devs)} GPU(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return (f"{devs} kind={devs[0].device_kind!r} jax={jax.__version__} "
            f"jaxlib={jaxlib.__version__}")


# --- 2. flagship batch (config 4) -------------------------------------------


def _voice_bgm(rng, B: int, n: int):
    import numpy as np

    voice = (rng.standard_normal((B, n)) * 9000).astype(np.int16)
    bgm = (np.sin(np.arange(n) / 50.0)[None].repeat(B, 0) * 12000).astype(
        np.int16)
    return voice, bgm


def phase_flagship(seed: int, B: int = 256, seconds: float = 10.0) -> str:
    import jax
    import numpy as np

    from xmtpu import batch as xb
    from xmtpu import engine

    voice, bgm = _voice_bgm(np.random.default_rng(seed), B,
                            int(44100 * seconds))
    vd, bd = jax.device_put(voice), jax.device_put(bgm)
    step = jax.jit(xb.make_flagship_step())
    t0 = time.perf_counter()
    lowered = step.lower(vd, bd)
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    # the card's engine runs the envelope kernel, the XLA engine does not
    has_kernel = "xm_envelope" in lowered.as_text()
    require(has_kernel == (engine.default_engine() == engine.GPU),
            f"envelope kernel in the program: {has_kernel}, engine "
            f"{engine.default_engine()!r}")
    out, t_first = _timed(lambda: compiled(vd, bd))
    out, t_warm = _timed(lambda: compiled(vd, bd))
    require(out.shape == (B, int(16000 * seconds)) and out.dtype == np.int16,
            f"flagship output {out.shape} {out.dtype}")
    rows = sorted({0, B - 1})
    y = np.asarray(out[np.array(rows)]).astype(np.float64) / 32768.0
    dbs = []
    for k, i in enumerate(rows):
        ref = xb.flagship_oracle_np(voice[i], bgm[i]).astype(np.float64)
        dbs.append(rms_db(y[k], ref / 32768.0))
        require(dbs[-1] <= GATE_DB, f"flagship clip {i}: {dbs[-1]:.2f} dB "
                                    f"> {GATE_DB} dB")
    mem = compiled.memory_analysis()
    temp = getattr(mem, "temp_size_in_bytes", None)
    return (f"B={B} n={voice.shape[1]} accuracy_db clip{rows[0]}="
            f"{dbs[0]:.2f} clip{rows[-1]}={dbs[-1]:.2f} (gate {GATE_DB}) "
            f"kernel={has_kernel} compile={t_compile:.2f}s "
            f"first={t_first * 1e3:.1f}ms warm={t_warm * 1e3:.2f}ms "
            f"temp_bytes={temp}")


# --- 3. public effects (config 3) -------------------------------------------


def phase_effects(seed: int, B: int = 16, n: int = 480000) -> str:
    import jax
    import numpy as np

    import xmtpu
    from xmtpu import engine
    from xmtpu.batch import DEFAULT_BANDS
    from xmtpu.graph import fx
    from xmtpu.ops import biquad, limiter, reverb

    sr = 48000
    rng = np.random.default_rng(seed + 1)
    x = (0.3 * rng.standard_normal((B, n, 2))).astype(np.float32)
    ir = reverb.synthetic_ir(0.5, sr).astype(np.float32)
    chain = [
        {"name": "equalizer", "params": {"bands": list(DEFAULT_BANDS)}},
        {"name": "reverb", "params": {"ir": ir, "wet": 0.3, "dry": 0.7}},
        {"name": "limiter", "params": {}},
    ]
    xd = jax.device_put(x)
    y, t_cold = _timed(lambda: xmtpu.effects(xd, sr, chain, device_out=True))
    y, t_warm = _timed(lambda: xmtpu.effects(xd, sr, chain, device_out=True))
    require(y.shape == x.shape, f"effects output {y.shape}")
    effs = fx.get_compiled_chain(sr, chain)[0]
    lim = next(e for e in effs if isinstance(e, fx.LimiterFx))
    require(lim.engine == engine.default_engine() and not lim.interpret,
            f"limiter engine {lim.engine!r} (interpret={lim.interpret})")
    folded = any(isinstance(e, fx.FusedLTIFx) for e in effs)
    require(folded == (lim.engine == engine.GPU),
            f"LTI fold {folded} on engine {lim.engine!r}")
    sos = biquad.eq_sos(list(DEFAULT_BANDS), sr)
    ref, _ = biquad.sosfilt_np(sos, x[0].T)
    ref = reverb.reverb_np(ref, ir.astype(np.float64), wet=0.3, dry=0.7)
    ref, _ = limiter.limiter_np(ref, sr)
    db = rms_db(np.asarray(y[0]).T, ref)
    require(db <= GATE_DB, f"effects clip 0: {db:.2f} dB > {GATE_DB} dB")
    kind = ("envelope kernel (Pallas, Triton route, compiled)"
            if lim.engine == engine.GPU else "XLA float64 scans")
    return (f"x={x.shape} limiter={kind} lti_fold={folded} accuracy_db="
            f"{db:.2f} (gate {GATE_DB}) cold={t_cold:.2f}s "
            f"warm={t_warm * 1e3:.2f}ms")


# --- 4. batch runner ---------------------------------------------------------


def phase_runner(seed: int, lengths=(441000, 300000, 123457, 44100, 8000,
                                     440999)) -> str:
    import numpy as np

    from xmtpu.batch import flagship_oracle_np
    from xmtpu.io import read_wav, write_wav
    from xmtpu.runner import run_batch

    rng = np.random.default_rng(seed + 2)
    clips = [(rng.standard_normal(n) * 9000).astype(np.int16)
             for n in lengths]
    with tempfile.TemporaryDirectory() as d:
        jobs = []
        for i, c in enumerate(clips):
            src = os.path.join(d, f"in_{i}.wav")
            write_wav(src, c, 44100)
            jobs.append({"voice": src, "out": os.path.join(d, f"out_{i}.wav")})
        t0 = time.perf_counter()
        rep = run_batch(jobs, sr_in=44100, sr_bus=16000)
        t_run = time.perf_counter() - t0
        require(rep.done == len(clips) and not rep.failed,
                f"runner done={rep.done} failed={rep.failed}")
        outs = []
        for i, n in enumerate(lengths):
            pcm, sr = read_wav(jobs[i]["out"])
            require(sr == 16000 and pcm.shape[0] == -(-(n * 160) // 441),
                    f"runner clip {i}: sr={sr} len={pcm.shape[0]} for n={n}")
            outs.append(pcm.reshape(pcm.shape[0], -1)[:, 0])  # mono
    k = 2  # a ragged clip in a padded bucket
    ref = flagship_oracle_np(clips[k], np.zeros_like(clips[k]))
    db = rms_db(outs[k].astype(np.float64) / 32768.0,
                ref.astype(np.float64) / 32768.0)
    require(db <= GATE_DB, f"runner clip {k}: {db:.2f} dB > {GATE_DB} dB")
    return (f"{len(clips)} clips, lengths ok, clip{k} accuracy_db={db:.2f} "
            f"(gate {GATE_DB}) run={t_run:.2f}s (compile included)")


# --- 5. serving (config 5) ---------------------------------------------------


def _serving_config():
    from xmtpu.config.schema import EffectConfig, PipelineConfig, TrackConfig

    return PipelineConfig(
        tracks=(TrackConfig(url="v", fade_in_ms=50.0, fade_out_ms=80.0),),
        effects=(
            EffectConfig("equalizer", {"bands": [
                {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0},
                {"freq_hz": 3000.0, "gain_db": -3.0, "q": 0.8}]}),
            EffectConfig("limiter", {}),
        ),
        sample_rate=16000, normalize=None)


def _serving_sources(rng, K: int, seconds: float):
    import numpy as np

    return [{"v": ((0.3 * rng.standard_normal(
        int(44100 * (seconds + 0.1 * i)))).astype(np.float32), 44100)}
        for i in range(K)]


def phase_serving(seed: int, K: int = 32, frames: int = 50,
                  groups: int = 3) -> str:
    import numpy as np

    from xmtpu.graph.pool import SessionPool
    from xmtpu.graph.serve import PoolServer
    from xmtpu.graph.streaming import StreamSession

    rng = np.random.default_rng(seed + 3)
    cfg = _serving_config()
    srcs = _serving_sources(rng, K, groups * frames * 0.02 + 0.5)
    pool = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    checked = sorted({0, 1, K // 2, K - 1})
    sessions = {i: StreamSession(cfg, frame_ms=20.0, sources=srcs[i])
                for i in checked}
    worst, times = -math.inf, []
    for _ in range(groups):
        t0 = time.perf_counter()
        got = pool.read(frames)
        times.append(time.perf_counter() - t0)
        require(got.shape[:2] == (K, frames * pool.frame_out),
                f"pool read {got.shape}")
        for i in checked:
            ref = sessions[i].read_many(frames).astype(np.float64) / 32768.0
            db = rms_db(got[i].astype(np.float64) / 32768.0, ref + 1e-12)
            worst = max(worst, db)
            require(db <= GATE_DB, f"pool slot {i}: {db:.2f} dB")
    srv = PoolServer(n_slots=2, frame_ms=20.0)
    pcm = srcs[0]["v"][0]
    sid_a = srv.open({"tracks": [{"url": "a"}], "sampleRate": 16000,
                      "normalize": None}, sources={"a": (pcm, 44100)})
    sid_b = srv.open({"tracks": [{"url": "b", "volume": 0.5}],
                      "sampleRate": 16000, "normalize": None},
                     sources={"b": (pcm, 44100)})
    for _ in range(2):
        pumped = srv.pump(2)
        require(set(pumped) == {sid_a, sid_b}, f"pump -> {sorted(pumped)}")
        require(all(np.all(np.isfinite(np.asarray(v, np.float64)))
                    for v in pumped.values()), "pump: non-finite frames")
    n_pools = srv.stats()["pools"]
    srv.close(sid_a)
    srv.close(sid_b)
    return (f"pool K={K} {groups}x{frames} frames, slots {checked} vs "
            f"StreamSession worst={worst:.2f} dB (gate {GATE_DB}); read "
            f"s/group first={times[0]:.2f} then "
            f"{', '.join(f'{t:.3f}' for t in times[1:])}; PoolServer 2 "
            f"configs -> {n_pools} pools, pumped twice")


# --- 6. LUFS -----------------------------------------------------------------


def phase_lufs(seed: int, seconds: float = 600.0) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from xmtpu.ops.loudness import measure_lufs, measure_lufs_np

    sr = 48000
    n = int(sr * seconds)
    rng = np.random.default_rng(seed + 4)
    t = np.arange(n) / sr
    # 10 s loud / 10 s quiet sections so the relative gate has work to do
    level = np.where(np.sin(2 * np.pi * t / 20.0) >= 0, 0.3, 0.02)
    x = (rng.standard_normal((2, n)) * level).astype(np.float32)
    lufs = jax.jit(measure_lufs, static_argnums=1)
    got, t_dev = _timed(lambda: lufs(jnp.asarray(x), sr))
    got = float(got)
    ref = measure_lufs_np(x, sr)
    require(abs(got - ref) <= LUFS_TOL,
            f"lufs {got:.4f} vs reference {ref:.4f}")
    return (f"{seconds:.0f} s stereo {sr} Hz: {got:.4f} LUFS vs reference "
            f"{ref:.4f} (|diff| {abs(got - ref):.5f} <= {LUFS_TOL}) "
            f"first call {t_dev:.2f}s (compile included)")


# --- 7. CLI ------------------------------------------------------------------


def phase_cli(seconds: float = 3.0) -> str:
    import numpy as np

    from xmtpu import cli
    from xmtpu.io import read_wav, write_wav

    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "tone.wav"), os.path.join(d, "out.wav")
        t = np.arange(int(44100 * seconds)) / 44100.0
        write_wav(src, (np.sin(2 * np.pi * 440.0 * t) * 12000).astype(
            np.int16), 44100)
        rc = cli.main(["resample", src, dst, "--rate", "16000"])
        require(rc in (0, None), f"xmtpu.cli resample rc={rc}")
        pcm, sr = read_wav(dst)
    y = pcm.astype(np.float64).reshape(pcm.shape[0], -1)[:, 0]
    f_peak = np.argmax(np.abs(np.fft.rfft(y))) * sr / len(y)
    require(sr == 16000 and abs(f_peak - 440.0) < 1.0,
            f"cli resample: sr={sr} dominant {f_peak:.2f} Hz")
    return f"resample 44100 -> {sr} Hz, dominant {f_peak:.2f} Hz (440 Hz)"


# --- 8. chip tests -----------------------------------------------------------


def phase_chip_tests() -> str:
    import pytest

    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    require(rc == 0, f"pytest -m chip exited {rc}")
    return "pytest -m chip passed"


# --- --chips 4: the paths across devices -------------------------------------


def _spread(arr, n: int) -> int:
    """Distinct devices holding ``arr``'s shards; must be all ``n``."""
    devs = {s.device for s in arr.addressable_shards}
    require(len(devs) == n, f"shards on {len(devs)} device(s), want {n}")
    return len(devs)


def phase_dp(seed: int, n_dev: int, B: int = 256,
             seconds: float = 10.0) -> str:
    import jax
    import numpy as np

    from xmtpu import batch as xb

    voice, bgm = _voice_bgm(np.random.default_rng(seed), B,
                            int(44100 * seconds))
    mesh, shard = xb.shard_over_batch(n_dev)
    step_dp = xb.flagship_step_sharded(mesh)
    vd, bd = jax.device_put(voice, shard), jax.device_put(bgm, shard)
    y_dp, t_cold = _timed(lambda: step_dp(vd, bd))
    y_dp, t_warm = _timed(lambda: step_dp(vd, bd))
    _spread(y_dp, n_dev)
    # one card, same per-device shape: each dp shard's clips in turn
    one = jax.jit(xb.make_flagship_step())
    per = B // n_dev
    dev0 = jax.devices()[0]
    y_one = np.concatenate([
        np.asarray(one(jax.device_put(voice[i:i + per], dev0),
                       jax.device_put(bgm[i:i + per], dev0)))
        for i in range(0, B, per)])
    y_dp = np.asarray(y_dp)
    require(np.array_equal(y_dp, y_one),
            f"dp vs one card: {np.count_nonzero(y_dp != y_one)} samples "
            f"differ")
    return (f"{B} clips over {n_dev} cards == one card bit for bit; "
            f"cold={t_cold:.2f}s warm={t_warm * 1e3:.2f}ms")


def phase_pool_mesh(seed: int, n_dev: int, K: int = 32, frames: int = 50,
                    groups: int = 3) -> str:
    import jax
    import numpy as np

    from xmtpu.graph.pool import SessionPool

    rng = np.random.default_rng(seed + 3)
    cfg = _serving_config()
    srcs = _serving_sources(rng, K, groups * frames * 0.02 + 0.5)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    sharded = SessionPool(cfg, K, frame_ms=20.0, sources=srcs, mesh=mesh)
    single = SessionPool(cfg, K, frame_ms=20.0, sources=srcs)
    _spread(sharded._srcbuf[0], n_dev)
    worst = -math.inf
    for _ in range(groups):
        a = sharded.read(frames).astype(np.float64) / 32768.0
        b = single.read(frames).astype(np.float64) / 32768.0
        worst = max(worst, rms_db(a, b + 1e-12))
        require(worst <= GATE_DB, f"mesh pool vs one device: {worst:.2f} dB")
    return (f"K={K} over {n_dev} cards vs one device, {groups}x{frames} "
            f"frames: worst {worst:.2f} dB (gate {GATE_DB})")


def _sp_clip(seed: int, n: int):
    """The long stereo programme of the SP phase (also built by the
    reference child, from the same seed)."""
    import numpy as np

    rng = np.random.default_rng(seed + 5)
    t = np.arange(n) / 48000.0
    level = np.where(np.sin(2 * np.pi * t / 20.0) >= 0, 0.35, 0.05)
    return (rng.standard_normal((2, n)) * level).astype(np.float32)


def _sp_reference(seed: int, n: int):
    """float64 reference of the SP chain (EQ -> reverb -> limiter): scipy's
    sosfilt for the EQ (the per-sample ``sosfilt_np`` loop would take
    minutes at this length), then ``reverb_np`` and ``limiter_np``."""
    import numpy as np
    from scipy import signal

    from xmtpu.batch import DEFAULT_BANDS
    from xmtpu.ops import biquad, limiter, reverb

    x = _sp_clip(seed, n).astype(np.float64)
    y = signal.sosfilt(biquad.eq_sos(list(DEFAULT_BANDS), 48000), x, axis=-1)
    y = reverb.reverb_np(y, reverb.synthetic_ir(0.5, 48000), wet=0.3, dry=0.7)
    return limiter.limiter_np(y, 48000)[0]


def _host_only():
    os.environ["JAX_PLATFORMS"] = "cpu"  # the child never opens the card


def phase_sp(seed: int, n_dev: int, seconds: float = SP_SECONDS,
             reference=None) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from xmtpu.batch import DEFAULT_BANDS
    from xmtpu.ops import reverb
    from xmtpu.parallel import sp_effects_chain

    n = int(48000 * seconds)
    x = _sp_clip(seed, n)
    ir = reverb.synthetic_ir(0.5, 48000).astype(np.float32)
    devs = np.array(jax.devices()[:n_dev])
    kw = dict(bands=list(DEFAULT_BANDS), ir=ir, wet=0.3, dry=0.7)
    mesh_sp = jax.sharding.Mesh(devs, ("sp",))
    y_sp, t_sp = _timed(lambda: sp_effects_chain(jnp.asarray(x), 48000,
                                                 mesh_sp, **kw))
    _spread(y_sp, n_dev)
    mesh_2d = jax.sharding.Mesh(devs.reshape(2, n_dev // 2), ("dp", "sp"))
    xb = np.stack([x, x])
    y_2d, t_2d = _timed(lambda: sp_effects_chain(jnp.asarray(xb), 48000,
                                                 mesh_2d, dp_axis="dp", **kw))
    _spread(y_2d, n_dev)
    ref = reference.result() if reference is not None else \
        _sp_reference(seed, n)
    dbs = [rms_db(np.asarray(y_sp), ref)] + [
        rms_db(np.asarray(y_2d[i]), ref) for i in range(2)]
    require(max(dbs) <= GATE_DB,
            f"sp/dpxsp vs reference: {', '.join(f'{d:.2f}' for d in dbs)}")
    return (f"{seconds:.0f} s stereo 48 kHz: sp over {n_dev} cards "
            f"{dbs[0]:.2f} dB, dp x sp 2x{n_dev // 2} rows {dbs[1]:.2f}/"
            f"{dbs[2]:.2f} dB (gate {GATE_DB}); first calls sp={t_sp:.2f}s "
            f"dpxsp={t_2d:.2f}s")


# --- main --------------------------------------------------------------------


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    run_phase("device", phase_device, args.chips)
    import jax

    import xmtpu  # noqa: F401  (x64, compile cache)

    if args.chips == 1:
        run_phase("flagship", phase_flagship, args.seed)
        run_phase("effects", phase_effects, args.seed)
        run_phase("runner", phase_runner, args.seed)
        run_phase("serving", phase_serving, args.seed)
        run_phase("lufs", phase_lufs, args.seed)
        run_phase("cli", phase_cli)
        run_phase("chip-tests", phase_chip_tests)
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn"),
                initializer=_host_only) as ex:
            reference = ex.submit(_sp_reference, args.seed,
                                  int(48000 * SP_SECONDS))
            run_phase("dp", phase_dp, args.seed, args.chips)
            run_phase("pool-mesh", phase_pool_mesh, args.seed, args.chips)
            run_phase("sp", phase_sp, args.seed, args.chips,
                      seconds=SP_SECONDS, reference=reference)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
