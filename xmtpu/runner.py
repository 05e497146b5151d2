"""Batch runner: many clips through the fused pipeline (config 4,
BASELINE.json:10 — "256 podcast clips ... on one chip").

Reference analogue: there is none — the C library is invoked once per
clip by the caller [upstream, SURVEY.md §2.2]; the batch axis IS the
rebuild's data-parallel strategy.

Mechanics (SURVEY.md §5/§7.3):
* **bucketing by (native rate, length)** — clips group by their native
  sample rate and pad to geometric length edges (ratio 1.25) so the
  jitted masked step compiles once per rate and bucket, not per clip;
* **failure isolation** — a clip that fails to decode is skipped and
  reported; the batch never dies (SURVEY.md §5 failure detection);
* **resume** — a done-marker (``<out>.done``) is written per clip; a
  re-run skips clips already marked (SURVEY.md §5 checkpoint/resume);
* **metrics** — clips, audio-sec, wall-sec, realtime factor, printed
  and JSON-dumpable (SURVEY.md §5 observability).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np

from xmtpu.io import open_audio
from xmtpu.io.wav import write_wav
from xmtpu.utils.errors import XmtpuError

log = logging.getLogger("xmtpu.runner")

_BUCKET_RATIO = 1.25


@dataclass
class ClipJob:
    """One clip: voice (path or (pcm, sr)), optional bgm, output path."""

    voice: object
    out: str
    bgm: object = None


@dataclass
class BatchReport:
    total: int = 0
    done: int = 0
    skipped_resume: int = 0
    failed: list = field(default_factory=list)  # (out_path, error str)
    audio_sec: float = 0.0
    wall_sec: float = 0.0
    buckets: int = 0
    peak_hbm_bytes: int | None = None  # device peak memory (SURVEY.md §5
    # metrics row); None when the backend doesn't report (XLA:CPU)

    @property
    def realtime_factor(self) -> float:
        return self.audio_sec / self.wall_sec if self.wall_sec > 0 else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "total": self.total,
                "done": self.done,
                "skipped_resume": self.skipped_resume,
                "failed": self.failed,
                "audio_sec": round(self.audio_sec, 3),
                "wall_sec": round(self.wall_sec, 3),
                "realtime_factor": round(self.realtime_factor, 1),
                "buckets": self.buckets,
                "peak_hbm_bytes": self.peak_hbm_bytes,
            }
        )


def _peak_hbm_bytes() -> int | None:
    """Best-effort device peak-memory reading. Only consults an
    ALREADY-initialized backend (never initializes one just to read
    stats); GPU runtimes report ``peak_bytes_in_use``, XLA:CPU returns
    no stats."""
    try:
        from jax._src import xla_bridge

        if not xla_bridge.backends_are_initialized():
            return None
        import jax

        stats = jax.devices()[0].memory_stats()
        return int(stats["peak_bytes_in_use"]) if stats else None
    except Exception:
        return None


def _bucket_edge(n: int, base: int = 16384) -> int:
    """Smallest geometric bucket edge >= n (ratio 1.25, floor ``base``)."""
    e = base
    while e < n:
        e = int(math.ceil(e * _BUCKET_RATIO))
    return e


def _load_mono_i16(src, sr_default: int):
    """Decode to mono int16 (host-side, thin). -> (pcm, native_rate)."""
    if isinstance(src, tuple):
        pcm, sr = src
    elif isinstance(src, np.ndarray):
        pcm, sr = src, sr_default
    else:
        with open_audio(src) as d:
            pcm, sr = d.read_all(), d.sample_rate
    pcm = np.asarray(pcm)
    if pcm.ndim > 1:
        # downmix = channel mean for EVERY dtype (int16 used to keep
        # only channel 0 — same audio gave different output depending
        # on sample format; round-2 review find)
        if pcm.dtype == np.int16:
            pcm = np.round(pcm.astype(np.float64).mean(axis=1)).astype(
                np.int16)
        else:
            pcm = pcm.mean(axis=1)
    if pcm.dtype != np.int16:
        from xmtpu.ops.convert import f32_to_pcm16_np

        pcm = f32_to_pcm16_np(pcm.astype(np.float32))
    return pcm, int(sr)


def _decode_job(job: ClipJob, sr_in: int, sr_bus: int):
    """Decode + validate one job -> (voice_i16, bgm_i16_or_None, rate).
    Raises on any per-clip failure (caller isolates)."""
    v, v_sr = _load_mono_i16(job.voice, sr_in)
    if job.bgm is not None:
        b, b_sr = _load_mono_i16(job.bgm, sr_in)
        if b_sr != v_sr:  # align bgm to the voice's rate on host
            from xmtpu.ops.convert import f32_to_pcm16_np, pcm16_to_f32_np
            from xmtpu.ops.resample import resample_oracle_np

            b = f32_to_pcm16_np(
                resample_oracle_np(
                    pcm16_to_f32_np(b).astype(np.float64), b_sr, v_sr
                ).astype(np.float32)
            )
    else:
        b = None
    if len(v) == 0:
        raise XmtpuError("empty clip")
    from xmtpu.ops.resample import check_rates

    check_rates(v_sr, sr_bus)  # per-clip: a weird header fails one clip
    return v, b, v_sr


def run_batch(
    jobs,
    sr_in: int = 44100,
    sr_bus: int = 16000,
    batch_size: int = 64,
    resume: bool = True,
    step_kw: dict | None = None,
    write_done_markers: bool = True,
    pipeline: bool = True,
    decode_threads: int = 1,
) -> BatchReport:
    """Run clips through the fused masked pipeline.

    Clips bucket by (native rate, length edge); mixed-rate manifests
    are fine. ``sr_in`` is only the assumed rate for bare-ndarray
    inputs (files carry their own). A clip whose rate would produce an
    unreasonable polyphase ratio is failed individually, and a bucket
    that errors fails only its own clips — the batch never dies
    (SURVEY.md §5 failure isolation).

    ``pipeline=True`` (default) runs the three host stages CONCURRENTLY
    — the SURVEY.md §2.2 PP row: a decode thread streams clips through
    the native SPSC ring buffer (:class:`xmtpu.native.PcmChannel`)
    while the main thread packs buckets and dispatches device steps
    (async), and a writer thread fetches results and writes WAVs. Host
    decode/write time hides behind device compute instead of adding to
    it. ``pipeline=False`` keeps the serial decode-all -> step -> write
    order (same outputs; the timing baseline).

    ``decode_threads`` (pipelined mode only): decode up to N clips
    concurrently. The native codecs run under ctypes, which releases
    the GIL during the foreign call, so compressed-format decode can
    scale with HOST CORES — on a single-core host (like the dev
    environment, measured: 0.96x at 4 threads) it changes nothing.
    Results enter the ring in MANIFEST ORDER regardless of which thread
    finishes first, so bucket packing (and therefore output bytes) is
    identical to ``decode_threads=1``.
    """
    if decode_threads < 1:
        from xmtpu.utils.errors import ConfigError

        raise ConfigError(f"decode_threads must be >= 1, got {decode_threads}")
    # whole-run rates fail the RUN, typed, before any decode: a negative
    # or zero --rate used to reach filter design / WAV headers, and a
    # huge bus-side ratio stalled the compiler
    from xmtpu.ops.resample import check_rates

    check_rates(sr_in, sr_bus)
    if isinstance(jobs, (str, bytes, dict)):
        from xmtpu.utils.errors import ConfigError

        raise ConfigError(
            f"jobs must be a list of {{voice, bgm?, out}} entries, got "
            f"{type(jobs).__name__}")
    jobs = list(jobs)  # accept any iterable (generator, deque, ...)
    report = BatchReport(total=len(jobs))
    t_start = time.perf_counter()

    todo = []
    for job in jobs:
        if not isinstance(job, ClipJob):
            if not isinstance(job, dict) or not {"voice", "out"} <= set(job):
                # a malformed manifest entry used to die with a bare
                # TypeError from the dataclass call (fuzz find); a bad
                # MANIFEST (vs a bad clip) fails the whole run, typed
                from xmtpu.utils.errors import ConfigError

                raise ConfigError(
                    f"manifest entry needs 'voice' and 'out' (and "
                    f"optional 'bgm'): {job!r}")
            unknown = set(job) - {"voice", "bgm", "out"}
            if unknown:
                from xmtpu.utils.errors import ConfigError

                raise ConfigError(
                    f"manifest entry has unknown key(s) {sorted(unknown)}: "
                    f"{job!r}")
            job = ClipJob(**job)
        if not isinstance(job.out, (str, os.PathLike)):
            # a non-path 'out' (e.g. an int) passed the key check and
            # crashed the whole run with a raw TypeError at the resume
            # probe — or silently wrote a file named by its repr
            # (review find)
            from xmtpu.utils.errors import ConfigError

            raise ConfigError(
                f"manifest 'out' must be a path, got "
                f"{type(job.out).__name__}: {job!r}")
        if not isinstance(job.out, str):
            import dataclasses

            job = dataclasses.replace(job, out=os.fspath(job.out))
        if resume and os.path.exists(job.out + ".done"):
            report.skipped_resume += 1
            continue
        todo.append(job)

    if pipeline:
        _run_batch_pipelined(todo, report, sr_in, sr_bus, batch_size,
                             step_kw, write_done_markers, decode_threads)
    else:
        _run_batch_serial(todo, report, sr_in, sr_bus, batch_size,
                          step_kw, write_done_markers)
    missing = report.total - (report.done + len(report.failed)
                              + report.skipped_resume)
    if missing > 0:
        # accounting safety net: every job must end done, failed, or
        # skipped — a stage crash that silently dropped jobs used to
        # report success with exit code 0 (review find)
        report.failed.append((
            "<unaccounted>",
            f"{missing} job(s) were dropped by a pipeline-stage failure"))
    report.wall_sec = time.perf_counter() - t_start
    report.peak_hbm_bytes = _peak_hbm_bytes()
    log.info("batch: %s", report.to_json())
    return report


_STEP_CACHE: dict = {}  # module-level: repeat run_batch calls (a service
# processing manifests) reuse compiled executables instead of re-tracing
# a fresh jit closure per call


class _Dispatcher:
    """Shared device-side logic: per-rate step cache + chunk dispatch."""

    def __init__(self, sr_bus: int, step_kw):
        self.sr_bus = sr_bus
        self.step_kw = step_kw or {}

    def step_for(self, rate: int):
        import jax
        from xmtpu import batch as xbatch

        key = (rate, self.sr_bus, _freeze_kw(self.step_kw))
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = jax.jit(
                xbatch.make_batch_step(sr_in=rate, sr_bus=self.sr_bus,
                                       **self.step_kw)
            )
        return _STEP_CACHE[key]

    def dispatch(self, rate: int, edge: int, chunk):
        """Pack + enqueue one device step (async dispatch; the result is
        fetched later). ``chunk``: list of (job, voice, bgm). ->
        (lengths, out_device)."""
        import jax.numpy as jnp

        B = len(chunk)
        voice = np.zeros((B, edge), np.int16)
        bgm = np.zeros((B, edge), np.int16)
        lengths = np.zeros((B,), np.int32)
        for r, (job, v, b) in enumerate(chunk):
            voice[r, : len(v)] = v
            lengths[r] = len(v)
            if b is not None and len(b) > 0:
                reps = -(-len(v) // len(b))
                bgm[r, : len(v)] = np.tile(b, reps)[: len(v)]
        out_dev = self.step_for(rate)(
            jnp.asarray(voice), jnp.asarray(bgm), jnp.asarray(lengths)
        )
        return lengths, out_dev


def _freeze_kw(kw) -> tuple:
    """Hashable cache key for step_kw (bands lists etc. are legal
    values; raw dict.items() raised on them — round-2 review find)."""
    def fz(v):
        if isinstance(v, dict):
            return tuple(sorted((k, fz(x)) for k, x in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(fz(x) for x in v)
        return v
    return fz(dict(kw))


def _write_chunk(report, chunk, lengths, out, rate, sr_bus,
                 write_done_markers):
    """Write one completed chunk's WAVs + done markers (host side).
    Per-JOB failure isolation: one bad output path must not abort the
    chunk, kill the writer thread, or go unrecorded (round-2 review
    find — the pipelined writer's bounded queue would deadlock)."""
    g = math.gcd(rate, sr_bus)
    L, M = sr_bus // g, rate // g
    for r, (job, v, b) in enumerate(chunk):
        try:
            m = -(-(int(lengths[r]) * L) // M)  # ceil (parens matter)
            write_wav(job.out, out[r, :m], sr_bus)
            if write_done_markers:
                with open(job.out + ".done", "w") as f:
                    f.write("ok\n")
        except Exception as e:
            log.warning("write failed for %s: %s", job.out, e)
            report.failed.append((job.out, f"write failed: {e}"))
            continue
        report.done += 1
        report.audio_sec += int(lengths[r]) / rate


def _run_batch_serial(todo, report, sr_in, sr_bus, batch_size, step_kw,
                      write_done_markers):
    """Sequential decode-all -> per-bucket device steps -> write."""
    pending = []
    for job in todo:
        try:
            v, b, rate = _decode_job(job, sr_in, sr_bus)
        except Exception as e:  # isolate per-clip decode failures
            log.warning("clip %s failed to decode: %s", job.out, e)
            report.failed.append((job.out, str(e)))
            continue
        pending.append((job, v, b, (rate, _bucket_edge(len(v)))))

    disp = _Dispatcher(sr_bus, step_kw)
    buckets: dict[tuple, list] = {}
    for (job, v, b, key) in pending:
        buckets.setdefault(key, []).append((job, v, b))
    report.buckets = len(buckets)

    for (rate, edge), items in sorted(buckets.items()):
        for i in range(0, len(items), batch_size):
            chunk = items[i : i + batch_size]
            try:
                lengths, out_dev = disp.dispatch(rate, edge, chunk)
                out = np.asarray(out_dev)
            except Exception as e:
                log.warning("bucket (%s Hz, %s) chunk failed: %s",
                            rate, edge, e)
                for (job, _, _) in chunk:
                    report.failed.append(
                        (job.out, f"device step failed: {e}"))
                continue
            _write_chunk(report, chunk, lengths, out, rate, sr_bus,
                         write_done_markers)


def _run_batch_pipelined(todo, report, sr_in, sr_bus, batch_size, step_kw,
                         write_done_markers, decode_threads: int = 1):
    """Three concurrent host stages (SURVEY.md §2.2 PP row):

    decode thread --PcmChannel(SPSC ring)--> main (pack + dispatch)
                                              --Queue--> writer thread

    The device runs chunk k while the decode thread prepares k+1 and
    the writer drains k-1 (JAX dispatch is async; the writer's
    np.asarray is the only blocking fetch). Buckets fill greedily and
    dispatch as soon as ``batch_size`` clips of one (rate, edge)
    arrive; stragglers flush at end-of-stream. Failure isolation is
    per-stage: decode errors are caught in the decode thread, device
    errors at the writer's fetch.
    """
    import queue as _queue
    import threading

    from xmtpu.native import PcmChannel

    chan = PcmChannel()
    write_q: _queue.Queue = _queue.Queue(maxsize=4)  # bounds in-flight

    handled = [0]  # prefix of `todo` that reached _emit's outcome —
    # jobs are emitted strictly in manifest order in both decode paths

    def _emit(job, result):
        """Publish one decode result (a thunk) or per-clip failure."""
        try:
            v, b, rate = result()
        except Exception as e:
            log.warning("clip %s failed to decode: %s", job.out, e)
            report.failed.append((job.out, str(e)))
            handled[0] += 1
            return
        chan.put([v, b], (job, rate))  # counted only AFTER the publish:
        # a put failure leaves this job unhandled for the sweep below
        handled[0] += 1

    def producer():
        try:
            if decode_threads <= 1:
                for job in todo:
                    _emit(job, lambda j=job: _decode_job(j, sr_in, sr_bus))
                return
            # N decode workers, ONE publisher (this thread): results are
            # drained in SUBMISSION order through a bounded window, so
            # the SPSC ring still has a single producer and the bucket
            # packing (hence output bytes) matches decode_threads=1.
            # The window caps decoded-but-unconsumed clips at ~2N; the
            # blocking chan.put provides backpressure beyond that.
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            pending: deque = deque()
            with ThreadPoolExecutor(
                    decode_threads, thread_name_prefix="xmtpu-decode") as ex:
                for job in todo:
                    pending.append(
                        (job, ex.submit(_decode_job, job, sr_in, sr_bus)))
                    if len(pending) > 2 * decode_threads:
                        j, fut = pending.popleft()
                        _emit(j, fut.result)
                while pending:
                    j, fut = pending.popleft()
                    _emit(j, fut.result)
        except Exception as e:  # a producer-stage crash (e.g. chan.put
            # failing) used to die silently: the finally closed the
            # channel, the main loop saw a clean end-of-stream, and the
            # undelivered jobs vanished from the report with exit code 0
            # (review find)
            log.warning("decode stage failed: %s", e)
            for job in todo[handled[0]:]:
                report.failed.append(
                    (job.out, f"decode stage failed: {e}"))
        finally:
            chan.close()

    def writer():
        while True:
            item = write_q.get()
            if item is None:
                return
            chunk, lengths, out_dev, rate, edge = item
            try:
                out = np.asarray(out_dev)  # blocks until device done
            except Exception as e:
                log.warning("bucket (%s Hz, %s) chunk failed: %s",
                            rate, edge, e)
                for (job, _, _) in chunk:
                    report.failed.append(
                        (job.out, f"device step failed: {e}"))
                continue
            try:
                _write_chunk(report, chunk, lengths, out, rate, sr_bus,
                             write_done_markers)
            except Exception as e:
                # _write_chunk isolates per-job write failures itself;
                # this catches anything unexpected OUTSIDE that
                # isolation so the writer thread cannot die and leave
                # the main thread blocked on the bounded queue
                # (review find)
                log.warning("bucket (%s Hz, %s) write stage failed: %s",
                            rate, edge, e)
                for (job, _, _) in chunk:
                    report.failed.append(
                        (job.out, f"write stage failed: {e}"))

    # daemon: an exception that escapes the orchestration below (e.g.
    # KeyboardInterrupt mid-batch) must never leave a blocked helper
    # thread holding the interpreter open (review find)
    t_prod = threading.Thread(target=producer, name="xmtpu-decode",
                              daemon=True)
    t_write = threading.Thread(target=writer, name="xmtpu-write",
                               daemon=True)
    t_prod.start()
    t_write.start()

    disp = _Dispatcher(sr_bus, step_kw)
    buckets: dict[tuple, list] = {}
    seen_buckets: set = set()

    def flush(key, items):
        rate, edge = key
        try:
            lengths, out_dev = disp.dispatch(rate, edge, items)
        except Exception as e:  # pack/compile/dispatch error: fail chunk
            log.warning("bucket (%s Hz, %s) dispatch failed: %s",
                        rate, edge, e)
            for (job, _, _) in items:
                report.failed.append((job.out, f"device step failed: {e}"))
            return
        payload = (items, lengths, out_dev, rate, edge)
        while True:  # never block forever on a dead writer (review find)
            try:
                write_q.put(payload, timeout=1.0)
                return
            except _queue.Full:
                if not t_write.is_alive():
                    for (job, _, _) in items:
                        report.failed.append(
                            (job.out, "writer thread died"))
                    return

    ok = False
    try:
        while (item := chan.get()) is not None:
            (v, b), (job, rate) = item
            key = (rate, _bucket_edge(len(v)))
            seen_buckets.add(key)
            buckets.setdefault(key, []).append((job, v, b))
            if len(buckets[key]) >= batch_size:
                flush(key, buckets.pop(key))
        for key in sorted(buckets):  # end-of-stream stragglers
            flush(key, buckets[key])
        report.buckets = len(seen_buckets)
        t_prod.join()
        ok = True
    finally:
        # ALWAYS unblock the writer — the sentinel used to be sent only
        # on the happy path, so an exception here left the (formerly
        # non-daemon) writer blocked on get() forever. The put itself
        # must not block forever either: if the writer died with the
        # queue full, retry with a timeout while checking liveness.
        while True:
            try:
                write_q.put(None, timeout=1.0)
                break
            except _queue.Full:
                if not t_write.is_alive():
                    break
        # happy path: wait for every queued chunk to land on disk;
        # exception path: bounded wait, the daemon flag guarantees exit
        t_write.join(None if ok else 10.0)
