"""Heterogeneous-config serving front end over :class:`SessionPool`.

Reference usage model: a process holds MANY independent
``xm_audio_utils`` handles, one per client, each with its own JSON
config (``src/xm_audio_utils.c`` [upstream, SURVEY.md §3.2]; round-2
VERDICT "serving mode" directive). :class:`~xmtpu.graph.pool.SessionPool`
batches K *same-config* sessions into one jitted device step;
:class:`PoolServer` removes that restriction: sessions are bucketed by
a canonical (config, frame geometry) key, every bucket is backed by one
or more SessionPools, and clients get per-session handles with
``read``/``seek``/``close``.

Design notes:

- A bucket's step program is fixed by (config content, frame geometry,
  pool capacity) — all sessions in a bucket ride ONE vmapped dispatch,
  so the device cost of a bucket is one step regardless of how many of
  its slots are occupied. Distinct configs compile distinct steps
  (unavoidable: the effect chain is baked into the program), so a
  serving deployment should expect one compile per distinct config
  shape, amortized over every session that ever uses it.
- The pool advances all of a bucket's slots together (that is what
  makes it one dispatch). Per-session ``read`` therefore BUFFERS: a
  read that needs frames pumps the owning pool once for the whole
  group and queues the co-resident sessions' frames for their own
  readers. Synchronous serving loops can instead call :meth:`pump`
  once per frame period and fan the returned frames out to clients.
- A session that stops reading while others advance would buffer
  without bound; past ``max_buffer_frames`` the server refuses to
  advance that pool: :meth:`~PoolServer.read` raises a typed error
  naming the laggard (close it or read it), while
  :meth:`~PoolServer.pump` skips that pool and keeps every other pool
  advancing (draining the returned frames unblocks it). Sessions past
  end-of-stream stop buffering on their own (their slots produce exact
  silence on device), and a pool whose sessions have ALL ended costs
  no device work at all.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from xmtpu.config.schema import PipelineConfig, config_from_dict
from xmtpu.utils.errors import ConfigError, XmtpuError


def _bucket_key(cfg: PipelineConfig, frame_ms: float, geom) -> tuple:
    """Canonical pool-compatibility key: two sessions may share a pool
    iff their configs build the identical step program AND their track
    native geometries match the pool's (join() enforces the latter for
    real; the key only has to discriminate). Effects are keyed by
    content (``fx._chain_key`` hashes array params and IR files by
    signature, so a rewritten IR file lands in a fresh bucket instead
    of reusing a stale step). ``block_size``/``bitrate`` are offline
    concerns and deliberately excluded.

    Track urls are keyed by their ALIASING PATTERN (which positions
    share a url), not their values: the step program never reads the
    url — audio is per-slot data — so clients with identical pipelines
    but each their own file (THE serving shape) ride one pool. The
    pattern must match exactly so duplicate-url positions (whose audio
    is necessarily identical — sources are keyed by url) stay
    duplicated when :meth:`PoolServer.open` re-keys a joiner's audio
    by the host pool's own track urls."""
    from xmtpu.graph import fx as _fx

    alias: dict = {}
    tracks = tuple(
        (alias.setdefault(t.url, i), t.kind, t.volume, t.start_time_ms,
         t.end_time_ms, t.fade_in_ms, t.fade_out_ms, t.loop, t.side_duck)
        for i, t in enumerate(cfg.tracks)
    )
    return (
        cfg.sample_rate, cfg.channels, cfg.normalize,
        cfg.normalize_target_db, float(frame_ms), tracks,
        _fx._chain_key(cfg.sample_rate, list(cfg.effects)),
        _fx._chain_key(cfg.sample_rate, list(cfg.master_effects)),
        tuple(geom),
    )


@dataclasses.dataclass
class _Served:
    pool: object
    slot: int
    key: tuple
    frames: list  # buffered (frame_out, ch) arrays, oldest first


class PoolServer:
    """Many concurrent sessions, heterogeneous configs, one process.

    ``n_slots``: capacity of each underlying pool (a bucket grows by
    whole pools once full). ``max_seconds``: floor for every pool's
    device-resident source capacity (a pool is always sized to at least
    the longer of this and its founding session's sources, so later
    sessions with clips up to ``max_seconds`` join without a new pool).
    ``max_buffer_frames``: per-session unread-frame cap (see module
    doc). ``duck_params``/``output_dtype`` apply to every pool.
    ``mesh``/``mesh_axis``: optional ``jax.sharding.Mesh`` — every
    pool shards its slot axis over ``mesh_axis`` and serves SPMD
    (``n_slots`` must divide the axis size; see
    :class:`~xmtpu.graph.pool.SessionPool`).

    THREAD SAFETY: all public methods serialize on one internal lock,
    like :class:`SessionPool` — request handlers may open/close/seek
    while another thread reads.
    """

    def __init__(self, n_slots: int = 32, frame_ms: float = 20.0,
                 max_seconds: float | None = None,
                 output_dtype=np.int16, duck_params: dict | None = None,
                 max_buffer_frames: int = 1024,
                 mesh=None, mesh_axis: str = "dp"):
        if n_slots < 1:
            raise ConfigError("n_slots must be >= 1")
        if max_buffer_frames < 1:
            raise ConfigError("max_buffer_frames must be >= 1")
        self.n_slots = int(n_slots)
        self.frame_ms = float(frame_ms)
        self.max_seconds = max_seconds
        self.output_dtype = output_dtype
        self.duck_params = duck_params
        self.max_buffer_frames = int(max_buffer_frames)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            # fail at construction, not first open(): the per-pool
            # divide-evenly check would otherwise surface as every
            # open() falling through to found yet another bad pool
            if mesh_axis not in mesh.axis_names:
                raise ConfigError(
                    f"mesh has no axis {mesh_axis!r} (axes: "
                    f"{mesh.axis_names})")
            if self.n_slots % mesh.shape[mesh_axis]:
                raise ConfigError(
                    f"n_slots={self.n_slots} must divide evenly over "
                    f"mesh axis {mesh_axis!r} "
                    f"(size {mesh.shape[mesh_axis]})")
        self._lock = threading.RLock()
        self._buckets: dict[tuple, list] = {}  # key -> [SessionPool, ...]
        # id(pool) -> {slot: sid} (sid None = reserved by an in-flight
        # open(); doubles as the pool->sessions index so pump never
        # scans the whole session table per pool)
        self._alloc: dict[int, dict[int, int | None]] = {}
        self._sessions: dict[int, _Served] = {}
        self._next_sid = 0

    # -- session lifecycle -------------------------------------------------

    def open(self, config, sources=None) -> int:
        """Start a session: returns a session id for
        :meth:`read`/:meth:`seek`/:meth:`close`. ``config``: dict or
        :class:`PipelineConfig` (each session brings its OWN).
        ``sources``: name -> pcm | (pcm, sr) overriding track urls, as
        everywhere else. Decodes each source exactly once; the audio is
        device-resident for the life of the session."""
        from xmtpu.graph.pipeline import resolve_source
        from xmtpu.graph.pool import SessionPool

        if isinstance(config, dict):
            config = config_from_dict(config)
        if not isinstance(config, PipelineConfig):
            raise ConfigError("config must be PipelineConfig or dict")
        if not config.tracks:
            raise ConfigError("config has no tracks to serve")
        # decode each DISTINCT url once (tracks sharing a url carry
        # identical audio — sources are keyed by url everywhere)
        by_url: dict = {}
        resolved = []
        for i, t in enumerate(config.tracks):
            if t.url not in by_url:
                by_url[t.url] = resolve_source(t, sources,
                                               config.sample_rate, i)
            resolved.append(by_url[t.url])
        geom = tuple(
            (int(sr), 1 if np.asarray(pcm).ndim == 1
             else int(np.asarray(pcm).shape[1]))
            for pcm, sr in resolved
        )
        key = _bucket_key(config, self.frame_ms, geom)

        # The device source upload (p.join / SessionPool construction,
        # long for long clips) runs OUTSIDE the
        # server lock so reads of unrelated pools never stall behind an
        # open(): the slot is RESERVED (sid None) under the lock, the
        # upload happens against the pool's own lock, and the session
        # registers (or the reservation rolls back) under the lock.
        tried: set[int] = set()
        while True:
            with self._lock:
                cand = None
                for p in self._buckets.get(key, ()):  # registered pools
                    if id(p) in tried:
                        continue
                    occupied = self._alloc[id(p)]
                    free = [i for i in range(p.n_slots)
                            if i not in occupied]
                    if free:
                        occupied[free[0]] = None  # reserve
                        cand = (p, free[0])
                        break
            if cand is None:
                break
            p, slot = cand
            # re-key this session's already-decoded audio by the
            # HOST POOL's track urls, positionally: a pool resolves
            # joins against its founding config, whose urls may
            # differ from this session's (the bucket key matches
            # pipelines and url-aliasing patterns, not url values).
            # Duplicate urls are fine: sources are KEYED by url
            # everywhere (pipeline.resolve_source), so positions
            # sharing a url carry identical audio on both sides.
            srcdict = {pt.url: (pcm, int(sr))
                       for pt, (pcm, sr) in zip(p.config.tracks,
                                                resolved)}
            try:
                p.join(slot, srcdict)
            except ConfigError:
                # validated before any mutation: incompatible
                # geometry or a clip beyond this pool's capacity —
                # try the next pool / found a new one
                with self._lock:
                    self._alloc[id(p)].pop(slot, None)
                tried.add(id(p))
                continue
            except BaseException:
                # anything else (e.g. a device failure mid
                # upload) must not leave the sid=None reservation in
                # _alloc forever — that would permanently shrink the
                # pool and make pump() skip a phantom slot
                with self._lock:
                    self._alloc[id(p)].pop(slot, None)
                raise
            with self._lock:
                # a pump() may have advanced the group between join
                # and registration (nothing buffered for an
                # unregistered slot) — reset so the client starts at 0
                p.seek(slot, 0.0)
                return self._register(p, slot, key)
        # no joinable pool: found a new one (construction uploads the
        # founding sources — also outside the lock). Nothing is
        # registered until it succeeds, so a constructor failure
        # leaves no phantom bucket. Two racing opens of a new config
        # may found two pools; the bucket holds both (capacity is
        # wasted, correctness is not).
        srcdict = {t.url: (pcm, int(sr))
                   for t, (pcm, sr) in zip(config.tracks, resolved)}
        pool = SessionPool(
            config, self.n_slots, frame_ms=self.frame_ms,
            sources=[srcdict], output_dtype=self.output_dtype,
            duck_params=self.duck_params,
            max_seconds=self.max_seconds,
            mesh=self.mesh, mesh_axis=self.mesh_axis)
        with self._lock:
            self._buckets.setdefault(key, []).append(pool)
            self._alloc[id(pool)] = {}
            return self._register(pool, 0, key)

    def _register(self, pool, slot: int, key: tuple) -> int:
        """Bind a successfully joined slot to a fresh sid (lock held)."""
        sid = self._next_sid
        self._next_sid += 1
        self._alloc[id(pool)][slot] = sid
        self._sessions[sid] = _Served(pool, slot, key, [])
        return sid

    def close(self, sid: int) -> None:
        """End a session: its slot outputs silence and is free for the
        next :meth:`open`; buffered frames are dropped."""
        with self._lock:
            s = self._sessions.pop(self._check(sid))
            s.pool.leave(s.slot)
            self._alloc[id(s.pool)].pop(s.slot, None)

    def seek(self, sid: int, ms: float) -> None:
        """Reposition one session (frame-aligned, state reset); frames
        buffered from before the seek are stale and dropped."""
        with self._lock:
            s = self._sessions[self._check(sid)]
            s.pool.seek(s.slot, float(ms))
            s.frames.clear()

    def _check(self, sid: int) -> int:
        if sid not in self._sessions:
            raise XmtpuError(f"unknown session id {sid}")
        return sid

    # -- reading -----------------------------------------------------------

    def _plan_pool(self, pool, k: int) -> list:
        """[(session, take)] for advancing ``pool`` k frames (frames
        past a session's end are exact silence, not stream content —
        ended sessions buffer nothing). Raises the laggard refusal,
        naming the session, BEFORE any device work."""
        plan = []
        for slot, sid in self._alloc[id(pool)].items():
            if sid is None:  # reserved by an in-flight open()
                continue
            s = self._sessions[sid]
            rem = pool.frames_remaining(s.slot)
            take = k if rem is None else min(k, rem)
            if take == 0:
                continue
            if len(s.frames) + take > self.max_buffer_frames:
                raise XmtpuError(
                    f"cannot advance pool: co-resident session {sid} "
                    f"has {len(s.frames)} unread frames "
                    f"(max_buffer_frames={self.max_buffer_frames}) — "
                    f"read or close it first")
            plan.append((s, take))
        return plan

    def _pump_pool(self, pool, k: int, plan: list) -> None:
        """Advance every slot of ``pool`` k frames and buffer per
        ``plan``. No-op (no dispatch, no fetch) when nothing would
        buffer — all-ended pools must not cost a device round trip per
        serving period."""
        if not plan:
            return
        out = pool.read(k)  # (K, k*frame, ch)
        f = pool.frame_out
        for s, take in plan:
            # copy the session's row before slicing it into frame views:
            # a view into ``out`` would pin the WHOLE (K, k*frame, ch)
            # group buffer for as long as one laggard keeps one frame
            # buffered (K x memory amplification at k=1; ~K*k*frame*ch
            # bytes for a single 20 ms frame)
            row = np.array(out[s.slot])
            s.frames.extend(row[i * f:(i + 1) * f] for i in range(take))

    def read(self, sid: int, k: int = 1) -> np.ndarray | None:
        """Next ``k`` frames of one session as (<=k*frame, ch) PCM.
        Returns fewer than ``k`` frames only at end-of-stream, and
        ``None`` once the session is fully ended (the reference's
        get_frame <= 0). Needing frames pumps the owning pool for ALL
        its sessions (co-resident sessions' frames queue for their own
        readers). Pump sizes are quantized to POWERS OF TWO (floor of
        the shortfall): each distinct group size k is a distinct
        compiled scan program, so arbitrary residuals (an 11-frame tail, a k nobody
        else uses) must not mint one-off programs — the ladder bounds
        the set to ~log2(max_buffer_frames) sizes shared by every
        client, for at most log2(k)+1 dispatches per read."""
        if k < 1:
            raise ConfigError("read(sid, k) needs k >= 1")
        if k > self.max_buffer_frames:
            raise ConfigError(
                f"read(sid, k={k}) exceeds max_buffer_frames="
                f"{self.max_buffer_frames} (the requester's own frames "
                "must fit the buffer); raise it at construction")
        with self._lock:
            s = self._sessions[self._check(sid)]
            while len(s.frames) < k:
                rem = s.pool.frames_remaining(s.slot)
                if rem == 0:
                    break  # at end: return the short tail (or None)
                need = k - len(s.frames)
                if rem is not None:
                    need = min(need, rem)
                step = 1 << (need.bit_length() - 1)  # pow2 floor
                self._pump_pool(s.pool, step, self._plan_pool(s.pool, step))
            if not s.frames:
                return None
            take, s.frames = s.frames[:k], s.frames[k:]
            return np.concatenate(take, axis=0)

    def pump(self, k: int = 1) -> dict[int, np.ndarray]:
        """Advance EVERY bucket k frames, then drain: returns
        {sid: all buffered frames} for every session with audio ready.
        The synchronous serving loop: call once per k-frame period and
        fan the rows out to clients.

        A pool whose advance would overflow a laggard's buffer is
        SKIPPED this call (its sessions produce nothing new; unrelated
        pools still advance) — draining, including the laggard's own
        backlog via the returned dict, unblocks it for the next call.
        Use :meth:`read` on a laggard-coupled session to get the typed
        refusal naming the laggard. All pools are PRIMED (dispatched)
        before any is fetched, so after churn invalidates the
        speculative groups the pools' device steps overlap instead of
        paying one dispatch+RTT each in sequence."""
        if k < 1:
            raise ConfigError("pump(k) needs k >= 1")
        if k > self.max_buffer_frames:
            raise ConfigError(
                f"pump(k={k}) exceeds max_buffer_frames="
                f"{self.max_buffer_frames}; raise it at construction")
        with self._lock:
            plans = []
            for pools in self._buckets.values():
                for pool in pools:
                    try:
                        plan = self._plan_pool(pool, k)
                    except XmtpuError:
                        continue  # laggard: skip this pool only
                    if plan:
                        plans.append((pool, plan))
            for pool, _ in plans:
                pool.prime(k)  # dispatch all before fetching any
            for pool, plan in plans:
                self._pump_pool(pool, k, plan)
            out = {}
            for sid, s in self._sessions.items():
                if s.frames:
                    out[sid] = np.concatenate(s.frames, axis=0)
                    s.frames = []
            return out

    # -- introspection / maintenance ----------------------------------------

    def at_end(self, sid: int) -> bool:
        """True once ``sid`` has no frames left (buffered or future)."""
        with self._lock:
            s = self._sessions[self._check(sid)]
            return not s.frames and s.pool.at_end(s.slot)

    def stats(self) -> dict:
        """Serving observability: bucket/pool/session counts and
        per-session unread-frame depths (SURVEY.md §5 metrics row)."""
        with self._lock:
            return {
                "buckets": len(self._buckets),
                "pools": sum(len(v) for v in self._buckets.values()),
                "slots": sum(p.n_slots for v in self._buckets.values()
                             for p in v),
                "sessions": len(self._sessions),
                "buffered_frames": {sid: len(s.frames)
                                    for sid, s in self._sessions.items()},
            }

    def release_idle_pools(self) -> int:
        """Drop pools with no open sessions (frees their device source
        buffers and compiled steps; the next same-config :meth:`open`
        pays a fresh compile). Returns the number released."""
        with self._lock:
            n = 0
            for key, pools in list(self._buckets.items()):
                keep = []
                for p in pools:
                    if self._alloc[id(p)]:
                        keep.append(p)
                    else:
                        del self._alloc[id(p)]
                        n += 1
                if keep:
                    self._buckets[key] = keep
                else:
                    del self._buckets[key]
            return n
