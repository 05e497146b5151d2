"""Pooled serving mode: K concurrent streaming sessions, ONE device step.

Reference analogue: the upstream library's deployment shape is MANY
independent ``xm_audio_utils`` handles in one process (SURVEY.md
§1.1 L4 "interactive handle API", §3.2) — each handle a single-stream
frame loop on its own core. On an accelerator, K separate per-session dispatches
leave the device nearly idle and pay K host round trips per frame
group; :class:`SessionPool` stacks K same-config sessions' DSP state
pytrees and runs ONE jitted (vmapped) step, so sessions fill the lane
dimension exactly like the batch pipeline fills it with clips (round-2
VERDICT directive #2).

Design:

* **Sources are device-resident.** Each user's PCM uploads ONCE at
  :meth:`join` into a per-track ``(K, ch, L)`` HBM buffer; the per-frame
  input windows are carved out IN-JIT with ``dynamic_slice`` (the
  buffer carries ``need`` zeros on both ends, so partial/out-of-range
  windows come back as exact zeros with no masks). Only the (K,) frame
  clocks cross from the host per group.
* All slots share one ``PipelineConfig`` — the serving pattern is one
  DSP graph, many users. Per-slot variation (source audio, length,
  clock, DSP state) rides through the step as traced values, so one
  executable serves every slot and ``join``/``leave``/``seek`` never
  retrace.
* ``read(k)`` runs a ``lax.scan`` over k frames of the vmapped step —
  one dispatch, one device->host fetch (int16 on device) per K x k
  group — and speculatively dispatches the NEXT group before fetching,
  so the device computes group g+1 while group g transfers.
* **Multi-chip serving**: pass ``mesh=`` to shard the slot dimension K
  over a device mesh axis (SURVEY.md §2.2 DP row applied to serving).
  The slot axis is the vmapped leading axis of every device array
  (sources, DSP state, clocks), so sharding it is pure data
  parallelism: each chip serves K/n slots, zero collectives in the
  step (XLA partitions the one jitted program; join/leave/seek stay
  per-slot host-side scatters). Validated on the virtual CPU mesh like
  the batch/sp paths.
"""

from __future__ import annotations

import functools
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu import engine as _engine
from xmtpu.config.schema import PipelineConfig, config_from_dict
from xmtpu.graph import fx as _fx
from xmtpu.graph.streaming import _session_step_fn, _TrackStream
from xmtpu.ops import convert as _convert
from xmtpu.ops import resample as _resample
from xmtpu.utils.errors import ConfigError


def _track_need(ts: _TrackStream) -> int:
    """Static per-frame source-window length for one track geometry."""
    if ts.plan is None:
        return ts.frame_out
    return _resample.plan_rows(ts.plan, ts.nj) * ts.plan.M


@functools.partial(jax.jit, donate_argnums=(0,))
def _set_slot_row(buf, row, slot):
    """Write one slot's source row into the (K, ch, len) buffer.

    Jitted with the buffer DONATED so XLA aliases it and writes O(row)
    in place — the eager ``buf.at[slot].set(row)`` form copied the
    ENTIRE buffer per track per join (GB-scale at large max_seconds,
    with a transient 2x HBM peak; review find)."""
    z = jnp.zeros((), jnp.int32)  # match slot's dtype exactly: under the
    # package-wide x64 mode bare 0s trace as i64 and DUS rejects the mix
    return jax.lax.dynamic_update_slice(
        buf, row[None].astype(buf.dtype), (slot.astype(jnp.int32), z, z))


def _locked(method):
    """Serialize a public SessionPool method on the pool lock (see the
    class docstring's THREAD SAFETY note). RLock: locked methods may
    call each other (__init__'s join of the construction sources)."""
    @functools.wraps(method)
    def wrapper(self, *a, **kw):
        with self._lock:
            return method(self, *a, **kw)
    return wrapper


class SessionPool:
    """K concurrent streaming sessions batched into one device program.

    ``config``: the shared pipeline config (dict or PipelineConfig).
    ``n_slots``: pool capacity K. ``sources``: optional list of per-slot
    source dicts (name -> pcm | (pcm, sr), as :class:`StreamSession`);
    missing/None entries start empty. ``max_seconds``: GUARANTEED
    capacity of the device-resident per-slot source buffers — the
    buffers are sized to the LONGER of this and the longest source
    provided at construction (it is a floor for later ``join``\\s, not
    a cap on the initial sources; a later ``join`` longer than the
    resulting capacity raises). Attach a user with :meth:`join`,
    detach with
    :meth:`leave`, reposition with :meth:`seek`; :meth:`read` advances
    every active slot.

    ``mesh``/``mesh_axis``: optional ``jax.sharding.Mesh`` — the K slot
    dimension of every device-resident array is sharded over
    ``mesh_axis`` and the one jitted step runs SPMD (each device serves
    ``K / axis_size`` slots). ``n_slots`` must divide evenly.

    ``effects_backend``: engine for the per-frame effect chains inside
    the vmapped step (an ``xmtpu.engine`` name) — "scan" (default; the
    f64 oracle twins, the StreamSession-parity configuration) or
    "gpu"/"gpu_interpret" (the card's engine, envelope kernel included).

    THREAD SAFETY: all public methods serialize on one internal lock —
    a serving process can pump :meth:`read` on one thread while request
    handlers ``join``/``leave``/``seek`` other slots (the reference's
    one-handle-per-thread model has no equivalent guard to port; a
    pooled object needs one). A mutation waits for an in-flight read's
    fetch, which the RTT-dominated read cadence absorbs.
    """

    def __init__(self, config, n_slots: int, frame_ms: float = 20.0,
                 sources=None, output_dtype=np.int16,
                 duck_params: dict | None = None,
                 max_seconds: float | None = None,
                 mesh=None, mesh_axis: str = "dp",
                 effects_backend: str = "scan"):
        self._lock = threading.RLock()
        try:
            _engine.resolve(effects_backend)
        except ConfigError as e:
            raise ConfigError(f"effects_backend: {e}") from e
        self._effects_backend = effects_backend
        if isinstance(config, dict):
            config = config_from_dict(config)
        if not isinstance(config, PipelineConfig):
            raise ConfigError("config must be PipelineConfig or dict")
        if n_slots < 1:
            raise ConfigError("n_slots must be >= 1")
        self.config = config
        self.n_slots = int(n_slots)
        self.sr = config.sample_rate
        self.output_dtype = output_dtype
        self.frame_ms = float(frame_ms)

        self._shard = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            if mesh_axis not in mesh.axis_names:
                raise ConfigError(
                    f"mesh has no axis {mesh_axis!r} (axes: "
                    f"{mesh.axis_names})")
            axis_size = mesh.shape[mesh_axis]
            if self.n_slots % axis_size:
                raise ConfigError(
                    f"n_slots={self.n_slots} must divide evenly over mesh "
                    f"axis {mesh_axis!r} (size {axis_size})")
            self._shard = NamedSharding(mesh, PartitionSpec(mesh_axis))

        sources = list(sources or [])
        if len(sources) > self.n_slots:
            raise ConfigError(
                f"{len(sources)} source sets for {self.n_slots} slots")
        if not sources or sources[0] is None:
            raise ConfigError(
                "SessionPool needs sources for slot 0 at construction: "
                "track native rates fix the pool's frame geometry")

        # --- shared geometry from slot 0 (validated on every join) ---
        # resolve (decode) and build each provided source exactly ONCE:
        # the geometry probe needs only slot 0's native RATES, and the
        # per-slot join() below reuses the prebuilt tracks (review
        # find: sources used to be decoded/copied twice, slot 0 four
        # times)
        K = self.n_slots
        self._slot_tracks: list = [None] * K
        self._frame_idx = np.zeros(K, np.int64)
        resolved = {i: self._resolve(s) for i, s in enumerate(sources)
                    if s is not None}
        base_frame = max(1, int(round(self.frame_ms * self.sr / 1000.0)))
        lcm = 1
        for _, sr_nat in resolved[0]:
            L = self.sr // math.gcd(int(sr_nat), self.sr)
            lcm = lcm * L // math.gcd(lcm, L)
        self.frame_out = -(-base_frame // lcm) * lcm
        built = {i: self._build_tracks(resolved=r)
                 for i, r in resolved.items()}
        geom = built[0]
        self._geom = geom
        self.nch = max((ts.nch for ts in geom), default=config.channels)

        # --- device-resident source buffers (one per track) ---
        init_tracks = list(built.values())
        self._need = [_track_need(ts) for ts in geom]
        self._lmax = []
        for j, gs in enumerate(geom):
            lm = max(tr[j].n_native for tr in init_tracks)
            if max_seconds is not None:
                sr_nat = self.sr * gs.M // gs.L
                lm = max(lm, int(math.ceil(max_seconds * sr_nat)))
            self._lmax.append(lm)
        self._srcbuf = [
            self._commit(jnp.zeros((K, gs.nch, self._need[j] + self._lmax[j]
                                    + self._need[j]), jnp.float32))
            for j, gs in enumerate(geom)
        ]
        self._n_nat = [np.zeros(K, np.int64) for _ in geom]
        self._n_out = [np.zeros(K, np.float64) for _ in geom]

        # scan backend (default): oracle-grade f64 state carry on short
        # frames, identical math to StreamSession (pool == K sessions,
        # tested). "gpu" runs the per-frame effects on the card's engine
        # INSIDE the vmapped step (the kernel's grid gains the slot axis).
        self.voice_effects = _fx.build_chain(
            self.sr, list(config.effects),
            default_backend=self._effects_backend)
        self.master_effects = _fx.build_chain(
            self.sr, list(config.master_effects),
            default_backend=self._effects_backend)
        for e in self.voice_effects + self.master_effects:
            if hasattr(e, "set_streaming"):
                e.set_streaming(self.frame_out)

        self.has_duck = any(ts.cfg.side_duck for ts in geom)
        self.duck_params = dict(duck_params or {})
        self._state0 = self._init_state_single()
        self.states = jax.tree.map(
            lambda s: self._commit(
                jnp.broadcast_to(s[None], (K,) + s.shape)), self._state0)

        self._vslot = jax.vmap(self._make_slot_fn())
        self._scan_steps: dict[int, object] = {}
        self._pending = None  # speculative next group (read prefetch)

        for i, src in enumerate(sources):
            if src is not None:
                self.join(i, src, _tracks=built[i])

    # -- slot lifecycle --------------------------------------------------

    def _commit(self, x):
        """Pin the slot-sharded placement of a leading-K device array.

        Eager slot updates (``.at[slot].set``) and host uploads don't
        reliably inherit the mesh sharding — re-commit after every
        construction/update so the jitted step always sees its inputs
        already laid out K/n-per-device (no resharding transfer in the
        hot read path)."""
        return x if self._shard is None else jax.device_put(x, self._shard)

    def _resolve(self, src) -> list:
        """Decode/fetch each track's (pcm, native_sr) once."""
        from xmtpu.graph.pipeline import resolve_source

        return [resolve_source(t, src, self.sr, i)
                for i, t in enumerate(self.config.tracks)]

    def _build_tracks(self, src=None, resolved=None) -> list:
        if resolved is None:
            resolved = self._resolve(src)
        return [
            _TrackStream(t, pcm, int(sr_nat), self.sr, self.frame_out)
            for t, (pcm, sr_nat) in zip(self.config.tracks, resolved)
        ]

    @_locked
    def join(self, slot: int, sources, _tracks: list | None = None) -> None:
        """Attach a user's sources to ``slot`` (state + clock reset;
        ONE source upload per track — windows are carved on device).

        The slot's track native rates and channel counts must match the
        pool geometry, and each source must fit the pool's buffer
        capacity (the longer of ``max_seconds`` and the longest
        construction-time source)."""
        self._check_slot(slot)
        tracks = _tracks if _tracks is not None else self._build_tracks(sources)
        for j, (ts, gs) in enumerate(zip(tracks, self._geom)):
            if (ts.L, ts.M) != (gs.L, gs.M):
                raise ConfigError(
                    f"slot {slot} track {j}: native rate gives polyphase "
                    f"L/M {ts.L}/{ts.M}, pool geometry is {gs.L}/{gs.M}")
            if ts.nch != gs.nch:
                raise ConfigError(
                    f"slot {slot} track {j}: {ts.nch} channels, pool "
                    f"geometry has {gs.nch}")
            if ts.n_native > self._lmax[j]:
                raise ConfigError(
                    f"slot {slot} track {j}: {ts.n_native} samples exceed "
                    f"the pool source buffer ({self._lmax[j]}); construct "
                    "the pool with a larger max_seconds")
        self._slot_tracks[slot] = tracks
        for j, ts in enumerate(tracks):
            need, lmax = self._need[j], self._lmax[j]
            row = np.zeros((self._geom[j].nch, need + lmax + need),
                           np.float32)
            row[:, need : need + ts.n_native] = ts.pcm
            self._srcbuf[j] = self._commit(
                _set_slot_row(self._srcbuf[j], jnp.asarray(row),
                              jnp.int32(slot)))
            self._n_nat[j][slot] = ts.n_native
            self._n_out[j][slot] = float(ts.n_out)
        for ts in tracks:
            # sources are device-resident from here: keeping the decoded
            # host PCM pinned the whole clip per slot for the life of
            # the join (~GB-scale pools) though only geometry fields are
            # read afterwards (review find)
            ts.pcm = None
        self._frame_idx[slot] = 0
        self._pending = None  # stale windows/state
        self._reset_state(slot)

    @_locked
    def leave(self, slot: int) -> None:
        """Detach ``slot``: its lanes output exact silence until the
        next :meth:`join` (zero source/length + state reset — a
        departed user's filter tails must not ring into the freed
        slot; no retrace)."""
        self._check_slot(slot)
        self._slot_tracks[slot] = None
        for j in range(len(self._geom)):
            self._n_nat[j][slot] = 0
            self._n_out[j][slot] = 0.0
        self._pending = None
        self._reset_state(slot)

    @_locked
    def seek(self, slot: int, ms: float) -> None:
        """Frame-aligned reposition of one slot + state reset (the
        reference's per-handle seek semantics)."""
        self._check_slot(slot)
        sample = int(round(ms * self.sr / 1000.0))
        self._frame_idx[slot] = sample // self.frame_out
        self._pending = None
        self._reset_state(slot)

    @_locked
    def active(self) -> list[int]:
        return [i for i, t in enumerate(self._slot_tracks) if t is not None]

    @_locked
    def at_end(self, slot: int) -> bool:
        """True when ``slot`` is past end-of-stream at its CURRENT clock:
        every non-loop track has been fully produced (the reference's
        get_frame returns <= 0 there — ``compat._next_frame`` applies
        the same rule to single sessions). Loop tracks never end on
        their own; an all-loop slot streams until seek/leave. Empty
        slots are trivially at end."""
        self._check_slot(slot)
        tracks = self._slot_tracks[slot]
        if tracks is None:
            return True
        finite = [ts for ts in tracks if not ts.cfg.loop]
        if not finite:
            return False
        fi = int(self._frame_idx[slot])
        return all(
            (fi * self.frame_out - ts.start_bus) >= ts.n_out
            for ts in finite
        )

    @_locked
    def frames_remaining(self, slot: int) -> int | None:
        """Frames until :meth:`at_end` at the current clock. ``None``
        for loop-only slots (unbounded); ``0`` for empty/ended slots.
        The last counted frame may be partial (a 5 ms tail in a 20 ms
        frame) — the remainder of that frame is exact silence, the
        same group-aligned tail the offline mixer pads."""
        self._check_slot(slot)
        tracks = self._slot_tracks[slot]
        if tracks is None:
            return 0
        finite = [ts for ts in tracks if not ts.cfg.loop]
        if not finite:
            return None
        end = max(ts.start_bus + ts.n_out for ts in finite)
        return max(0, -(-end // self.frame_out) - int(self._frame_idx[slot]))

    def _check_slot(self, slot: int) -> None:
        if not (0 <= slot < self.n_slots):
            raise ConfigError(f"slot {slot} out of range [0, {self.n_slots})")

    def _init_state_single(self):
        from xmtpu.graph.streaming import _session_state0

        return _session_state0(self.voice_effects, self.master_effects,
                               self.nch, self.has_duck)

    def _reset_state(self, slot: int) -> None:
        self.states = jax.tree.map(
            lambda S, s0: self._commit(S.at[slot].set(s0)),
            self.states, self._state0)

    # -- checkpoint/resume (serving failover) ------------------------------

    @_locked
    def save_state(self, path) -> None:
        """Snapshot every slot's DSP state + clock to ``path`` (npz) —
        the serving-failover twin of ``StreamSession.save_state``
        (SURVEY.md §5 checkpoint/resume row). Sources are NOT
        serialized: user audio is re-\\ ``join``\\ ed on restore and the
        snapshot validates it is the same (slot mask + per-track
        native lengths)."""
        leaves = jax.tree_util.tree_leaves(self.states)
        np.savez(
            path,
            frame_out=self.frame_out,
            n_slots=self.n_slots,
            frame_idx=self._frame_idx,
            n_nat=np.stack(self._n_nat) if self._n_nat else np.zeros((0, 0)),
            active=np.array(
                [t is not None for t in self._slot_tracks], bool),
            **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)},
        )

    @_locked
    def load_state_file(self, path) -> None:
        """Restore a :meth:`save_state` snapshot into this pool. The
        pool must have the same config geometry and the SAME sources
        joined in the same slots (validated; the state pytree layout
        itself is reconstructed from the config, as in
        ``StreamSession.load_state_file``)."""
        z = np.load(path)
        if (int(z["frame_out"]) != self.frame_out
                or int(z["n_slots"]) != self.n_slots):
            raise ConfigError(
                "pool snapshot geometry mismatch: saved frame/slot shape "
                f"({int(z['frame_out'])}, {int(z['n_slots'])}) vs this "
                f"pool's ({self.frame_out}, {self.n_slots})")
        active_now = np.array([t is not None for t in self._slot_tracks],
                              bool)
        if not np.array_equal(active_now, z["active"]):
            raise ConfigError(
                "pool snapshot active-slot mask mismatch: join the same "
                "slots before restoring")
        want = (len(self._geom), self.n_slots)
        if z["n_nat"].shape != want:
            # validate BEFORE indexing rows: a snapshot saved from a
            # different-track-count config used to escape as an
            # IndexError instead of the typed refuse
            raise ConfigError(
                f"pool snapshot track table shape {z['n_nat'].shape} != "
                f"{want} (different track count in config?)")
        for j in range(len(self._geom)):
            if not np.array_equal(self._n_nat[j], z["n_nat"][j]):
                raise ConfigError(
                    f"track {j} source lengths differ from the snapshot: "
                    "rejoin the same sources before restoring")
        t_leaves = jax.tree_util.tree_leaves(self.states)
        treedef = jax.tree_util.tree_structure(self.states)
        n_saved = sum(1 for k in z.files if k.startswith("leaf_"))
        if n_saved != len(t_leaves):
            raise ConfigError(
                f"pool snapshot has {n_saved} state leaves, this pool's "
                f"config builds {len(t_leaves)} (different effects chain?)")
        from xmtpu.graph.streaming import coerce_legacy_state_leaf

        leaves = []
        for i, tl in enumerate(t_leaves):
            # pre-round-5 NS snapshots carry one shared lead-in counter
            # per slot ((K,)) where the state now holds per-item
            # counters ((K, ch)); integer prefix leaves broadcast, any
            # other mismatch is a different config (typed refuse)
            v = coerce_legacy_state_leaf(z[f"leaf_{i}"], tl)
            if v is None:
                raise ConfigError(
                    f"pool snapshot state leaf {i} shape "
                    f"{z[f'leaf_{i}'].shape} != {tuple(tl.shape)} "
                    "(different effects config?)")
            leaves.append(self._commit(jnp.asarray(v, tl.dtype)))
        self.states = jax.tree_util.tree_unflatten(treedef, leaves)
        self._frame_idx[:] = z["frame_idx"]
        self._pending = None

    # -- device step -------------------------------------------------------

    def _make_slot_fn(self):
        """Per-slot step: carve each track's source window out of the
        device-resident buffer, then run the shared session step."""
        geom = self._geom
        needs = self._need
        frame_out = self.frame_out
        step1 = _session_step_fn(
            geom, self.voice_effects, self.master_effects, self.nch,
            frame_out, self.has_duck, self.duck_params, self.sr,
            n_out_traced=True,
        )

        def extract(src_row, lo, n_nat, active, need, loop):
            # src_row: (ch, need + lmax + need) with zeros outside the
            # clip — the pads make partial/past-end windows exact zeros
            # with a plain clipped dynamic_slice (no masks)
            if loop:
                ar = jnp.arange(need, dtype=lo.dtype)
                nn = jnp.maximum(n_nat, 1)
                idx = (lo + ar) % nn  # numpy-sign mod: non-negative
                w = jnp.take(src_row[:, need:], idx, axis=-1)
                # f32 zero: a python 0.0 would promote w to f64 under
                # the package-wide x64 mode
                w = jnp.where((lo + ar) >= 0, w, jnp.float32(0))
            else:
                start = jnp.clip(lo + need, 0, src_row.shape[-1] - need)
                w = jax.lax.dynamic_slice(
                    src_row, (0, start), (src_row.shape[0], need))
            return w * active

        def slot_fn(src_rows, fi, n_nats, n_outs, active, state):
            windows, offsets = [], []
            for j, gs in enumerate(geom):
                t0 = fi * frame_out - gs.start_bus  # i64
                if gs.plan is None:
                    lo = t0
                else:
                    c0 = (t0 - gs.r0) // gs.L
                    lo = c0 * gs.M + gs.plan.base - gs.plan.pad_left
                w = extract(src_rows[j], lo, n_nats[j], active,
                            needs[j], bool(gs.cfg.loop))
                windows.append(w)
                offsets.append(t0.astype(jnp.float64))
            return step1(tuple(windows), tuple(offsets), state,
                         tuple(n_outs))

        return slot_fn

    def _make_scan(self, k: int):
        vslot = self._vslot
        K, nch, frame_out = self.n_slots, self.nch, self.frame_out
        to_i16 = self.output_dtype == np.int16

        def scan_fn(srcs, fi0, n_nats, n_outs, active, state):
            def body(st, f):
                out, st = vslot(srcs, fi0 + f, n_nats, n_outs, active, st)
                return st, out

            state, outs = jax.lax.scan(body, state,
                                       jnp.arange(k, dtype=fi0.dtype))
            # outs (k, K, ch, frame) -> (K, ch, k*frame)
            out = jnp.transpose(outs, (1, 2, 0, 3)).reshape(
                K, nch, k * frame_out)
            if to_i16:  # convert on DEVICE: halves the fetch bytes
                out = _convert.f32_to_pcm16(out)
            return out, state

        return jax.jit(scan_fn)

    # -- reading ----------------------------------------------------------

    def _dispatch(self, k: int):
        """Enqueue one K x k group for the current clocks (non-blocking:
        JAX async dispatch; per-group upload = the (K,) clocks and
        per-slot lengths — the sources already live in HBM)."""
        fn = self._scan_steps.pop(k, None)
        if fn is None:
            fn = self._make_scan(k)
            # 16 live sizes: PoolServer.read quantizes pump sizes to
            # powers of two (<= 11 distinct at the default 1024-frame
            # buffer cap), plus the serving loop's own pump k — at 8
            # the end-of-stream pow2 ladder could thrash the cache
            if len(self._scan_steps) >= 16:
                # evict least-RECENTLY-used (re-insertion below is the
                # recency bump): FIFO eviction used to drop the hottest
                # k once 9 distinct group sizes rotated, recompiling a
                # 30-500 s remote executable on every read (review find)
                self._scan_steps.pop(next(iter(self._scan_steps)))
        self._scan_steps[k] = fn
        # np.array COPIES before handing to jax: the host->device
        # transfer can read the source buffer asynchronously, and
        # read()/join()/leave() mutate these numpy arrays in place
        # right after dispatching — without the copy a group
        # intermittently computed with the POST-advance clocks
        # (slot output k frames ahead, measured nondeterministic
        # ~25% of runs on the CPU backend)
        fi0 = self._commit(jnp.asarray(np.array(self._frame_idx)))
        n_nats = tuple(self._commit(jnp.asarray(np.array(a)))
                       for a in self._n_nat)
        n_outs = tuple(self._commit(jnp.asarray(np.array(a)))
                       for a in self._n_out)
        active = self._commit(jnp.asarray(
            np.array([t is not None for t in self._slot_tracks], np.float32)))
        out_dev, states = fn(tuple(self._srcbuf), fi0, n_nats, n_outs,
                             active, self.states)
        return (k, self._frame_idx.copy(), out_dev, states)

    @_locked
    def prime(self, k: int = 1) -> None:
        """Ensure a speculative K x k group is dispatched for the
        CURRENT clocks (non-blocking; no clock advance). The next
        :meth:`read` of the same ``k`` consumes it instead of
        dispatching inline — :meth:`PoolServer.pump` primes EVERY pool
        before fetching any, so when churn (join/leave/seek) has
        dropped the speculative groups the pools' device steps overlap
        instead of paying one dispatch+RTT each in sequence."""
        if k < 1:
            raise ConfigError("prime(k) needs k >= 1")
        pend = self._pending
        if (pend is None or pend[0] != k
                or not np.array_equal(pend[1], self._frame_idx)):
            self._pending = self._dispatch(k)
            try:
                self._pending[2].copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass

    @_locked
    def read(self, k: int = 1) -> np.ndarray:
        """Advance every active slot by k frames -> (K, k*frame, ch) PCM
        (empty slots return silence). ONE device dispatch and ONE host
        fetch for the whole K x k group; the NEXT group is dispatched
        speculatively before this group's fetch, so on a high-RTT host
        link the device computes group g+1 while group g transfers
        (the StreamSession depth-1 prefetch, pooled). Any join/leave/
        seek drops the speculative group (stale windows/state)."""
        if k < 1:
            raise ConfigError("read(k) needs k >= 1")
        pend = self._pending
        if (pend is None or pend[0] != k
                or not np.array_equal(pend[1], self._frame_idx)):
            pend = self._dispatch(k)
        self._pending = None
        _, _, out_dev, self.states = pend
        for i in range(self.n_slots):
            if self._slot_tracks[i] is not None:
                self._frame_idx[i] += k
        self._pending = self._dispatch(k)  # overlap: next group computes
        try:
            # start the speculative group's device->host copy now, so
            # the NEXT read's fetch finds its bytes already in flight
            # (same eager-copy trick as StreamSession._start_host_copy)
            self._pending[2].copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        out = np.moveaxis(np.asarray(out_dev), 1, 2)  # fetch blocks here
        return out
