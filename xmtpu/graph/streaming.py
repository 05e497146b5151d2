"""Streaming session: seek + frame-by-frame reads (BASELINE.json:11).

Reference analogue: the interactive mixer session
(``xm_audio_utils_mixer_init/seek/get_frame``, ``src/xm_audio_utils.c``
[upstream, SURVEY.md §2.1/§3.2]) — a constant-memory frame loop with
carried filter state.

Design (SURVEY.md §3.2): ONE jitted step function with fully
static shapes, re-dispatched per frame; all DSP state is a pytree
carried through it, and each track keeps only a small host-side input
window per frame (decode is host-side by mandate, BASELINE.json:5).
Every frame computes the *same* convolution windows as the offline path,
so streaming == offline to f32 tolerance (the §4.2 invariant, tested in
test_streaming.py).

Geometry: ``frame_out`` bus samples per frame, a multiple of every
track's polyphase L; a track placed at ``start_bus`` has constant block
phase ``r0 = (-start_bus) mod L``, so each frame needs ``nj`` whole
L-blocks from block clock ``c0 = (t0 - r0) / L`` and a static slice
``[r0 : r0 + frame_out]`` — one executable serves all frames.
"""

from __future__ import annotations

import math
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu.config.schema import PipelineConfig, config_from_dict
from xmtpu.graph import fx as _fx
from xmtpu.io import open_audio
from xmtpu.ops import convert as _convert
from xmtpu.ops import resample as _resample
from xmtpu.utils.errors import ConfigError


def coerce_legacy_state_leaf(v, template):
    """Saved-state leaf -> the template's shape, or None on a real
    mismatch. Exact-shape leaves pass through. The one sanctioned
    widening: an INTEGER leaf whose shape is a leading prefix of the
    template's broadcasts over the missing trailing dims — pre-round-5
    NS snapshots carried one shared lead-in counter (scalar per
    session, ``(K,)`` per pool) where the state now holds per-item
    counters shaped like the batch (``ops.ns.stream_init``); the
    broadcast reproduces exactly what the old lockstep counter meant.
    Float DSP leaves (carries, OLA tails, filter states) never
    broadcast — a shape change there is a different config, not a
    version skew."""
    v = np.asarray(v)
    want = tuple(template.shape)
    if v.shape == want:
        return v
    if (np.issubdtype(template.dtype, np.integer)
            and v.ndim < len(want) and v.shape == want[:v.ndim]):
        return np.broadcast_to(
            v.reshape(v.shape + (1,) * (len(want) - v.ndim)), want)
    return None


class _TrackStream:
    """Host-side per-track source geometry + window extraction."""

    def __init__(self, track, pcm, sr_native: int, sr_bus: int, frame_out: int):
        self.cfg = track
        self.sr_bus = sr_bus
        self.frame_out = frame_out
        g = math.gcd(sr_native, sr_bus)
        self.L, self.M = sr_bus // g, sr_native // g
        if frame_out % self.L:
            raise ConfigError(
                f"frame_out {frame_out} not a multiple of track L={self.L}"
            )
        self.plan = (
            _resample.make_plan(self.L, self.M, 24, 9.0) if self.L != self.M else None
        )
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            pcm = _convert.pcm16_to_f32_np(pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if track.end_time_ms is not None:
            # trim the SOURCE to end-start ms, exactly like the offline
            # pipeline (_resolve_tracks): a looped track then wraps the
            # trimmed clip in both modes (round-2 review find — the
            # streaming loop used to mod-wrap the untrimmed source,
            # playing different audio than offline past the trim)
            keep_ms = max(0.0, track.end_time_ms - track.start_time_ms)
            keep_n = int(round(keep_ms * sr_native / 1000.0))
            if keep_n < pcm.shape[0]:
                pcm = pcm[:keep_n]
        self.pcm = np.ascontiguousarray(pcm.T, np.float32)  # (ch, n)
        self.nch = self.pcm.shape[0]
        self.n_native = self.pcm.shape[1]

        self.start_bus = int(round(track.start_time_ms * sr_bus / 1000.0))
        n_out = _resample.resample_output_len(self.n_native, self.L, self.M)
        if track.end_time_ms is not None:
            n_out = min(
                n_out,
                int(round(track.end_time_ms * sr_bus / 1000.0)) - self.start_bus,
            )
        self.n_out = max(n_out, 0)  # track length at bus rate (pre-loop)
        # constant block phase: t0 mod L for every frame (see module doc)
        self.r0 = (-self.start_bus) % self.L
        self.nj = frame_out // self.L + (1 if self.r0 else 0)

    def window_always(self, frame_idx: int):
        """(host window array, track-local offset t0) for this frame.
        Never None: out-of-range regions come back as zero windows
        (exact silence — `_gather` zero-fills), so a fixed-shape window
        exists for every frame. Load-bearing invariant: a None-for-
        silent shortcut would change the step's argument pytree
        whenever a track starts or ends mid-stream, retracing the
        jitted step (a compile stall mid-stream) — do not reintroduce
        one."""
        t0 = frame_idx * self.frame_out - self.start_bus
        if self.plan is None:
            idx = np.arange(t0, t0 + self.frame_out)
            return self._gather(idx), t0
        c0 = (t0 - self.r0) // self.L
        p = self.plan
        need = _resample.plan_rows(p, self.nj) * p.M
        lo = c0 * p.M + p.base - p.pad_left
        return self._gather(np.arange(lo, lo + need)), t0

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        """pcm[:, idx] with zeros outside [0, n_native); loops wrap
        non-negative indices (BGM looping, reference mixer semantics)."""
        if self.cfg.loop and self.n_native > 0:
            w = self.pcm[:, np.mod(idx, self.n_native)].copy()
            w[:, idx < 0] = 0.0
            return w
        valid = (idx >= 0) & (idx < self.n_native)
        w = np.zeros((self.nch, len(idx)), np.float32)
        w[:, valid] = self.pcm[:, idx[valid]]
        return w

    def windows_block(self, frame_idx: int, k: int):
        """Vectorized :meth:`window_always` for k consecutive frames ->
        (W (k, nch, need), t0s (k,) f64). Consecutive frames' source
        windows advance by a CONSTANT stride, so the whole group is one
        union-range gather + k strided views — the per-frame Python
        loop was the serving pool's host bottleneck (round 3)."""
        t0s = (np.arange(frame_idx, frame_idx + k, dtype=np.float64)
               * self.frame_out - self.start_bus)
        if self.plan is None:
            lo0 = frame_idx * self.frame_out - self.start_bus
            u = self._gather(np.arange(lo0, lo0 + k * self.frame_out))
            w = np.ascontiguousarray(
                u.reshape(self.nch, k, self.frame_out).swapaxes(0, 1))
            return w, t0s
        p = self.plan
        need = _resample.plan_rows(p, self.nj) * p.M
        step = (self.frame_out // self.L) * p.M  # per-frame source stride
        t0_0 = frame_idx * self.frame_out - self.start_bus
        lo0 = (t0_0 - self.r0) // self.L * p.M + p.base - p.pad_left
        u = self._gather(np.arange(lo0, lo0 + (k - 1) * step + need))
        w = np.empty((k, self.nch, need), np.float32)
        for f in range(k):  # k slice-copies of views (cheap)
            w[f] = u[:, f * step : f * step + need]
        return w, t0s


class StreamSession:
    """Streaming mixer+effects session (reference handle-API parity).

    Latency budget: each :meth:`read` call costs one device->host
    fetch, so FIRST-frame latency has a hard floor of ONE host<->device
    round trip on top of the frame compute. The depth-1 default
    overlaps compute with the fetch. ``prefetch_depth=d`` dispatches d
    frames ahead and starts each one's device->host copy eagerly
    (``copy_to_host_async``), giving every copy ~d frame-periods of
    lead — at d*frame_ms > RTT the sustained read cadence is no longer
    RTT-bound (at the cost of d frames of speculative work discarded
    on seek). For pure throughput use :meth:`read_many`, which
    amortizes one round trip over k frames.
    """

    def __init__(self, config, frame_ms: float = 20.0, sources=None,
                 output_dtype=np.int16, duck_params: dict | None = None,
                 prefetch_depth: int = 1):
        if isinstance(config, dict):
            config = config_from_dict(config)
        if not isinstance(config, PipelineConfig):
            raise ConfigError("config must be PipelineConfig or dict")
        self.config = config
        self.sr = config.sample_rate
        self.output_dtype = output_dtype

        base_frame = max(1, int(round(frame_ms * self.sr / 1000.0)))
        from xmtpu.graph.pipeline import resolve_source

        resolved = []
        lcm = 1
        for i, t in enumerate(config.tracks):
            pcm, sr_nat = resolve_source(t, sources, self.sr, i)
            g = math.gcd(int(sr_nat), self.sr)
            L = self.sr // g
            lcm = lcm * L // math.gcd(lcm, L)
            resolved.append((t, pcm, int(sr_nat)))
        self.frame_out = -(-base_frame // lcm) * lcm
        self.tracks = [
            _TrackStream(t, pcm, sr_nat, self.sr, self.frame_out)
            for (t, pcm, sr_nat) in resolved
        ]

        self.nch = max((ts.nch for ts in self.tracks), default=config.channels)
        # reference chain placement (SURVEY.md §3.1): config.effects run
        # on the summed VOICE bus at the bus rate, pre-mix;
        # master_effects run post-mix. The offline pipeline applies them
        # at the SAME point (mixer.mix voice_effects), so streaming ==
        # offline holds for any chain and any track native rate (§4.2).
        # default_backend="scan": streaming frames are short (compile
        # is cheap) and the f64 scan twins carry state at oracle grade;
        # an effect's params can still name another engine
        self.voice_effects = _fx.build_chain(self.sr, list(config.effects),
                                             default_backend="scan")
        self.master_effects = _fx.build_chain(self.sr,
                                              list(config.master_effects),
                                              default_backend="scan")
        for e in self.voice_effects + self.master_effects:
            if hasattr(e, "set_streaming"):  # needs the frame geometry
                e.set_streaming(self.frame_out)
        # side-chain ducking (reference BGM-under-voice) carries its own
        # envelope state; chain it into the session state pytree.
        # NOTE (documented divergence from the offline mixer): looped
        # tracks never fade out under a session (no known end), and loop
        # seams are resampled as a continuous stream (mod-wrap before
        # resampling) rather than tiling the resampled clip.
        self.has_duck = any(ts.cfg.side_duck for ts in self.tracks)
        self.duck_params = dict(duck_params or {})
        self.fx_state = self._init_state()
        self.frame_idx = 0
        self._step = jax.jit(self._make_step())
        # dispatch-ahead prefetch (BASELINE.json:11): the next
        # ``prefetch_depth`` frames' steps are dispatched before the
        # current frame's host fetch, AND each one's device->host copy
        # is started eagerly (``copy_to_host_async``), so by the time
        # read() asks for a frame its bytes are already in flight.
        # depth 1 = the classic double buffer (compute overlaps fetch;
        # an RTT > frame_ms link still can't serve real time); depth d
        # gives each frame's host copy ~d frame-periods of lead time.
        # JAX's async dispatch chains on device values without host
        # sync, so deeper dispatch costs no blocking; a seek simply
        # discards the speculative frames.
        if int(prefetch_depth) < 1:
            raise ConfigError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.prefetch_depth = int(prefetch_depth)
        self._queue = deque()  # dispatched-ahead (frame_idx, out, state)
        self._scan_step = None  # lazy jitted k-frame scan (read_many)

    def _init_state(self):
        """Session state pytree: (voice fx, master fx, duck envelope)."""
        return _session_state0(self.voice_effects, self.master_effects,
                               self.nch, self.has_duck)

    # -- device step ---------------------------------------------------------

    def _make_step(self):
        step = _session_step_fn(
            self.tracks, self.voice_effects, self.master_effects, self.nch,
            self.frame_out, self.has_duck, self.duck_params, self.sr,
        )
        if self.output_dtype != np.int16:
            return step

        def step_i16(windows, offsets, state):
            # convert on DEVICE (pinned round-half-away twin, bit-exact
            # vs the numpy path): halves every fetch's bytes — and the
            # prefetch_depth eager copies' — exactly as the pool does
            # (review find: the session fetched f32 and converted on
            # host, doubling per-frame traffic on the links the depth
            # feature targets)
            out, st = step(windows, offsets, state)
            return _convert.f32_to_pcm16(out), st

        return step_i16

    # -- public API ------------------------------------------------------------

    def seek(self, ms: float) -> None:
        """Reposition the output clock (frame-aligned, pinned) and reset
        filter state — reference semantics (SURVEY.md §3.2)."""
        sample = int(round(ms * self.sr / 1000.0))
        self.frame_idx = sample // self.frame_out
        self.fx_state = self._init_state()
        self._queue.clear()  # drop prefetched frames (stale DSP state)

    def _dispatch(self, frame_idx: int, fx_state):
        """Enqueue one frame's device step (non-blocking).

        Windows come from ``window_always`` (zero-filled outside the
        track, never None) so the step's argument pytree structure is
        IDENTICAL for every frame: one jitted executable serves the
        whole stream. The earlier None-for-silent shortcut changed the
        pytree whenever a track started or ended mid-stream, retracing
        the step (a compile stall mid-stream)."""
        windows, offsets = [], []
        for ts in self.tracks:
            w, t0 = ts.window_always(frame_idx)
            windows.append(jnp.asarray(w))
            # f64 offsets end-to-end: f32 truncates t0 above 2^24
            # (~17.5 min @16k), shifting placement masks and fades
            offsets.append(jnp.float64(t0))
        out, state = self._step(tuple(windows), tuple(offsets), fx_state)
        return (frame_idx, out, state)

    @staticmethod
    def _start_host_copy(item) -> None:
        """Begin the device->host transfer of a dispatched frame's
        output without blocking (jax.Array.copy_to_host_async); by
        fetch time the bytes are already moving/landed."""
        try:
            item[1].copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass  # tracers / backends without async copy: fetch blocks

    def _fill_queue(self) -> None:
        """Top the dispatch-ahead queue up to ``prefetch_depth``
        frames past the last queued (or consumed) frame, chaining
        states through device values (no host sync)."""
        while len(self._queue) < self.prefetch_depth:
            if self._queue:
                tail_idx, _, tail_state = self._queue[-1]
            else:
                tail_idx, tail_state = self.frame_idx - 1, self.fx_state
            item = self._dispatch(tail_idx + 1, tail_state)
            self._start_host_copy(item)
            self._queue.append(item)

    def read(self) -> np.ndarray:
        """Next (frame_out, ch) PCM frame (dispatch-ahead, see
        ``prefetch_depth``)."""
        if not self._queue or self._queue[0][0] != self.frame_idx:
            self._queue.clear()
        self._fill_queue()
        idx, out_dev, state = self._queue.popleft()
        self.fx_state = state
        self.frame_idx = idx + 1
        self._fill_queue()  # overlap: next frames compute + copy out
        # (frame, ch) — lands the copy; already output_dtype (int16
        # conversion runs on device, see _make_step)
        return np.asarray(out_dev).T

    def read_many(self, k: int) -> np.ndarray:
        """Read k frames with ONE device dispatch and ONE host fetch ->
        (k*frame_out, ch).

        The k per-frame steps fuse into a single jitted ``lax.scan``
        (state chains inside the scan), so a high-RTT host link pays one
        round-trip per GROUP instead of per frame — the throughput mode
        for the 20 ms path (frame math identical to :meth:`read`,
        asserted in tests). Compiles once per distinct k.
        """
        if self._scan_step is None:
            self._scan_step = jax.jit(self._make_scan())
        wstacks = []
        ostacks = []
        for ts in self.tracks:
            ws, os_ = ts.windows_block(self.frame_idx, k)
            wstacks.append(jnp.asarray(ws))
            ostacks.append(jnp.asarray(os_))
        out_dev, state = self._scan_step(tuple(wstacks), tuple(ostacks),
                                         self.fx_state)
        self.fx_state = state
        self.frame_idx += k
        self._queue.clear()
        # (k*frame, ch) — already output_dtype (device-side conversion)
        return np.asarray(out_dev).T

    def _make_scan(self):
        step = self._make_step()

        def scan_fn(wstacks, ostacks, state):
            def body(st, xs):
                ws, os_ = xs
                out, st = step(ws, os_, st)
                return st, out

            state, outs = jax.lax.scan(body, state, (wstacks, ostacks))
            # outs: (k, ch, frame) -> (ch, k*frame)
            return (
                jnp.moveaxis(outs, 0, 1).reshape(outs.shape[1], -1),
                state,
            )

        return scan_fn

    @property
    def state(self):
        """Serializable session state — pause/resume (SURVEY.md §5)."""
        return {
            "frame_idx": self.frame_idx,
            "fx_state": self.fx_state,
            "frame_out": self.frame_out,
        }

    def load_state(self, st) -> None:
        if st["frame_out"] != self.frame_out:
            raise ConfigError("state frame size mismatch")
        # Typed refuse AT RESTORE, like load_state_file: a state from a
        # session with a different effects chain or channel count can
        # share frame_out, and installing it unchecked used to surface
        # as an opaque jit pytree/shape error at the NEXT read()
        # (review find).
        template = self._init_state()
        t_leaves, treedef = jax.tree_util.tree_flatten(template)
        leaves, got_def = jax.tree_util.tree_flatten(st["fx_state"])
        if got_def != treedef:
            raise ConfigError(
                "state does not match this session's effects chain "
                f"(expected {len(t_leaves)} leaves of the config's "
                "structure)")
        coerced = []
        for a, b in zip(leaves, t_leaves):
            c = coerce_legacy_state_leaf(a, b)
            if c is None:
                raise ConfigError(
                    "state does not match this session's effects chain "
                    f"(leaf shape {np.shape(a)} != {tuple(b.shape)})")
            coerced.append(jnp.asarray(c, b.dtype)
                           if np.shape(c) != np.shape(a) else a)
        self.frame_idx = int(st["frame_idx"])
        self.fx_state = jax.tree_util.tree_unflatten(treedef, coerced)
        self._queue.clear()

    def save_state(self, path) -> None:
        """Persist the session state to disk (npz of pytree leaves; the
        tree structure is reconstructed from the config on load)."""
        leaves = jax.tree_util.tree_leaves(self.fx_state)
        np.savez(
            path,
            frame_idx=self.frame_idx,
            frame_out=self.frame_out,
            **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)},
        )

    def load_state_file(self, path) -> None:
        z = np.load(path)
        if int(z["frame_out"]) != self.frame_out:
            raise ConfigError("state frame size mismatch")
        template = self._init_state()
        treedef = jax.tree_util.tree_structure(template)
        t_leaves = jax.tree_util.tree_leaves(template)
        leaves = [
            jnp.asarray(z[f"leaf_{i}"], t_leaves[i].dtype)
            for i in range(len(t_leaves))
        ]
        self.fx_state = jax.tree_util.tree_unflatten(treedef, leaves)
        self.frame_idx = int(z["frame_idx"])
        self._queue.clear()


def _session_state0(voice_effects, master_effects, nch: int, has_duck: bool):
    """Session state pytree (voice fx, master fx, duck envelope) — ONE
    definition shared by StreamSession and SessionPool so the vmapped
    pool state can never drift from the single-session layout (review
    find: the pool carried a verbatim copy)."""
    vfx = _fx.chain_init_state(voice_effects, nch)
    mfx = _fx.chain_init_state(master_effects, nch)
    if not has_duck:
        return (vfx, mfx, ())
    z = jnp.zeros((nch,), jnp.float64)
    return (vfx, mfx, (z, z))


def _session_step_fn(tracks, voice_effects, master_effects, nch: int,
                     frame_out: int, has_duck: bool, duck_params, sr: int,
                     n_out_traced: bool = False):
    """Build the per-frame device step shared by :class:`StreamSession`
    and the pooled serving mode (:class:`xmtpu.graph.pool.SessionPool`).

    ``n_out_traced``: when True the step takes an extra ``n_outs``
    argument (one f64 scalar per track) instead of baking each track's
    static length — pool slots share ONE executable across sessions
    whose sources differ in length.
    """

    def step(windows, offsets, state, n_outs=None):
        vfx_state, mfx_state, duck_state = state
        # three buses: voice-kind tracks (get config.effects and drive
        # the duck envelope), side-ducked tracks, everything else
        voice = jnp.zeros((nch, frame_out), jnp.float32)
        ducked = jnp.zeros((nch, frame_out), jnp.float32)
        other = jnp.zeros((nch, frame_out), jnp.float32)
        for k, (ts, w, off) in enumerate(zip(tracks, windows, offsets)):
            # w is never None (window_always invariant: fixed pytree)
            if ts.plan is None:
                y = w
            else:
                y = _resample.resample_window(w, ts.plan, ts.nj)
                y = y[..., ts.r0 : ts.r0 + frame_out]
            y = _track_env(y, ts, off,
                           n_out=(n_outs[k] if n_out_traced else None))
            if y.shape[0] == 1 and nch > 1:
                y = jnp.broadcast_to(y, (nch, frame_out))
            if ts.cfg.side_duck:
                ducked = ducked + y
            elif ts.cfg.kind == "voice":
                voice = voice + y
            else:
                other = other + y
        voice, vfx_state = _fx.chain_apply(voice_effects, voice,
                                           vfx_state)
        if has_duck:
            from xmtpu.ops.mix import duck_gain_block

            # offline parity: the envelope keys off ALL non-ducked
            # tracks (mixer.py builds its voice bus the same way)
            g, duck_state = duck_gain_block(voice + other, sr,
                                            duck_state, **duck_params)
            acc = voice + other + ducked * g.astype(jnp.float32)
        else:
            acc = voice + other
        out, mfx_state = _fx.chain_apply(master_effects, acc, mfx_state)
        return out, (vfx_state, mfx_state, duck_state)

    return step


def _track_env(y, ts: _TrackStream, off, n_out=None):
    """Gain + fades + placement mask at track-local offset ``off``
    (a traced scalar — one executable serves all frames; ramps computed
    from scalar params in-kernel per SURVEY.md §3.4). ``n_out``: traced
    track length override (pool mode); None bakes the static length."""
    t = ts.cfg
    n = y.shape[-1]
    sr = ts.sr_bus
    if n_out is None:
        n_out = float(ts.n_out)
    else:
        n_out = jnp.asarray(n_out, jnp.float64)
    # f64 indices: f32 loses integer precision past 2^24 samples (~6 min
    # at 48 kHz), which would step the ramps and shift the placement mask
    i = jnp.arange(n, dtype=jnp.float64) + off.astype(jnp.float64)
    g = jnp.full((n,), float(t.volume), jnp.float64)
    fade_in = int(round(t.fade_in_ms * sr / 1000.0))
    fade_out = int(round(t.fade_out_ms * sr / 1000.0))
    if fade_in > 0:
        g = g * jnp.clip((i + 1.0) / float(fade_in), None, 1.0)
    if fade_out > 0 and not t.loop:
        g = g * jnp.clip((n_out - i) / float(fade_out), 0.0, 1.0)
    if t.loop:
        g = jnp.where(i >= 0, g, 0.0)
    else:
        g = jnp.where((i >= 0) & (i < n_out), g, 0.0)
    return y * g[None, :].astype(y.dtype)
