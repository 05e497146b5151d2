"""Effect-chain stage: ordered effects over a PCM stream.

Reference analogue: the voice-effects chain (``xm_audio_effects.c``
[upstream, SURVEY.md §2.1] — ordered NS -> EQ -> reverb -> volume ->
limiter over a voice stream). All of those are implemented here (plus a
finite-ratio compressor); the headline chain per ``BASELINE.json:9`` is
EQ -> reverb -> limiter.

Each effect is a small object with ``init_state`` / ``apply`` so the
same code serves the offline whole-clip path and the streaming
block-carry path (M6): state is a pytree, apply is pure and jittable.
The chain compiles once per (chain-config, input-shape) and is cached.
"""

from __future__ import annotations

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu import engine as _engine
from xmtpu.ops import biquad as _biquad
from xmtpu.ops import limiter as _limiter
from xmtpu.ops import reverb as _reverb
from xmtpu.utils.errors import ConfigError


def _as_batch_shape(batch_shape) -> tuple:
    """init_state accepts the legacy ``nch`` int or a full batch shape
    tuple (..., ch) — batched clips carry per-clip state."""
    if isinstance(batch_shape, (tuple, list)):
        return tuple(int(b) for b in batch_shape)
    return (int(batch_shape),)


class EqualizerFx:
    """Cascaded RBJ biquad EQ. params: bands=[{freq_hz, gain_db, q,
    kind}], backend (an ``xmtpu.engine`` name). Both engines filter with
    the f64 scan; on the card's engine an EQ next to a reverb folds into
    its impulse response (:func:`_fold_lti`)."""

    PARAMS = frozenset({"bands", "backend"})

    def __init__(self, sample_rate: int, params):
        p = dict(params)
        bands = p.get("bands")
        if not bands:
            raise ConfigError("equalizer: 'bands' is required and non-empty")
        if not isinstance(bands, (list, tuple)) or not all(
                isinstance(b, dict) for b in bands):
            # bands=True / bands=3.5 crashed at list(bands) with a bare
            # TypeError (chain fuzzer find)
            raise ConfigError(
                f"equalizer: 'bands' must be a list of objects, got "
                f"{bands!r}")
        try:
            self.sos = _biquad.eq_sos(list(bands), sample_rate)
        except (TypeError, ValueError, KeyError) as e:
            if isinstance(e, ConfigError):
                raise
            raise ConfigError(f"equalizer: bad band: {e}") from e
        self.engine, self.interpret = _engine.resolve(p.get("backend"))

    def init_state(self, batch_shape):
        bs = _as_batch_shape(batch_shape)
        return jnp.zeros((self.sos.shape[0],) + bs + (2,), jnp.float64)

    def apply(self, x, state):
        return _biquad.sosfilt_scan(self.sos, x, zi=state)


class ReverbFx:
    """FIR reverb. params: ir (array) | ir_wav (path) | ir_seconds, wet,
    dry, backend (an ``xmtpu.engine`` name: both engines run the XLA
    FFT convolution; the card's engine folds adjacent EQs into it)."""

    PARAMS = frozenset({"ir", "ir_wav", "ir_seconds", "rt60", "seed",
                        "wet", "dry", "backend"})

    def __init__(self, sample_rate: int, params):
        p = dict(params)
        try:
            self.wet = float(p.get("wet", 0.3))
            self.dry = float(p.get("dry", 0.7))
            ir_seconds = float(p.get("ir_seconds", 0.5))
        except (TypeError, ValueError) as e:
            # float('0.5s') used to leak its bare ValueError from the
            # validation line itself (review find)
            raise ConfigError(f"reverb: non-numeric parameter: {e}") from e
        if not (np.isfinite(self.wet) and np.isfinite(self.dry)):
            raise ConfigError(
                f"reverb: wet/dry must be finite, got {self.wet}/{self.dry}")
        if "ir_seconds" in p and not ir_seconds > 0:
            raise ConfigError(
                f"reverb: ir_seconds must be > 0, got {p['ir_seconds']}")
        if "ir" in p:
            try:
                ir = np.asarray(p["ir"], np.float64)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"reverb: non-numeric ir: {e}") from e
            if ir.size == 0:
                # an empty IR used to surface as an opaque broadcast
                # TypeError deep in the convolution (fuzz find)
                raise ConfigError("reverb: ir must be non-empty")
            if ir.ndim != 1:
                # a (n, 2) stereo IR used to crash with an opaque
                # shape error at the first apply() (review find: a
                # serving process should reject a bad config at
                # session build, not at the first client read)
                raise ConfigError(
                    f"reverb: ir must be 1-D mono, got shape {ir.shape}")
            if not np.all(np.isfinite(ir)):
                raise ConfigError("reverb: ir contains NaN/inf")
        elif "ir_wav" in p:
            from xmtpu.io.wav import read_wav
            from xmtpu.ops import convert as _c

            pcm, ir_sr = read_wav(p["ir_wav"])
            if pcm.ndim > 1:
                pcm = pcm[:, 0]
            ir = _c.pcm16_to_f32_np(pcm).astype(np.float64)
            if ir_sr != sample_rate:
                from xmtpu.ops.resample import resample_oracle_np

                ir = resample_oracle_np(ir, ir_sr, sample_rate)
        else:
            ir = _reverb.synthetic_ir(
                float(p.get("ir_seconds", 0.5)), sample_rate,
                rt60=p.get("rt60"), seed=int(p.get("seed", 7)),
            )
        self.ir = ir.astype(np.float32)
        self.engine, self.interpret = _engine.resolve(p.get("backend"))
        self.block = _reverb.os_block(len(self.ir))

    def init_state(self, batch_shape):
        return _reverb.reverb_tail_init(_as_batch_shape(batch_shape),
                                        len(self.ir))

    def apply(self, x, state):
        ir = np.asarray(self.ir, x.dtype)  # host constant
        if state is None:  # whole-clip: overlap-save, no tail carry
            y = _reverb.reverb(x, ir, wet=self.wet, dry=self.dry,
                               block=self.block)
            return y, None
        return _reverb.reverb_block(x, ir, state, wet=self.wet, dry=self.dry)


class FusedLTIFx:
    """One combined-IR FIR stage standing in for an adjacent run of LTI
    effects (EQ / reverb / volume) on the card's engine.

    The run is a composition of LTI systems, so it equals convolution
    with ONE combined impulse response (host-precomputed in f64:
    ``ops.biquad.sos_impulse_np`` truncates each EQ cascade at a
    -120 dB l1 tail; reverb contributes ``dry*delta + wet*ir``; volume
    a scalar). The EQ recurrence then costs nothing: the FFT
    convolution the reverb already runs does it.

    Reference analogue: the separate EQ and reverb C loops of the voice
    chain (``xm_audio_effects.c`` [upstream, SURVEY.md §2.1]) — here
    fused because both are LTI, which the reference's in-place
    sample-loop architecture cannot see.

    State is the overlap-add tail (``m-1`` samples), as
    :class:`ReverbFx`'s, so blocked mode stays block-size invariant.
    """

    def __init__(self, ir: np.ndarray, folded: tuple):
        self.ir = np.ascontiguousarray(ir, np.float32)
        self.block = _reverb.os_block(len(self.ir))
        self.folded = folded  # the effect objects this stage replaces

    def init_state(self, batch_shape):
        return _reverb.reverb_tail_init(_as_batch_shape(batch_shape),
                                        len(self.ir))

    def apply(self, x, state):
        ir = np.asarray(self.ir, x.dtype)  # host constant
        if state is None:
            return _reverb.reverb(x, ir, wet=1.0, dry=0.0,
                                  block=self.block), None
        return _reverb.reverb_block(x, ir, state, wet=1.0, dry=0.0)


def _lti_ir(fx):
    """The effect's (finite) impulse response in f64, or None if it is
    not foldable — not LTI, not on the card's engine, or an IIR whose
    response will not truncate."""
    if isinstance(fx, VolumeFx):
        return np.array([fx.gain], np.float64)
    if isinstance(fx, EqualizerFx) and fx.engine == _engine.GPU:
        return _biquad.sos_impulse_np(fx.sos)
    if isinstance(fx, ReverbFx) and fx.engine == _engine.GPU:
        h = fx.wet * fx.ir.astype(np.float64)
        h[0] += fx.dry
        return h
    return None


def _fold_lti(effects):
    """Collapse maximal adjacent runs of foldable LTI effects that
    contain at least one card-engine reverb into FusedLTIFx stages (the
    reverb's convolution is already being paid; EQs and volumes along
    for the ride are free). Runs without a reverb keep their exact
    per-effect scans."""
    out, run = [], []

    def flush():
        if any(isinstance(f, ReverbFx) for f, _ in run) and len(run) > 1:
            h = np.ones(1, np.float64)
            for _, hi in run:
                h = np.convolve(h, hi)
            # re-trim: the composition can decay sooner than the parts
            out.append(FusedLTIFx(_reverb.trim_ir_tail(h),
                                  tuple(f for f, _ in run)))
        else:
            out.extend(f for f, _ in run)
        run.clear()

    for fx in effects:
        h = _lti_ir(fx)
        if h is not None:
            run.append((fx, h))
        else:
            flush()
            out.append(fx)
    flush()
    return out


class LimiterFx:
    """Soft-knee limiter. params: threshold_db, knee_db, attack_ms,
    release_ms, ceiling_db, backend (an ``xmtpu.engine`` name: the card's
    engine runs the envelope kernel, the XLA engine the f64 scans)."""

    PARAMS = frozenset({"threshold_db", "knee_db", "attack_ms",
                        "release_ms", "ceiling_db", "backend"})

    def __init__(self, sample_rate: int, params):
        p = dict(params)
        self.sr = sample_rate
        self.backend = p.get("backend")
        self.engine, self.interpret = _engine.resolve(self.backend)
        self.kw = dict(
            threshold_db=float(p.get("threshold_db", -3.0)),
            knee_db=float(p.get("knee_db", 6.0)),
            attack_ms=float(p.get("attack_ms", 1.0)),
            release_ms=float(p.get("release_ms", 100.0)),
            ceiling_db=float(p.get("ceiling_db", 0.0)),
        )

    def init_state(self, batch_shape):
        bs = _as_batch_shape(batch_shape)[:-1]  # channels are linked
        dt = jnp.float32 if self.engine == _engine.GPU else jnp.float64
        return (jnp.zeros(bs, dt), jnp.zeros(bs, dt))

    def apply(self, x, state):
        return _limiter.limiter(x, self.sr, state=state,
                                backend=self.backend, **self.kw)


class CompressorFx(LimiterFx):
    """SoX-compand-style downward compressor (finite ratio + makeup).

    params: threshold_db, ratio, knee_db, attack_ms, release_ms,
    makeup_db, ceiling_db. Shares the limiter's envelope machinery
    (reference: the compand-style limiter/compressor, SURVEY.md §2.1).
    """

    PARAMS = LimiterFx.PARAMS | {"ratio", "makeup_db"}

    def __init__(self, sample_rate: int, params):
        p = dict(params)
        super().__init__(sample_rate, p)
        self.kw["ratio"] = float(p.get("ratio", 4.0))
        self.kw["makeup_db"] = float(p.get("makeup_db", 0.0))
        try:
            # validate NOW (a serving process should reject a bad
            # config at session build, not at the first client read —
            # review find); _knee_slope re-raises the same check later
            _limiter._knee_slope(self.kw["ratio"])
        except ValueError as e:
            raise ConfigError(f"compressor: {e}") from e


class NoiseSuppressFx:
    """STFT Wiener noise suppression.

    params: nfft, noise_frames, smooth, floor. Offline chains process
    the whole clip in one transform stack; under a streaming session
    (:meth:`set_streaming`) it switches to the causal frame-carry twin
    (``ops.ns.stream_suppress``: nfft adapts to the session frame so
    the hop divides every block; output delayed by nfft/2 samples,
    lead-in frames pass at unity while the noise estimate builds —
    matches the offline gains exactly after the lead-in, tested).
    """

    # NO "backend": this effect has exactly one (XLA STFT) engine — an
    # advertised-but-ignored backend key would be the silently-ignored-
    # parameter failure mode the PARAMS gate exists to kill (review
    # find). build_chain's default_backend injection checks membership,
    # so chain-wide defaults skip this effect cleanly.
    PARAMS = frozenset({"nfft", "noise_frames", "smooth", "floor",
                        "noise_update", "noise_smooth",
                        "presence_thresh", "up_leak"})

    def __init__(self, sample_rate: int, params):
        p = dict(params)
        self.kw = dict(
            nfft=int(p.get("nfft", 512)),
            noise_frames=int(p.get("noise_frames", 8)),
            smooth=float(p.get("smooth", 0.7)),
            floor=float(p.get("floor", 0.1)),
            noise_update=str(p.get("noise_update", "frozen")),
            noise_smooth=float(p.get("noise_smooth", 0.95)),
            presence_thresh=float(p.get("presence_thresh", 4.0)),
            up_leak=float(p.get("up_leak", 1.02)),
        )
        self._stream_nfft = None

    def set_streaming(self, frame_len: int) -> None:
        if frame_len % 2:
            raise ConfigError(
                f"streaming noise_suppression needs an even frame, got {frame_len}"
            )
        self._stream_nfft = int(frame_len)

    def init_state(self, batch_shape):
        if self._stream_nfft is None:
            return ()
        from xmtpu.ops import ns as _ns

        bs = _as_batch_shape(batch_shape)
        # state carries the full leading batch shape — (ch,) for a
        # single session, (B, ch) for batched streaming; items advance
        # in lockstep (ops.ns.stream_suppress docstring)
        return _ns.stream_init(bs, nfft=self._stream_nfft,
                               noise_frames=self.kw["noise_frames"])

    def apply(self, x, state):
        from xmtpu.ops import ns as _ns

        if self._stream_nfft is None:
            return _ns.suppress(x, **self.kw), state
        kw = dict(self.kw)
        kw["nfft"] = self._stream_nfft
        return _ns.stream_suppress(x, state, **kw)


class VolumeFx:
    """Static gain. params: gain_db | gain (linear)."""

    PARAMS = frozenset({"gain", "gain_db"})

    def __init__(self, sample_rate: int, params):
        p = dict(params)
        if "gain" in p:
            self.gain = float(p["gain"])
        else:
            self.gain = float(10.0 ** (float(p.get("gain_db", 0.0)) / 20.0))
        if not np.isfinite(self.gain):
            raise ConfigError(
                f"volume: gain must be finite, got {self.gain} "
                f"(params {params!r})")

    def init_state(self, batch_shape):
        return ()

    def apply(self, x, state):
        return x * jnp.asarray(self.gain, x.dtype), state


_EFFECTS = {
    "equalizer": EqualizerFx,
    "eq": EqualizerFx,
    "reverb": ReverbFx,
    "limiter": LimiterFx,
    "compressor": CompressorFx,
    "volume": VolumeFx,
    "noise_suppression": NoiseSuppressFx,
    "ns": NoiseSuppressFx,
}


def build_chain(sample_rate: int, chain, default_backend: str | None = None,
                fold: bool = True):
    """Resolve a list of EffectConfig/dicts into effect objects.

    ``default_backend``: engine for effects that don't name one in
    their params (see :func:`xmtpu.engine.resolve`). None = per-effect
    "auto" (the platform's engine). Streaming sessions pass "scan" to
    keep the oracle-grade f64 state-carry twins on their short frames.

    ``fold``: collapse adjacent card-engine LTI runs (EQ/reverb/volume)
    into single combined-IR FIR stages (:class:`FusedLTIFx`) —
    semantics-preserving to ~-120 dB; False keeps every effect its own
    stage (oracle comparisons, debugging).
    """
    out = []
    for e in chain:
        if hasattr(e, "name"):
            name, params = e.name, dict(e.params)
        else:
            if not isinstance(e, dict):
                # a non-dict entry (float, None, string) crashed at
                # dict(e) with a bare TypeError (chain fuzzer find)
                raise ConfigError(
                    f"effect entry must be an object with a 'name': {e!r}")
            d = dict(e)
            if "name" not in d:
                raise ConfigError(f"effect entry missing 'name': {e!r}")
            name = d.pop("name")
            if "params" in d:
                pv = d.pop("params")
                if not isinstance(pv, dict):
                    # params=3.5 crashed at dict() with a bare
                    # TypeError (chain fuzzer find)
                    raise ConfigError(
                        f"{name}: 'params' must be an object, got {pv!r}")
                params = dict(pv)
                if d:
                    # a key sitting NEXT to an explicit 'params' dict
                    # (e.g. a top-level 'backend') used to be silently
                    # dropped, bypassing the unknown-parameter gate
                    # below (review find)
                    raise ConfigError(
                        f"{name}: unexpected top-level key(s) "
                        f"{sorted(d)} alongside 'params' — put effect "
                        f"parameters inside 'params'")
            else:
                params = d
        if not isinstance(name, str):
            # an unhashable 'name' (dict/list) crashed the registry
            # lookup with a bare TypeError (chain fuzzer find)
            raise ConfigError(f"effect name must be a string: {name!r}")
        if name not in _EFFECTS:
            raise ConfigError(
                f"unknown effect {name!r}; known: {sorted(_EFFECTS)}"
            )
        cls = _EFFECTS[name]
        allowed = getattr(cls, "PARAMS", None)  # user-registered custom
        # effect classes without a PARAMS declaration skip the gate
        # (review find: a hard attribute access broke them)
        if (default_backend is not None and "backend" not in params
                and (allowed is None or "backend" in allowed)):
            params["backend"] = default_backend
        if allowed is not None:
            unknown = set(params) - allowed
            if unknown:
                # a typo'd parameter used to be silently ignored — the
                # effect ran with its default and nothing ever said so
                # (fuzz find: {"strength": -3} on noise_suppression)
                raise ConfigError(
                    f"{name}: unknown parameter(s) {sorted(unknown)}; "
                    f"accepted: {sorted(allowed)}")
        try:
            out.append(cls(sample_rate, params))
        except ConfigError:
            raise
        except (TypeError, ValueError, KeyError, OverflowError) as e:
            # typed boundary for EVERY effect constructor (incl.
            # user-registered customs): float(b'..'), int(None), a
            # missing band key, int(1e999) all used to leak bare
            # internals (chain fuzzer find)
            raise ConfigError(f"{name}: bad parameters: {e}") from e
    return _fold_lti(out) if fold else out


def chain_init_state(effects, batch_shape):
    """Initial state pytree; ``batch_shape`` = x.shape[:-1] (or the
    legacy ``nch`` int for (ch, n) blocks)."""
    return tuple(fx.init_state(batch_shape) for fx in effects)


def chain_apply(effects, x, states):
    """Run the chain over one block (..., ch, n). Pure; jittable with
    the effects list closed over (all effect params are static
    constants). A ``None`` state element means "initial state, whole
    clip": effects may take a faster stateless path and return None."""
    new_states = []
    for fx, st in zip(effects, states):
        x, st = fx.apply(x, st)
        new_states.append(st)
    return x, tuple(new_states)


# --- compiled-chain cache -------------------------------------------------

_cache: dict = {}


def _chain_key(sample_rate: int, chain) -> str:
    def canon(e):
        if hasattr(e, "name"):
            name, params = e.name, e.params
        else:
            if not isinstance(e, dict):
                raise ConfigError(
                    f"effect entry must be an object with a 'name': {e!r}")
            d = dict(e)
            if "name" not in d:
                raise ConfigError(f"effect entry missing 'name': {e!r}")
            name = d.pop("name")
            if "params" in d:
                params = d.pop("params")
                if not isinstance(params, dict):
                    raise ConfigError(
                        f"{name}: 'params' must be an object, got {params!r}")
                if d:
                    # keep the cache key in lockstep with build_chain's
                    # rejection: an invalid entry must never alias a
                    # previously-cached valid chain
                    raise ConfigError(
                        f"{name}: unexpected top-level key(s) "
                        f"{sorted(d)} alongside 'params' — put effect "
                        f"parameters inside 'params'")
            else:
                params = d
        params = dict(params)
        if "ir_wav" in params:
            # key IR files by CONTENT signature, not path: a rewritten
            # file must not reuse the stale baked-in IR (round-2
            # review find)
            import os

            try:
                st = os.stat(str(params["ir_wav"]))
                params["ir_wav"] = (str(params["ir_wav"]), st.st_size,
                                    st.st_mtime_ns)
            except OSError:
                params["ir_wav"] = str(params["ir_wav"])
        return {"name": name, "params": params}

    return json.dumps(
        {"sr": sample_rate, "chain": [canon(e) for e in chain]},
        sort_keys=True, default=_json_default,
    )


def _json_default(v):
    """json.dumps ``default`` that canonicalizes arrays by CONTENT.

    np/jnp arrays hash by sha1 of their bytes (``default=str`` would
    collapse two different large arrays to the same truncated repr —
    a stale-executable cache bug, round-2 advisor find); np scalars
    unbox; anything else stringifies.
    """
    import hashlib

    if isinstance(v, (np.ndarray, jnp.ndarray)):
        a = np.asarray(v)
        return f"<array:{hashlib.sha1(a.tobytes()).hexdigest()}:{a.shape}:{a.dtype}>"
    if isinstance(v, np.generic):
        return v.item()
    try:  # Path-like / other stringifiable params build_chain accepts
        return str(v)
    except Exception:
        raise TypeError(f"unhashable effect param: {type(v)}")


def get_compiled_chain(sample_rate: int, chain,
                       default_backend: str | None = None):
    """-> (effects, jitted fn(x, states) -> (y, states)). Cached so repeat
    calls with the same chain config reuse the XLA executable."""
    key = (default_backend, _chain_key(sample_rate, chain))
    hit = _cache.pop(key, None)  # pop+reinsert = true LRU: plain .get()
    # left a HOT chain oldest-by-insertion, so 64 rotating cold chains
    # evicted it and the next call re-traced and recompiled a fresh jit
    # closure (same class as the pool._dispatch and sp._cached_jit fixes)
    if hit is None:
        effects = build_chain(sample_rate, chain,
                              default_backend=default_backend)
        fn = jax.jit(partial(chain_apply, effects))
        fn_raw = jax.jit(partial(_chain_apply_raw, effects))
        hit = (effects, fn, fn_raw)
    _cache[key] = hit
    if len(_cache) > 64:  # bound the executable cache (LRU out)
        _cache.pop(next(iter(_cache)))
    return hit


def _chain_apply_raw(effects, pcm):
    """Whole-clip public path as ONE program: layout swap (public
    time-first -> device time-last), i16->f32, the chain, f32->i16,
    swap back. Jitted whole so the swaps/conversions FUSE into the
    chain's first/last device passes instead of running as separate
    eager dispatches."""
    from xmtpu.api import _from_f32_device, _to_f32_device

    x, was_i16, was_1d = _to_f32_device(pcm)
    y, _ = chain_apply(effects, x, tuple(None for _ in effects))
    return _from_f32_device(y, was_i16, was_1d, to_host=False)


def apply_chain(pcm, sample_rate: int, chain, block_size: int | None = None,
                backend: str | None = None, device_out: bool = False):
    """Public effects entry (BASELINE.json:9 config 3).

    ``pcm``: int16 or f32, (n,), (n, ch), or batched (B, n, ch); returns
    the same format. ``backend``: default engine for effects that don't
    name one — None/"auto" runs the card's engine on a GPU and the f64
    oracle scans on the CPU (:func:`xmtpu.engine.resolve`).
    ``device_out``: return the device array without fetching to host
    (for callers that keep chaining on device).
    ``block_size``: process in fixed blocks with carried state (the N3
    block scheduler, SURVEY.md §1.2 — constant device memory for
    arbitrarily long clips; one compiled shape, last block zero-padded).
    Output is block-size invariant (SURVEY.md §4.2) because every effect
    carries exact state. Offline-only effects (noise suppression) reject
    blocked mode.
    """
    from xmtpu.api import _from_f32_device, _to_f32_device

    effects, fn, fn_raw = get_compiled_chain(sample_rate, chain,
                                             default_backend=backend)
    arr = jnp.asarray(pcm)
    if arr.ndim < 1 or arr.ndim > 3:
        # raise here, not via _to_f32_device's side-effect: if that
        # helper ever gained ndim>3 support this guard would silently
        # fall through to the wrong-axis shape indexing below (and the
        # jnp.asarray above must not be the first validation either)
        raise ValueError(
            f"pcm must be (n,), (n, ch), or (B, n, ch); got shape "
            f"{arr.shape}")
    n = arr.shape[0 if arr.ndim <= 2 else 1]
    if block_size is None or block_size >= n:
        # whole clip, ONE dispatch: layout swaps + i16 conversion +
        # chain in a single program (see _chain_apply_raw); None states
        # let effects take stateless fast paths (reverb skips the
        # history concat)
        y = fn_raw(arr)
        return np.asarray(y) if not device_out else y

    x, was_i16, was_1d = _to_f32_device(arr)

    for e in effects:
        if isinstance(e, NoiseSuppressFx):
            raise ConfigError(
                "noise_suppression needs the whole clip (offline-only); "
                "run it unblocked or before the blocked chain"
            )
    states = chain_init_state(effects, x.shape[:-1])
    outs = []
    for i in range(0, n, block_size):
        blk = jax.lax.slice_in_dim(x, i, min(i + block_size, n), axis=-1)
        pad = block_size - blk.shape[-1]
        if pad:  # keep ONE compiled shape; zero tail only feeds past-end state
            blk = jnp.pad(blk, [(0, 0)] * (blk.ndim - 1) + [(0, pad)])
        y, states = fn(blk, states)
        outs.append(y[..., : block_size - pad] if pad else y)
    return _from_f32_device(jnp.concatenate(outs, axis=-1), was_i16, was_1d,
                            to_host=not device_out)
