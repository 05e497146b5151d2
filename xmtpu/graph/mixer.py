"""Track alignment + mixing stage.

Reference analogue: ``mixer_mix`` / ``MixerEffects`` — N-track
(voice + BGM + music) sum with per-track gain, fades, BGM looping and
timeline placement (``src/effects/mixer_effects/`` [upstream, SURVEY.md
§2.1]).

Alignment (resample to the bus rate, loop, place at start offset, trim)
produces equal-length tracks; gain/fade/sum/normalize then run as one
fused device computation. All placement arithmetic is static (config
-derived python ints), so the jitted graph has fixed shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from xmtpu.ops import convert as _convert
from xmtpu.ops import mix as _mix
from xmtpu.ops import resample as _resample


@dataclass(frozen=True)
class MixTrack:
    """One resolved mixer input: PCM + placement/gain parameters.

    ``pcm``: int16 or float32, (n,) or (n, ch). ``sr``: its native rate.
    ``gain``: linear amplitude. Times in ms, converted to samples at the
    bus rate.
    """

    pcm: object
    sr: int
    gain: float = 1.0
    start_ms: float = 0.0
    fade_in_ms: float = 0.0
    fade_out_ms: float = 0.0
    loop: bool = False
    kind: str = "voice"  # voice | bgm | music (reference track classes)
    side_duck: bool = False  # duck this track under the voice bus

    @staticmethod
    def from_dict(d: dict) -> "MixTrack":
        return MixTrack(
            pcm=d["pcm"],
            sr=int(d.get("sr", d.get("sample_rate", 0)) or 0),
            gain=float(d.get("gain", _mix.db_to_amp(d["gain_db"]) if "gain_db" in d else 1.0)),
            start_ms=float(d.get("start_ms", 0.0)),
            fade_in_ms=float(d.get("fade_in_ms", 0.0)),
            fade_out_ms=float(d.get("fade_out_ms", 0.0)),
            loop=bool(d.get("loop", False)),
            kind=str(d.get("kind", "voice")),
            side_duck=bool(d.get("side_duck", False)),
        )


def _ms_to_samples(ms: float, sr: int) -> int:
    return int(round(ms * sr / 1000.0))


_MIX_JIT_CACHE: dict = {}


def _coerce_track(t) -> "MixTrack":
    """Accept MixTrack, a config dict, or a bare ``(pcm, sr)`` pair.

    A tuple/list pair is the natural shorthand for callers that just
    want tracks summed at default gain; anything else used to die with
    a raw TypeError from dict indexing.
    """
    if isinstance(t, MixTrack):
        return t
    if isinstance(t, dict):
        return MixTrack.from_dict(t)
    if (isinstance(t, (tuple, list)) and len(t) == 2
            and np.isscalar(t[1]) and not np.isscalar(t[0])):
        return MixTrack(pcm=t[0], sr=int(t[1]))
    from xmtpu.utils.errors import ConfigError

    raise ConfigError(
        f"mix() track must be a MixTrack, a dict with 'pcm'/'sr', or a "
        f"(pcm, sr) pair; got {type(t).__name__}")


def mix(tracks, sample_rate: int, normalize: str | None = "peak",
        target_db: float = -1.0, duration_ms: float | None = None,
        duck_params: dict | None = None, voice_effects=None):
    """Mix tracks onto a common bus. Public entry (BASELINE.json:8).

    ``tracks``: list of dicts or :class:`MixTrack`. Output dtype follows
    the first track (int16 -> int16). Mono tracks are upmixed when any
    track is multichannel.

    ``voice_effects``: optional effect-config list applied to the summed
    VOICE bus (kind=="voice", non-ducked tracks) at the bus rate, after
    placement/gain/fades and before ducking/mixdown — the SAME placement
    as the streaming session's ``config.effects`` (SURVEY.md §4.2
    streaming==offline invariant; one semantics, both modes).
    """
    if not tracks:
        raise ValueError("mix() needs at least one track")
    mts = [_coerce_track(t) for t in tracks]

    first = (mts[0].pcm if hasattr(mts[0].pcm, "ndim")
             else np.asarray(mts[0].pcm))
    first_1d = first.ndim == 1
    out_int16 = first.dtype == np.int16

    # --- host-side shape planning (static) ---
    prepared = []  # (f32 device array (ch, n_at_bus_rate), static params)
    nch = 1
    for t in mts:
        # keep device arrays on device: np.asarray on a jax array is a
        # full device->host fetch, re-uploaded below — planning needs
        # only shape/dtype (review find)
        pcm = t.pcm if hasattr(t.pcm, "ndim") else np.asarray(t.pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        nch = max(nch, pcm.shape[1])
        sr = t.sr or sample_rate
        _resample.check_rates(sr, sample_rate)  # typed: a pathological
        # header rate (e.g. 44101 Hz, coprime with the bus) used to
        # design a 16000-phase filter bank and stall the compiler
        # — the shared rule the CLI/runner paths already apply
        for nm, val in (("start_ms", t.start_ms),
                        ("fade_in_ms", t.fade_in_ms),
                        ("fade_out_ms", t.fade_out_ms)):
            if not (val >= 0.0) or val != val or val == float("inf"):
                from xmtpu.utils.errors import ConfigError

                raise ConfigError(f"track {nm} must be finite and >= 0, "
                                  f"got {val!r}")  # a negative start_ms
                # died as an opaque negative-pad trace error
        n_bus = _resample.resample_output_len(pcm.shape[0], *_ratio(sr, sample_rate))
        prepared.append((pcm, sr, n_bus, t))
    if duration_ms is not None and not (0 < float(duration_ms) < 1e12):
        from xmtpu.utils.errors import ConfigError

        raise ConfigError(f"duration_ms must be positive/finite, "
                          f"got {duration_ms!r}")
    for (pcm, _, _, _) in prepared:
        if pcm.shape[1] not in (1, nch):
            # only mono-to-nch upmix is defined; a 2-ch track next to a
            # 4-ch one used to die in jnp.stack deep inside the jit
            # trace with an opaque shape error (review find)
            from xmtpu.utils.errors import ConfigError

            raise ConfigError(
                f"cannot mix a {pcm.shape[1]}-channel track with "
                f"{nch}-channel material: only mono tracks upmix")
    # static per-track params WITHOUT the host PCM: `build` is cached
    # below and must not pin every clip's full PCM in its closure for
    # the cache's lifetime (review find — 64 cached plans x full-clip
    # PCM grew unbounded in a long-running service). The MixTrack
    # itself must be COPIED WITHOUT ITS pcm FIELD: dropping only the
    # local array variable still pinned everything through t.pcm
    # (second review find on the same leak)
    import dataclasses as _dc

    meta = [(sr, n_bus, _dc.replace(t, pcm=None))
            for (_, sr, n_bus, t) in prepared]

    if duration_ms is not None:
        total = _ms_to_samples(duration_ms, sample_rate)
    else:
        # duration = end of the last NON-loop track (loop tracks repeat
        # under the finite program, they never extend it — matches the
        # streaming/compat end-of-stream rule). All-loop fallback: one
        # pass of the longest placed source. (The old 1<<62 sentinel
        # fired whenever ANY track looped and then ignored start_ms —
        # round-2 review find.)
        finite = [
            _ms_to_samples(t.start_ms, sample_rate) + n_bus
            for (_, n_bus, t) in meta if not t.loop
        ]
        if finite:
            total = max(finite)
        else:
            total = max(
                _ms_to_samples(t.start_ms, sample_rate) + n_bus
                for (_, n_bus, t) in meta
            )

    def build(device_tracks):
        placed = []
        for x, (sr, n_bus, t) in zip(device_tracks, meta):
            y = x  # (ch, n) f32 at native rate
            if sr != sample_rate:
                y = _resample.polyphase_resample(y, sr, sample_rate)
            start = min(_ms_to_samples(t.start_ms, sample_rate), total)
            track_len = max(0, min(y.shape[-1], total - start))
            if t.loop and track_len and y.shape[-1] < total - start:
                reps = -(-(total - start) // y.shape[-1])
                y = jnp.tile(y, (1, reps))
                track_len = total - start
            y = y[..., :track_len]
            if track_len == 0:  # placed at/after the end: pure silence
                placed.append(jnp.zeros((nch, total), jnp.float32))
                continue
            y = _mix.apply_gain_fade(
                y,
                t.gain,
                _ms_to_samples(t.fade_in_ms, sample_rate),
                _ms_to_samples(t.fade_out_ms, sample_rate),
                offset=0,
                length=track_len,
            )
            if y.shape[0] == 1 and nch > 1:
                y = jnp.broadcast_to(y, (nch, track_len))
            y = jnp.pad(y, ((0, 0), (start, total - start - track_len)))
            placed.append(y)
        # three buses, mirroring the streaming session's step: voice
        # (gets voice_effects, drives the duck envelope), side-ducked,
        # everything else
        voice = [p for p, (_, _, t) in zip(placed, meta)
                 if t.kind == "voice" and not t.side_duck]
        ducked = [p for p, (_, _, t) in zip(placed, meta)
                  if t.side_duck]
        other = [p for p, (_, _, t) in zip(placed, meta)
                 if t.kind != "voice" and not t.side_duck]
        zeros = jnp.zeros((nch, total), jnp.float32)
        voice_bus = _mix.mix_sum(jnp.stack(voice)) if voice else zeros
        other_bus = _mix.mix_sum(jnp.stack(other)) if other else zeros
        if voice_effects and voice:
            from xmtpu.graph import fx as _fx

            effs = _fx.build_chain(sample_rate, list(voice_effects))
            # None states = whole-clip fast paths (auto engine:
            # xmtpu.engine decides from the platform)
            voice_bus, _ = _fx.chain_apply(
                effs, voice_bus, tuple(None for _ in effs)
            )
        # side-chain ducking: tracks flagged side_duck are attenuated by
        # the voice-bus envelope (reference BGM-under-voice behaviour;
        # pinned semantics in ops.mix.duck_gain). The envelope keys off
        # ALL non-ducked audio post-voice-effects (streaming parity).
        out = voice_bus + other_bus
        if ducked:
            g = _mix.duck_gain(
                out, sample_rate, **(duck_params or {})
            ).astype(jnp.float32)
            out = out + _mix.mix_sum(jnp.stack(ducked)) * g
        # normalize modes: "peak" | "lufs" (ITU-R BS.1770 integrated
        # loudness; target_db means LUFS, e.g. -23) | "rms" (plain
        # unweighted RMS; "loudness" is its legacy alias) | None
        if normalize == "peak":
            out, _ = _mix.peak_normalize(out, _mix.db_to_amp(target_db))
        elif normalize == "lufs":
            from xmtpu.ops.loudness import lufs_normalize

            out, _ = lufs_normalize(out, sample_rate, target_db)
        elif normalize in ("rms", "loudness"):
            out, _ = _mix.rms_normalize(out, _mix.db_to_amp(target_db))
        elif normalize is not None:
            raise ValueError(f"unknown normalize mode: {normalize!r}")
        return out

    dev = []
    for (pcm, _, _, _) in prepared:
        arr = jnp.asarray(pcm).T  # (ch, n)
        if arr.dtype == jnp.int16:
            arr = _convert.pcm16_to_f32(arr)
        dev.append(arr.astype(jnp.float32))

    # Reuse the jitted executable across mix() calls with identical
    # static plans: jax.jit's cache is per function OBJECT, and `build`
    # is a fresh closure every call — without this cache a service
    # mixing many same-shape clips pays a compile per CLIP (same
    # pattern as runner._STEP_CACHE).
    import json as _json

    from xmtpu.graph import fx as _fxkey

    key = (
        sample_rate, normalize, float(target_db), total, nch, out_int16,
        # content-canonical keys: fx._chain_key hashes array params by
        # sha1 and keys ir_wav by (path, size, mtime) — default=str
        # collapsed different IR arrays to one key and reused a stale
        # executable with the old IR baked in (round-2 advisor find)
        _json.dumps(duck_params, sort_keys=True,
                    default=_fxkey._json_default),
        _fxkey._chain_key(sample_rate, list(voice_effects))
        if voice_effects else None,
        tuple(
            (pcm.shape, str(pcm.dtype), sr, n_bus, t.start_ms, t.gain,
             t.fade_in_ms, t.fade_out_ms, t.loop, t.kind, t.side_duck)
            for (pcm, sr, n_bus, t) in prepared
        ),
    )
    fn = _MIX_JIT_CACHE.pop(key, None)  # pop+reinsert = LRU: plain .get
    # left hot plans oldest-by-insertion and 64 rotating cold plans
    # evicted them — a remote recompile per call (review find; same
    # idiom as fx._cache / pool / sp)
    if fn is None:
        fn = jax.jit(build)
    _MIX_JIT_CACHE[key] = fn
    if len(_MIX_JIT_CACHE) > 64:  # bound the executable cache
        _MIX_JIT_CACHE.pop(next(iter(_MIX_JIT_CACHE)))
    out = fn(dev)
    if out_int16:
        out = _convert.f32_to_pcm16(out)
    out = np.asarray(out).T  # (n, ch)
    if first_1d and out.shape[1] == 1:
        out = out[:, 0]
    return out


def _ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    import math

    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g
