"""Public API (layer N4 in SURVEY.md §1.2).

Reference analogue: ``xm_audio_utils.c`` / ``xm_audio_generator.c``
[upstream, SURVEY.md §2.1] — the handle-based session API and the
one-shot file->file generator. Here the surface is functional:

* :func:`resample`  — PCM in / PCM out rate conversion (config 1)
* :func:`mix`       — N-track gain/fade/sum/normalize (config 2)
* :func:`effects`   — EQ -> reverb -> limiter chain (config 3)
* :func:`process_file` — one-shot file(s) -> mixed file (generator)
* :class:`Session`  — streaming frame-by-frame reads (utils handle API)

All functions accept int16 or float32 PCM shaped ``(n,)`` or
``(n, channels)`` (the reference's interleaved-short convention maps to
int16 (n, ch)) and return the same format they were given.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from xmtpu.ops import convert as _convert
from xmtpu.ops import resample as _resample_op
from xmtpu.config.schema import PipelineConfig, TrackConfig, EffectConfig  # noqa: F401


def _to_f32_device(pcm) -> tuple[jnp.ndarray, bool, bool]:
    """-> (f32 time-LAST array, was_int16, was_1d).

    xmtpu's device layout is time-LAST: (channels, n) or batched
    (B, channels, n). Public layout is time-first (n, channels) /
    (B, n, channels) to match WAV interleaving; convert here.
    """
    arr = jnp.asarray(pcm)
    was_1d = arr.ndim == 1
    if was_1d:
        arr = arr[:, None]
    if arr.ndim == 2:
        arr = arr.T  # -> (channels, n), time-last for device ops
    elif arr.ndim == 3:  # batched clips (B, n, ch) -> (B, ch, n)
        arr = jnp.swapaxes(arr, -1, -2)
    else:
        raise ValueError(
            f"PCM must be (n,), (n, channels) or (B, n, channels), "
            f"got {arr.shape}")
    if arr.dtype == jnp.int16:
        return _convert.pcm16_to_f32(arr), True, was_1d
    return arr.astype(jnp.float32), False, was_1d


def _from_f32_device(y: jnp.ndarray, was_int16: bool, was_1d: bool,
                     to_host: bool = True):
    out = _convert.f32_to_pcm16(y) if was_int16 else y
    out = jnp.swapaxes(out, -1, -2)  # back to (..., n, channels)
    if was_1d:
        out = out[..., 0]
    return np.asarray(out) if to_host else out


def resample(
    pcm,
    sr_in: int,
    sr_out: int,
    taps_per_phase: int = 24,
    beta: float = 9.0,
):
    """Sample-rate-convert PCM (int16 or f32, (n,) or (n, ch)).

    Reference parity: the resample entry point of ``xm_audio_utils``
    (``BASELINE.json:7`` config). int16 in -> int16 out; f32 in -> f32
    out; output length = ceil(n * sr_out / sr_in) after gcd reduction.
    """
    _resample_op.check_rates(sr_in, sr_out)  # typed: a pathological
    # pair (44101->16000) used to hang in a 16000-phase filter design
    x, was_i16, was_1d = _to_f32_device(pcm)
    y = _resample_op.polyphase_resample(
        x, sr_in, sr_out, taps_per_phase=taps_per_phase, beta=beta
    )
    return _from_f32_device(y, was_i16, was_1d)


def mix(tracks, sample_rate: int, normalize: str | None = "peak", **kw):
    """Multi-track mix onto a common bus (config 2, ``BASELINE.json:8``).

    ``tracks``: list of track specs — each a ``(pcm, sr)`` pair, a dict
    (``{"pcm", "sr", "gain"/"gain_db", "start_ms", "fade_in_ms",
    "fade_out_ms", "loop", "kind", "side_duck"}``), or a
    :class:`xmtpu.graph.mixer.MixTrack`. Tracks are resampled to
    ``sample_rate``, placed/faded/looped, optionally ducked under the
    voice bus, summed, and normalized (``"peak"`` / ``"rms"`` /
    ``"lufs"`` / ``None``). Output dtype follows the first track
    (int16 in -> int16 out). Reference parity: the mixer entry point of
    ``xm_audio_utils`` (SURVEY.md §3.4).
    """
    from xmtpu.graph import mixer  # local import: keeps M1 surface light

    return mixer.mix(tracks, sample_rate, normalize=normalize, **kw)


def effects(pcm, sample_rate: int, chain, **kw):
    """Effect chain (config 3, SURVEY.md §3.5).

    ``pcm``: int16 or f32, (n,), (n, ch), or a batched (B, n, ch) clip
    stack. By default the chain runs the platform's engine
    (``xmtpu.engine``): on the GPU the card's engine (EQs folded into
    the XLA reverb, the limiter envelope kernel), on the CPU the f64
    scans; name one with ``backend="gpu"|"xla"``. Other
    kwargs: ``block_size`` (N3 block scheduler), ``device_out`` (skip
    the host fetch). See :func:`xmtpu.graph.fx.apply_chain`.
    """
    from xmtpu.graph import fx

    return fx.apply_chain(pcm, sample_rate, chain, **kw)


def process_file(inputs, config: PipelineConfig, out_path, progress=None):
    """One-shot generator: input file(s) + config -> mixed output file."""
    from xmtpu.graph import pipeline

    return pipeline.process_file(inputs, config, out_path, progress=progress)


class Session:
    """Streaming session: seek + frame reads with carried DSP state.

    Wraps :class:`xmtpu.graph.streaming.StreamSession` (reference
    analogue: the ``xm_audio_utils`` mixer handle API). ``read()``
    returns one frame (double-buffered prefetch); ``read_many(k)``
    fuses k frames into one device dispatch for throughput; state is a
    serializable pytree (``save_state``/``load_state_file``).

    Latency: at the default ``prefetch_depth=1``, ``read()`` pays one
    host<->device round trip per frame — real-time frame-by-frame
    streaming needs RTT < frame_ms. ``prefetch_depth=d`` dispatches d
    frames ahead with eager device->host copies, removing the RTT
    bound from the sustained cadence once d*frame_ms > RTT (d frames
    of speculative work are discarded on seek); ``read_many``
    amortizes the round trip over k frames. See
    :class:`xmtpu.graph.streaming.StreamSession`.

    Not thread-safe: one Session per thread, like the reference's
    one-handle-per-thread model. For many concurrent streams in one
    process use :class:`SessionPool`, whose public methods are locked.
    """

    def __init__(self, *a, **kw):
        from xmtpu.graph.streaming import StreamSession

        self._impl = StreamSession(*a, **kw)

    def seek(self, ms: float):
        return self._impl.seek(ms)

    def read(self):
        return self._impl.read()

    @property
    def state(self):
        return self._impl.state

    def load_state(self, st):
        return self._impl.load_state(st)

    def save_state(self, path):
        return self._impl.save_state(path)

    def load_state_file(self, path):
        return self._impl.load_state_file(path)

    def read_many(self, k: int):
        return self._impl.read_many(k)


class SessionPool:
    """Serving mode: K concurrent streaming sessions batched into ONE
    jitted device step (reference analogue: many independent
    ``xm_audio_utils`` handles in one process — SURVEY.md §3.2). Slots
    share a config; ``join(slot, sources)`` / ``leave(slot)`` /
    ``seek(slot, ms)`` manage users without retracing; ``read(k)``
    advances every active slot k frames with one dispatch + one host
    fetch, returning (K, k*frame, ch) PCM. See
    :class:`xmtpu.graph.pool.SessionPool`.
    """

    def __init__(self, *a, **kw):
        from xmtpu.graph.pool import SessionPool as _Pool

        self._impl = _Pool(*a, **kw)

    @property
    def n_slots(self):
        return self._impl.n_slots

    @property
    def frame_out(self):
        return self._impl.frame_out

    @property
    def sr(self):
        return self._impl.sr

    def join(self, slot: int, sources):
        return self._impl.join(slot, sources)

    def leave(self, slot: int):
        return self._impl.leave(slot)

    def seek(self, slot: int, ms: float):
        return self._impl.seek(slot, ms)

    def active(self):
        return self._impl.active()

    def read(self, k: int = 1):
        return self._impl.read(k)

    def save_state(self, path):
        """Snapshot every slot's DSP state + clock (serving failover);
        restore with :meth:`load_state_file` after re-joining the same
        sources."""
        return self._impl.save_state(path)

    def load_state_file(self, path):
        return self._impl.load_state_file(path)
