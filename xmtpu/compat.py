"""Handle-style compatibility facade over the functional API.

Reference analogue: the public C surface of the upstream —
``xm_audio_utils_create / mixer_init / mixer_seek / mixer_get_frame /
freep`` (``src/xm_audio_utils.c``) and ``xm_audio_generator_start /
get_progress / stop`` (``src/xm_audio_generator.c``) [upstream,
SURVEY.md §2.1/§3.1/§3.2]. A user of the reference can keep their
call shape; each method maps onto the device machinery
(StreamSession, pipeline.process_file).

The generator runs asynchronously on a host thread with a pollable
progress/status, mirroring the reference's pthread + atomic-progress
design (the DSP itself is one fused device computation, so progress is
stage-grained — SURVEY.md §3.1 note).
"""

from __future__ import annotations

import threading

import numpy as np

from xmtpu.config.schema import load_config
from xmtpu.utils.errors import XmtpuError

# reference-style status codes (generator)
GS_IDLE = 0
GS_RUNNING = 1
GS_COMPLETED = 2
GS_ERROR = -1
GS_STOPPED = -2


class XmAudioUtils:
    """Interactive handle: mixer/effects session with seek + frame reads."""

    def __init__(self):
        self._session = None

    # -- mixer path (xm_audio_utils_mixer_*) --
    def mixer_init(self, config_json, sources=None, frame_ms: float = 20.0):
        """Parse a mixer JSON config and open decoders (reference:
        ``xm_audio_utils_mixer_init``)."""
        from xmtpu.graph.streaming import StreamSession

        cfg = load_config(config_json)
        self._session = StreamSession(cfg, frame_ms=frame_ms, sources=sources)
        return 0

    def mixer_seek(self, ms: float) -> int:
        self._require().seek(float(ms))
        return 0

    def mixer_get_frame(self) -> np.ndarray | None:
        """Next int16 frame, or None at end-of-stream (reference returns
        <= 0 byte count)."""
        return _next_frame(self._require())

    def _require(self):
        if self._session is None:
            raise XmtpuError("call mixer_init first")
        return self._session

    # -- voice-effects path (xm_audio_effects_* parity:
    #    src/effects/xm_audio_effects.c [upstream, SURVEY.md §2.1]) --
    def effects_init(self, config_json, voice, frame_ms: float = 20.0):
        """Open a voice-effects session: ONE voice stream through the
        configured NS -> EQ -> reverb -> volume -> limiter chain, with
        seek + frame reads (reference: ``xm_audio_effects_create/init``).

        ``config_json``: an effect chain — a list of ``{"name", ...}``
        entries (Python list or JSON), or an object with an ``effects``
        key (``sampleRate``/``blockSize`` honored). Multi-track configs
        belong to :meth:`mixer_init`. ``voice``: a file path, a
        ``(pcm, sr)`` pair, or a bare array at the config sample rate.
        When the config names no ``sampleRate``, the session runs at
        the VOICE's native rate (the reference processes at the input
        PCM's rate — a silent 16 kHz default would resample it).
        """
        import dataclasses
        import os as _os

        from xmtpu.config.schema import (TrackConfig, config_from_dict,
                                         load_json_source)
        from xmtpu.graph.streaming import StreamSession
        from xmtpu.utils.errors import ConfigError

        d = config_json
        if isinstance(d, (str, bytes)):
            d = load_json_source(d, what="effects config")
        if isinstance(d, (list, tuple)):
            d = {"effects": list(d)}
        if not isinstance(d, dict):
            raise ConfigError(
                f"effects config must be a chain list or an object with "
                f"'effects', got {type(d).__name__}")
        if d.get("tracks"):
            raise ConfigError(
                "effects_init takes a single voice stream; multi-track "
                "configs go through mixer_init")
        has_rate = "sampleRate" in d
        cfg = config_from_dict({k: v for k, v in d.items() if k != "tracks"})
        native_sr = None  # adopt the voice's rate when the config is silent
        if isinstance(voice, (str, bytes)):
            url, sources = _os.fsdecode(voice), None
            if not has_rate:
                from xmtpu.io import open_audio

                with open_audio(url) as dec:
                    native_sr = int(dec.sample_rate)
        elif (isinstance(voice, (tuple, list)) and len(voice) == 2
                and isinstance(voice[0], (str, bytes))):
            # a plausible (path, sr) pair used to fall through to the
            # bare-array branch and register a unicode array as PCM
            # (review find) — refuse typed instead
            raise ConfigError(
                "voice must be a path, a (pcm, sr) pair, or an array — "
                "got a (path, rate) pair; pass the path alone (the "
                "session adopts the file's native rate)")
        elif (isinstance(voice, (tuple, list)) and len(voice) == 2
                and np.isscalar(voice[1]) and not np.isscalar(voice[0])):
            url = "__voice__"
            sources = {"__voice__": (np.asarray(voice[0]), int(voice[1]))}
            native_sr = None if has_rate else int(voice[1])
        else:
            # bare array: documented as being at the config sample rate
            url = "__voice__"
            sources = {"__voice__": (np.asarray(voice), cfg.sample_rate)}
        if native_sr is not None:
            # the reference effects path processes at the input PCM's
            # rate; a silent 16 kHz default would resample the voice
            cfg = dataclasses.replace(cfg, sample_rate=native_sr)
        cfg = dataclasses.replace(cfg, tracks=(TrackConfig(url=url),))
        self._fx_session = StreamSession(cfg, frame_ms=frame_ms,
                                         sources=sources)
        return 0

    def effects_seek(self, ms: float) -> int:
        self._require_fx().seek(float(ms))
        return 0

    def effects_get_frame(self) -> np.ndarray | None:
        """Next effected int16 frame, or None past the voice's end."""
        return _next_frame(self._require_fx())

    def _require_fx(self):
        s = getattr(self, "_fx_session", None)
        if s is None:
            raise XmtpuError("call effects_init first")
        return s

    # -- decoder path (xm_audio_utils decoder handle parity:
    #    audio_decoder_create / seekTo / get_decoded_frame / freep) --
    def decoder_create(self, path) -> int:
        """Open a chunked decoder handle on an audio file. Compressed
        formats stream at constant memory through the native FFmpeg
        handle (xm_ff_open); WAV/PCM use the in-memory backend."""
        from xmtpu.io import open_audio

        self.decoder_freep()  # close any previous handle — re-create
        # used to leak the native FFmpeg decoder / file descriptor
        # (review find: a directory scan hit EMFILE after ~1024 files)
        self._decoder = open_audio(str(path))
        return 0

    def decoder_seek(self, ms: float) -> int:
        self._require_dec().seek(float(ms))
        return 0

    def decoder_get_pcm(self, num_samples: int) -> np.ndarray | None:
        """Next (n, ch) int16 chunk, or None at EOF (reference returns
        <= 0 byte count)."""
        out = self._require_dec().read(int(num_samples))
        return out if len(out) else None

    def decoder_freep(self) -> None:
        d = getattr(self, "_decoder", None)
        if d is not None:
            d.close()
        self._decoder = None

    def _require_dec(self):
        d = getattr(self, "_decoder", None)
        if d is None:
            raise XmtpuError("call decoder_create first")
        return d

    def freep(self) -> None:
        self._session = None
        self._fx_session = None
        self.decoder_freep()


def _next_frame(s) -> np.ndarray | None:
    """One frame from a StreamSession, or None at end-of-stream.

    End-of-stream BEFORE reading: every NON-LOOP track is already past
    its end at the frame about to be produced. Loop tracks (BGM) never
    end on their own — the offline mixer ends at the non-loop tracks'
    end, so they must not keep the stream alive (a voice+looped-BGM
    config would otherwise never return None). All-loop (or empty)
    track lists have no natural end; the caller bounds the stream
    (reference: loop-only configs play forever until seek/free).
    """
    finite = [ts for ts in s.tracks if not ts.cfg.loop]
    if not finite:
        return s.read() if s.tracks else None
    end = all(
        (s.frame_idx * s.frame_out - ts.start_bus) >= ts.n_out
        for ts in finite
    )
    if end:
        return None
    return s.read()


class XmAudioGenerator:
    """One-shot async generator: config -> mixed file, pollable progress."""

    def __init__(self):
        self._thread = None
        self._progress = 0.0
        self._status = GS_IDLE
        self._error = None
        self._stop = threading.Event()
        self._start_lock = threading.Lock()

    def start(self, config_json, out_path, inputs=None) -> int:
        """Begin processing on a host thread (reference:
        ``xm_audio_generator_start``; pthread analogue). Returns -1 if
        already running — atomically: the unlocked check-then-act let
        two near-simultaneous starts both pass and race two pipelines
        onto one out_path (review find)."""
        with self._start_lock:
            if self._status == GS_RUNNING:
                return -1
            self._status = GS_RUNNING
        try:
            cfg = load_config(config_json)
        except Exception:
            self._status = GS_IDLE  # claim released; config never ran
            raise
        self._progress = 0.0
        self._error = None
        self._stop.clear()

        def work():
            from xmtpu.graph import pipeline

            def report(p):
                self._progress = float(p)
                if self._stop.is_set():
                    raise InterruptedError("stopped")

            try:
                pipeline.process_file(inputs, cfg, out_path, progress=report)
                self._status = GS_COMPLETED
            except InterruptedError:
                self._status = GS_STOPPED
            except Exception as e:  # pollable error, reference-style
                self._error = e
                self._status = GS_ERROR

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return 0

    def get_progress(self) -> float:
        """0..100 (reference: ``xm_audio_generator_get_progress``)."""
        return self._progress

    @property
    def status(self) -> int:
        return self._status

    @property
    def error(self):
        return self._error

    def stop(self) -> None:
        """Request cancellation (takes effect at the next stage boundary —
        the device computation itself is not interruptible)."""
        self._stop.set()

    def wait(self, timeout: float | None = None) -> int:
        if self._thread is not None:
            self._thread.join(timeout)
        return self._status
