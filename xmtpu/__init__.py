"""xmtpu — accelerator-native audio preprocessing framework (JAX, NVIDIA GPU).

A ground-up rebuild of the capabilities of ``sunyuchuan/xm-audio-utils``
(an Android/iOS C audio-processing library: FFmpeg decode -> polyphase
resample -> multi-track mix with gain/fades -> EQ/reverb/limiter effects
-> encode; see /root/reference/README.md:1 for the mounted stub and
SURVEY.md for the full capability map) as an idiomatic JAX/XLA/Pallas
framework:

* host-side I/O front end (WAV/PCM always; FFmpeg optional) -> numpy PCM
* all DSP on-device: polyphase-FIR resampling, fused mix+fade+gain,
  biquad EQ as associative scans, FIR reverb via FFT overlap-save,
  soft-knee limiting — batched over clips, blocked over time
* offline (whole-clip / 256-clip batch) and streaming (20 ms frames)
  execution modes with identical math
* scaling via ``jax.sharding`` over a device mesh (batch-parallel clips,
  sequence-parallel blocks), not translated C loops.

Reference analogue of this module: the public header ``xm_audio_utils.h``
[upstream, not in snapshot] — the single import a user needs.
"""

import os as _os

import jax as _jax

from xmtpu import _cachedir

# Persistent XLA compilation cache: $JAX_COMPILATION_CACHE_DIR when set
# (jax reads it itself; nothing else is set here), else one fixed
# directory inside the checkout (see _cachedir.py).
if not _os.environ.get(_cachedir.ENV):
    _jax.config.update("jax_compilation_cache_dir", _cachedir.cache_dir())

# IIR filter-state scans use float64 state for accuracy (SURVEY.md §7.4②:
# an f32 scan floors at -77 dB vs the oracle). All xmtpu ops pass
# explicit dtypes, so enabling x64 here does not change the dtype of any
# f32 compute path.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from xmtpu.api import (  # noqa: E402
    resample,
    mix,
    effects,
    process_file,
    Session,
    SessionPool,
)
from xmtpu.graph.serve import PoolServer  # noqa: E402
from xmtpu import io  # noqa: E402  (xmtpu.io.read_wav / write_wav / open_audio)
from xmtpu import compat  # noqa: E402  (handle-style reference-parity API)
from xmtpu.config.schema import (  # noqa: E402
    PipelineConfig,
    TrackConfig,
    EffectConfig,
)

__all__ = [
    "resample",
    "mix",
    "effects",
    "process_file",
    "Session",
    "SessionPool",
    "PoolServer",
    "PipelineConfig",
    "TrackConfig",
    "EffectConfig",
    "__version__",
]
