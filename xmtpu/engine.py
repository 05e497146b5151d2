"""The one place that decides which engine runs the DSP.

Two engines share one set of semantics (the float64 numpy oracles):

* ``"gpu"`` — the card's engine. The reverb is XLA's cuFFT
  overlap-save with every adjacent EQ/volume folded into its impulse
  response (the LTI fold), the limiter envelope is the Pallas Triton
  kernel of ``kernels/envelope.py``, and every other recurrence is the
  XLA float64 scan.
* ``"xla"`` — float64 scans and the XLA reverb everywhere, with no
  fold: the oracle-grade twins, and the CPU's engine.

``auto`` picks from ``jax.default_backend()``: ``gpu`` gets the card's
engine, ``cpu`` the XLA twins, and any other platform raises
:class:`EngineError` naming it. The kernel runs in Pallas interpret
mode only when a caller names ``"gpu_interpret"`` — the tests do, to
drive the card's exact chain on the CPU. Nothing turns interpret mode
on because it found a CPU.
"""

from __future__ import annotations

import jax

from xmtpu.utils.errors import ConfigError

GPU = "gpu"
XLA = "xla"
NAMES = ("auto", "gpu", "gpu_interpret", "xla", "scan", "oracle")


class EngineError(ConfigError):
    """No engine for this platform, or the named engine cannot run here."""


def default_engine() -> str:
    """The engine ``auto`` resolves to on this process's platform."""
    plat = jax.default_backend()
    if plat == "gpu":
        return GPU
    if plat == "cpu":
        return XLA
    raise EngineError(
        f"xmtpu has no engine for the {plat!r} platform; it runs on "
        f"'gpu' (CUDA) or 'cpu'")


def resolve(name: str | None) -> tuple[str, bool]:
    """Engine name -> (engine, interpret), engine in {"gpu", "xla"}.

    ``None``/``"auto"``: :func:`default_engine`. ``"xla"`` (aliases
    ``"scan"``, ``"oracle"``): the float64 twins. ``"gpu"``: the card's
    engine with its kernel compiled, which needs a CUDA device.
    ``"gpu_interpret"``: the card's engine with its kernel run by the
    Pallas interpreter, on any platform."""
    if name in (None, "auto"):
        return default_engine(), False
    if name in (XLA, "scan", "oracle"):
        return XLA, False
    if name == GPU:
        plat = jax.default_backend()
        if plat != "gpu":
            raise EngineError(
                f"engine 'gpu' compiles its kernel for a CUDA device, but "
                f"the platform is {plat!r}; name 'gpu_interpret' to run "
                f"the card's chain in interpret mode")
        return GPU, False
    if name == "gpu_interpret":
        return GPU, True
    raise ConfigError(f"unknown engine {name!r}; use one of {NAMES}")
