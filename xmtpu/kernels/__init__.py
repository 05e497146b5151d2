"""Hand-written GPU kernels (layer N1 in SURVEY.md §1.2).

The analogue of the reference's hand-written C DSP inner loops
(``lib-audio-utils/src/effects/`` hot loops [upstream, SURVEY.md
§2.1]). One remains: the limiter envelope (``envelope.py``), a Pallas
kernel on the Triton route. Its plain twin in ``xmtpu.ops.limiter`` is
the correctness oracle, and the kernel runs in Pallas interpret mode on
the CPU when a caller names the ``gpu_interpret`` engine.
"""

from xmtpu.kernels.envelope import limiter_kernel  # noqa: F401
