"""Shared fixtures and helpers for the xmtpu test suite.

Test strategy per SURVEY.md §4.2: the oracle is a float64 CPU golden
implementation (scipy/numpy); the driver metric is RMS dB error vs that
oracle with a <= -80 dB target (BASELINE.json:2,5).

The suite runs on the CPU (``JAX_PLATFORMS=cpu python -m pytest tests/
-m 'not slow'``). The card's engine runs there too, with its Pallas
kernel interpreted (engine ``"gpu_interpret"``). Tests marked ``chip``
need the CUDA card: the ``_chip_only`` fixture skips them elsewhere, and
``python chip_smoke.py`` runs them on the card (``-m chip``).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import xmtpu  # noqa: E402,F401  (sets the compile-cache directory)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip ``@pytest.mark.chip`` tests unless JAX's platform is the GPU
    (decided here, at run time — never at import or collection)."""
    if request.node.get_closest_marker("chip") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs the CUDA card (run: python chip_smoke.py)")


def rms_db(err: np.ndarray, ref: np.ndarray) -> float:
    """RMS error in dB relative to the reference signal power
    (the BASELINE.json:2 accuracy metric)."""
    err = np.asarray(err, np.float64)
    ref = np.asarray(ref, np.float64)
    p_ref = np.mean(ref**2)
    p_err = np.mean(err**2)
    if p_err == 0:
        return -np.inf
    return float(10.0 * np.log10(p_err / p_ref))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture(scope="session")
def signals(rng):
    """Small standard test signals (f32, ~0.3 peak): noise, sine, sweep."""

    def make(n, sr):
        t = np.arange(n) / sr
        return {
            "noise": (0.3 * rng.standard_normal(n)).astype(np.float32),
            "sine": (0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32),
            # linear chirp 50 Hz -> min(5 kHz, 0.4*Nyquist): real
            # broadband coverage. The old formula's instantaneous
            # frequency peaked at 20*n/sr Hz (subsonic for every shape
            # used), so 'sweep' tests exercised near-DC bins only
            # (review find)
            "sweep": (
                0.3 * np.sin(2 * np.pi * (
                    50.0 * t + (min(5000.0, 0.2 * sr) - 50.0)
                    * t**2 / (2 * t[-1] + 1e-9)))
            ).astype(np.float32),
        }

    return make
