"""BS.1770 LUFS tests: coefficient goldens (the standard's own 48 kHz
table), oracle agreement, absolute calibration (997 Hz sine -> -3.01
LUFS at 0 dBFS), gating behavior, and mixer integration
(``normalize="lufs"``, BASELINE.json:5,8 "loudness normalization")."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp

import xmtpu  # noqa: F401
from xmtpu.ops.loudness import (
    k_weighting_sos, lufs_normalize, measure_lufs, measure_lufs_np,
)

SR = 48000


def test_k_weighting_matches_bs1770_table():
    """At 48 kHz the re-designed filters must reproduce the coefficient
    table printed in ITU-R BS.1770-4 itself."""
    sos = k_weighting_sos(SR)
    ref = np.array([
        [1.53512485958697, -2.69169618940638, 1.19839281085285,
         1.0, -1.69065929318241, 0.73248077421585],
        [1.0, -2.0, 1.0,
         1.0, -1.99004745483398, 0.99007225036621],
    ])
    np.testing.assert_allclose(sos, ref, atol=1e-10)


def test_sine_calibration_minus_3_lufs():
    """A 0 dBFS 997 Hz sine measures -3.01 LUFS (the BS.1770 anchor the
    -0.691 constant exists for).

    SHAPE BUDGET: every device-path test in this file uses length
    SR*2 — each distinct length compiles a fresh K-weighting + gating
    program. Keep new tests on SR*2."""
    t = np.arange(SR * 2) / SR
    x = np.sin(2 * np.pi * 997.0 * t)
    lufs = measure_lufs_np(x, SR)
    assert abs(lufs - (-3.01)) < 0.05, lufs
    lufs_j = float(measure_lufs(jnp.asarray(x, jnp.float32), SR))
    assert abs(lufs_j - lufs) < 0.02, (lufs_j, lufs)


def test_jax_matches_oracle_with_gating(rng):
    """Noise with a long silent gap (absolute gate) and a quiet tail
    (relative gate): device measurement == f64 scipy oracle."""
    n = SR * 2  # shape budget: one device length for the whole file
    x = 0.25 * rng.standard_normal(n)
    x[int(0.6 * SR) : int(1.2 * SR)] = 0.0  # silence: absolute-gated out
    x[int(1.5 * SR) :] *= 0.003  # ~ -50 dB quieter: relative-gated out
    ref = measure_lufs_np(x, SR)
    got = float(measure_lufs(jnp.asarray(x, jnp.float32), SR))
    assert abs(got - ref) < 0.02, (got, ref)
    # the gates matter: ungated mean square would differ by > 1 LU
    from scipy import signal as sps

    ungated = -0.691 + 10 * np.log10(
        np.mean(np.square(sps.sosfilt(k_weighting_sos(SR), x))))
    assert abs(ungated - ref) > 1.0


def test_stereo_channel_sum(rng):
    """Stereo powers sum across channels (G=1): two identical channels
    measure +3.01 LU above one."""
    x = 0.2 * rng.standard_normal(SR * 2)
    mono = measure_lufs_np(x, SR)
    stereo = measure_lufs_np(np.stack([x, x]), SR)
    assert abs(stereo - mono - 3.0103) < 0.01


def test_lufs_normalize_hits_target(rng):
    x = (0.05 * rng.standard_normal((1, SR * 2))).astype(np.float32)
    y, gain = lufs_normalize(jnp.asarray(x), SR, target_lufs=-23.0)
    got = measure_lufs_np(np.asarray(y, np.float64), SR)
    assert abs(got - (-23.0)) < 0.05, got
    # silence passes through with unity gain (same shape -> the
    # compiled program is shared with the call above)
    z = jnp.zeros((1, SR * 2), jnp.float32)
    _, g0 = lufs_normalize(z, SR, target_lufs=-23.0)
    assert float(g0) == 1.0


def test_mixer_normalize_lufs(rng):
    from xmtpu.graph import mixer as mixg

    x = (0.1 * rng.standard_normal(SR * 2)).astype(np.float32)
    out = mixg.mix(
        [mixg.MixTrack(pcm=x, sr=SR)], SR,
        normalize="lufs", target_db=-20.0,
    )
    got = measure_lufs_np(np.asarray(out, np.float64), SR)
    assert abs(got - (-20.0)) < 0.05, got


def test_int16_pcm_handled_like_float(rng):
    """int16 input used to be cast raw to f32 (reading ~90.3 dB too
    loud) and lufs_normalize's gain was truncated to int16 (returning
    all-zero 'normalized' audio) — review find."""
    from xmtpu.ops.loudness import lufs_normalize, measure_lufs

    sr = 48000
    t = np.arange(sr * 2) / sr
    f32 = (0.25 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    i16 = (f32 * 32768.0).clip(-32768, 32767).astype(np.int16)
    l_f = float(measure_lufs(f32, sr))
    l_i = float(measure_lufs(i16, sr))
    assert abs(l_f - l_i) < 0.01, (l_f, l_i)
    y, gain = lufs_normalize(i16, sr, target_lufs=-23.0)
    assert np.asarray(y).dtype == np.int16
    assert np.abs(np.asarray(y)).max() > 0  # was all-zero silence
    l_y = float(measure_lufs(np.asarray(y), sr))
    assert abs(l_y - (-23.0)) < 0.1, l_y
