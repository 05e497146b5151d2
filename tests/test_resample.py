"""Golden tests for the polyphase resampler (SURVEY.md §4.2):

* device op vs float64 scipy oracle (same taps): <= -80 dB required,
  ~-140 dB expected
* the oracle itself vs brute-force upsampled convolution (tiny input)
* pinned output-length semantics
* agreement with scipy.signal.resample_poly when given the same filter
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy import signal as sig

from xmtpu.ops import resample as R
from tests.conftest import rms_db

TARGET_DB = -80.0


def _run(x, sr_in, sr_out, **kw):
    f = jax.jit(lambda x: R.polyphase_resample(x, sr_in, sr_out, **kw))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (16000, 44100),
                                          (48000, 16000), (22050, 16000)])
@pytest.mark.parametrize("kind", ["noise", "sine", "sweep"])
def test_resample_golden(signals, sr_in, sr_out, kind):
    x = signals(sr_in, sr_in)[kind]  # 1 second
    got = _run(x, sr_in, sr_out)
    want = R.resample_oracle_np(x, sr_in, sr_out)
    assert got.shape == want.shape
    assert rms_db(got - want, want) <= TARGET_DB


def test_resample_stereo_batch(signals):
    x = np.stack([signals(44100, 44100)["noise"], signals(44100, 44100)["sine"]])
    got = _run(x, 44100, 16000)
    want = R.resample_oracle_np(x, 44100, 16000)
    assert got.shape == (2, 16000)
    assert rms_db(got - want, want) <= TARGET_DB


def test_oracle_vs_bruteforce(rng):
    """The scipy-upfirdn oracle must equal the literal definition:
    conv(upsample(x), h) sampled at t = j*M + (ntaps-1)//2."""
    x = rng.standard_normal(500)
    L, M = 160, 441
    h = R.design_polyphase_filter(L, M)
    offset = (len(h) - 1) // 2
    xup = np.zeros((len(x) - 1) * L + 1)
    xup[::L] = x
    conv = np.convolve(xup, h)
    out_len = R.resample_output_len(len(x), L, M)
    want = np.array([conv[j * M + offset] if j * M + offset < len(conv) else 0.0
                     for j in range(out_len)])
    got = R.resample_oracle_np(x, 44100, 16000)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_output_length_rule():
    assert R.resample_output_len(441000, 160, 441) == 160000
    assert R.resample_output_len(441, 160, 441) == 160
    assert R.resample_output_len(442, 160, 441) == 161  # ceil
    assert R.resample_output_len(1, 160, 441) == 1


def test_identity_when_rates_equal(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    got = _run(x, 16000, 16000)
    np.testing.assert_array_equal(got, x)


def test_matches_scipy_resample_poly(rng):
    """With the same odd-length filter, our semantics == resample_poly's."""
    x = rng.standard_normal(44100).astype(np.float64)
    L, M = 160, 441
    h = R.design_polyphase_filter(L, M)
    want = sig.resample_poly(x, L, M, window=h / L)  # window is scaled by L inside
    got = R.resample_oracle_np(x, 44100, 16000)
    assert got.shape == want.shape
    assert rms_db(got - want, want) <= -120.0


def test_filter_design_properties():
    h = R.design_polyphase_filter(160, 441, taps_per_phase=24)
    assert len(h) % 2 == 1  # odd length -> integer group delay
    np.testing.assert_allclose(h, h[::-1], atol=1e-15)  # symmetric
    # DC gain L (so a constant stays a constant through the resampler)
    assert abs(np.sum(h) / 160 - 1.0) < 1e-3


def test_dc_preservation():
    """A constant input must come out (nearly) the same constant."""
    x = np.full(44100, 0.25, np.float32)
    y = _run(x, 44100, 16000)
    mid = y[2000:-2000]
    np.testing.assert_allclose(mid, 0.25, atol=1e-3)


def test_framed_lane_padding_ignored(rng):
    """polyphase_resample_framed accepts a lane-padded (..., nc, Mp>M)
    operand (padding the frame's minor dimension)
    and the pad lanes never reach the output: padded filter rows are
    zero and the correction dots slice only real lanes. Garbage pad
    values must therefore give the same answer as the unpadded frames
    (up to dot-accumulation reordering)."""
    sr_in, sr_out = 44100, 16000
    M = 441
    x = rng.standard_normal((2, 20 * M)).astype(np.float32)
    A = x.reshape(2, 20, M)
    Ap = np.concatenate(
        [A, rng.standard_normal((2, 20, 512 - M)).astype(np.float32) * 1e3],
        axis=-1)  # deliberately non-zero pad
    f = jax.jit(lambda a: R.polyphase_resample_framed(a, sr_in, sr_out))
    y = np.asarray(f(jnp.asarray(A))).reshape(2, -1)
    yp = np.asarray(f(jnp.asarray(Ap))).reshape(2, -1)
    assert yp.shape == y.shape
    assert rms_db(yp - y, y) <= -120.0
    with pytest.raises(ValueError):
        R.polyphase_resample_framed(jnp.zeros((2, 20, M - 1)), sr_in, sr_out)


def test_framed_unsupported_pair_raises():
    """A rate pair outside the aligned banded geometry (filter width >
    2*M) must fail with a named ValueError at the API edge, not an
    opaque dot_general shape error deep in the correction matmuls
    (review find)."""
    with pytest.raises(ValueError, match="aligned banded"):
        R.polyphase_resample_framed(jnp.zeros((2, 16, 1)), 8000, 48000)
