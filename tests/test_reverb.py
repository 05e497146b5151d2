"""The XLA FFT reverb and the LTI fold against the float64 oracles
(``ops.reverb.reverb_np``, scipy ``fftconvolve``/``sosfilt``)."""

from __future__ import annotations

import numpy as np
import pytest
from scipy import signal

import jax
import jax.numpy as jnp

import xmtpu  # noqa: F401
from xmtpu.graph import fx as fxg
from xmtpu.ops import biquad
from xmtpu.ops import reverb as _rv

from .conftest import rms_db

BANDS = [{"freq_hz": 120.0, "gain_db": 3.0, "q": 1.0},
         {"freq_hz": 2500.0, "gain_db": -2.0, "q": 1.3}]


def _ir(rng, m):
    ir = rng.standard_normal(m) * np.exp(-np.arange(m) / m * 5.0)
    return ir / np.sqrt((ir**2).sum())


@pytest.mark.parametrize("R,n,m,block", [
    (3, 48000, 24000, 65536),  # odd rows, config-3-like IR
    (4, 48000, 8000, 16384),   # multi-frame
    (1, 9600, 4000, 32768),    # single row, n < hop
    (5, 48000, 4000, 16384),   # many rows
    (2, 20000, 300, None),     # one full-size transform
])
def test_xla_reverb_matches_oracle(rng, R, n, m, block):
    x = rng.standard_normal((R, n)).astype(np.float32)
    ir = _ir(rng, m)
    y = _rv.reverb(jnp.asarray(x), ir.astype(np.float32), wet=0.3, dry=0.7,
                   block=block)
    ref = _rv.reverb_np(x, ir, wet=0.3, dry=0.7)
    assert y.shape == x.shape
    assert rms_db(np.asarray(y, np.float64) - ref, ref) < -90


def test_xla_reverb_3d_batch_and_prescale(rng):
    """(B, C, n) batches, and the prescale gain riding the epilogue."""
    x = rng.standard_normal((2, 2, 9600)).astype(np.float32)
    ir = _rv.synthetic_ir(0.1, 16000)
    s = np.array([0.5, 2.0], np.float32)[:, None, None]
    y = _rv.reverb(jnp.asarray(x), ir.astype(np.float32), wet=0.25,
                   dry=0.75, block=16384, prescale=s)
    ref = _rv.reverb_np(x * s, ir, wet=0.25, dry=0.75)
    assert rms_db(np.asarray(y, np.float64) - ref, ref) < -90


@pytest.mark.parametrize("m,want", [
    (1, 32768), (4000, 32768), (8194, 65536), (24000, 131072),
    (150000, 1 << 20)])
def test_os_block_keeps_three_quarter_hop(m, want):
    b = _rv.os_block(m)
    assert b == want and b >= 4 * (m - 1)


@pytest.mark.parametrize("chain", [
    ["eq", "reverb"], ["eq", "reverb", "volume"], ["volume", "reverb", "eq"]])
def test_lti_fold_matches_oracle(rng, chain):
    """The card's engine folds adjacent EQ/reverb/volume into ONE FFT
    convolution (FusedLTIFx); through the public chain it matches the
    composed float64 oracles."""
    sr = 16000
    ir = _rv.synthetic_ir(0.05, sr, seed=3)
    spec = {"eq": {"name": "equalizer", "bands": BANDS},
            "reverb": {"name": "reverb", "ir": ir, "wet": 0.4, "dry": 0.6},
            "volume": {"name": "volume", "gain_db": -3.0}}
    effects = fxg.build_chain(sr, [spec[c] for c in chain],
                              default_backend="gpu_interpret")
    assert [type(e).__name__ for e in effects] == ["FusedLTIFx"]
    x = (0.3 * rng.standard_normal((1, 12000))).astype(np.float32)
    y, _ = jax.jit(lambda v: fxg.chain_apply(effects, v, (None,)))(
        jnp.asarray(x))
    ref = x.astype(np.float64)
    sos = biquad.eq_sos(BANDS, sr)
    for c in chain:
        if c == "eq":
            ref = signal.sosfilt(sos, ref, axis=-1)
        elif c == "reverb":
            ref = _rv.reverb_np(ref, ir, wet=0.4, dry=0.6)
        else:
            ref = ref * 10 ** (-3.0 / 20)
    assert rms_db(np.asarray(y, np.float64) - ref, ref) <= -100.0


def test_fused_lti_blocked_state_equals_whole(rng):
    """FusedLTIFx carries the overlap-add tail across blocks exactly."""
    h = _rv.synthetic_ir(0.02, 16000)
    fx = fxg.FusedLTIFx(h, folded=())
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    whole, _ = fx.apply(jnp.asarray(x), None)
    st = fx.init_state((2,))
    outs = []
    for i in range(0, 4000, 1000):
        y, st = fx.apply(jnp.asarray(x[:, i:i + 1000]), st)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, -1).astype(np.float64)
    ref = np.asarray(whole, np.float64)
    assert rms_db(got - ref, ref) <= -100.0
