"""Sequence-parallelism tests: one clip time-sharded over an 8-device
virtual mesh must equal the single-device ops (SURVEY.md §2.2 SP row).

These tests require multiple devices; they skip themselves unless the
suite runs with XLA_FLAGS=--xla_force_host_platform_device_count=8 (or
on a real multi-chip mesh). `tests/run_sp_cpu.sh`-style invocation:
PYTHONPATH= JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -m pytest tests/test_sp.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import xmtpu  # noqa: F401
from .conftest import rms_db

from xmtpu.ops import biquad, limiter, reverb
from xmtpu.parallel import sp_biquad, sp_effects_chain, sp_envelope, sp_fir

SR = 48000
BANDS = [
    {"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
    {"freq_hz": 400.0, "gain_db": -3.0, "q": 1.2},
    {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
    {"freq_hz": 4000.0, "gain_db": -2.0, "q": 1.1},
    {"freq_hz": 12000.0, "gain_db": 3.0, "q": 0.8},
]


@pytest.fixture(autouse=True)
def _multi_device():
    """Decided at run time, never at import: every xdist worker must
    collect the same tests."""
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh (virtual CPU devices ok)")


@pytest.fixture
def mesh(_multi_device):
    devs = jax.devices()
    return jax.sharding.Mesh(np.array(devs), ("sp",))


def test_sp_fir_equals_local(mesh, rng):
    n = 8 * 2048
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    taps = reverb.synthetic_ir(0.01, SR).astype(np.float32)  # 480 taps
    ref = np.asarray(
        reverb.fir_convolve_full(jnp.asarray(x), jnp.asarray(taps))
    )[: n]
    got = np.asarray(sp_fir(jnp.asarray(x), taps, mesh))
    db = rms_db(got.astype(np.float64) - ref, ref)
    assert db <= -100.0, db


def test_sp_fir_halo_crosses_boundary(mesh):
    """Impulse at the end of shard 0 must ring into shard 1."""
    n_sh = len(jax.devices())
    n = n_sh * 1024
    x = np.zeros(n, np.float32)
    x[1023] = 1.0  # last sample of shard 0
    taps = np.zeros(64, np.float32)
    taps[10] = 1.0  # pure delay of 10
    got = np.asarray(sp_fir(jnp.asarray(x), taps, mesh))
    assert got[1033] == pytest.approx(1.0, abs=1e-4)  # landed in shard 1
    assert np.sum(np.abs(got)) == pytest.approx(1.0, abs=1e-2)  # FFT noise


def test_sp_biquad_equals_scan(mesh, rng):
    n = 8 * 4096
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    sos = biquad.eq_sos(BANDS, SR)
    ref, _ = biquad.sosfilt_scan(sos, jnp.asarray(x))
    got = np.asarray(sp_biquad(sos, jnp.asarray(x), mesh))
    db = rms_db(got.astype(np.float64) - np.asarray(ref, np.float64),
                np.asarray(ref, np.float64))
    assert db <= -100.0, db


def test_sp_envelope_equals_scan(mesh, rng):
    n = 8 * 2048
    d = np.abs(2.0 * rng.standard_normal(n)).astype(np.float64)
    k_rel = limiter._release_coeff(100.0, SR)
    c_att = limiter._attack_coeff(1.0, SR)
    env_ref, _ = limiter.decaying_max_scan(jnp.asarray(d), k_rel,
                                           jnp.zeros((), jnp.float64))
    e2_ref, _ = limiter.onepole_scan(env_ref, c_att,
                                     jnp.zeros((), jnp.float64))
    got = np.asarray(sp_envelope(jnp.asarray(d), SR, mesh,
                                 attack_ms=1.0, release_ms=100.0))
    ref = np.asarray(e2_ref, np.float64)
    db = rms_db(got - ref, ref)
    assert db <= -100.0, db


def test_sp_effects_chain_equals_single_device(mesh, rng):
    """Config-3 chain on one long stereo clip, time-sharded, equals the
    single-device ops chain."""
    n = 8 * 4096
    x = np.stack([
        (0.5 * rng.standard_normal(n)).astype(np.float32),
        (0.5 * rng.standard_normal(n)).astype(np.float32),
    ])  # (2, n)
    sos = biquad.eq_sos(BANDS, SR)
    ir = reverb.synthetic_ir(0.02, SR).astype(np.float32)

    # single-device reference via ops twins
    y_ref, _ = biquad.sosfilt_scan(sos, jnp.asarray(x))
    y_ref = reverb.reverb(y_ref, jnp.asarray(ir), wet=0.3, dry=0.7)
    y_ref, _ = limiter.limiter(y_ref, SR, threshold_db=-6.0)
    y_ref = np.asarray(y_ref, np.float64)

    got = np.asarray(sp_effects_chain(
        jnp.asarray(x), SR, mesh, bands=sos, ir=ir, wet=0.3, dry=0.7,
        threshold_db=-6.0,
    ), np.float64)
    db = rms_db(got - y_ref, y_ref)
    assert db <= -80.0, db


def test_dpsp_2d_mesh_equals_single_device(_multi_device, rng):
    """2-D (dp, sp) mesh: a BATCH of long clips sharded over clips AND
    time (SURVEY.md §5 "optional (batch, block) mesh") equals the
    single-device ops chain per clip."""
    devs = jax.devices()
    if len(devs) < 4 or len(devs) % 2:
        pytest.skip("needs >=4 (even) devices for a 2-D mesh")
    n_sp = len(devs) // 2
    mesh_2d = jax.sharding.Mesh(np.array(devs).reshape(2, n_sp),
                                ("dp", "sp"))
    B, n = 4, n_sp * 4096
    x = (0.5 * rng.standard_normal((B, 2, n))).astype(np.float32)
    sos = biquad.eq_sos(BANDS, SR)
    ir = reverb.synthetic_ir(0.02, SR).astype(np.float32)

    y_ref, _ = biquad.sosfilt_scan(sos, jnp.asarray(x))
    y_ref = reverb.reverb(y_ref, jnp.asarray(ir), wet=0.3, dry=0.7)
    y_ref, _ = limiter.limiter(y_ref, SR, threshold_db=-6.0)
    y_ref = np.asarray(y_ref, np.float64)

    got = np.asarray(sp_effects_chain(
        jnp.asarray(x), SR, mesh_2d, bands=sos, ir=ir, wet=0.3, dry=0.7,
        threshold_db=-6.0, dp_axis="dp",
    ), np.float64)
    db = rms_db(got - y_ref, y_ref)
    assert db <= -80.0, db


def test_sp_fir_halo_exceeds_shard_raises():
    """A FIR halo longer than the shard must raise, not silently zero
    the missing neighbor samples (round-2 review find)."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    from xmtpu.parallel import sp as _sp

    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs a multi-device mesh")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    x = jnp.zeros((1, 256))
    taps = jnp.ones(200)  # halo 199 > shard length 128
    import pytest
    with pytest.raises(ValueError, match="halo"):
        _sp.sp_fir(x, taps, mesh)


def test_sp_effects_chain_megasample_shards(_multi_device, rng):
    """SP at the lengths it exists for: long shards over 2 devices (the
    per-shard length, not the shard count, is what stresses compile).
    Oracle: scipy sosfilt + fftconvolve + the f64 scan envelope.
    Compile+run time is printed. The always-on leg runs 256k
    samples/shard; XMTPU_SLOW=1 runs 1M/shard."""
    import time

    from scipy import signal as sps

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("sp",))
    n_sh = 2
    slow = os.environ.get("XMTPU_SLOW", "") not in ("", "0")
    per_shard = (1 << 20) if slow else (1 << 18)
    n = n_sh * per_shard
    sr = 16000
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)[None]  # (1, n)
    ir = reverb.synthetic_ir(0.15, sr).astype(np.float32)  # 2400 taps
    sos = biquad.eq_sos(BANDS[:3], sr)

    t0 = time.perf_counter()
    got = np.asarray(
        sp_effects_chain(jnp.asarray(x), sr, mesh, sos, ir),
        np.float64,
    )
    wall = time.perf_counter() - t0
    print(f"\nsp_effects_chain {n_sh}x{per_shard}: {wall:.1f} s "
          "(compile + run, virtual CPU mesh)")

    # f64 oracle chain (scipy EQ/reverb; jax f64 scans for the envelope)
    y = sps.sosfilt(np.asarray(sos, np.float64), x.astype(np.float64),
                    axis=-1)
    w = sps.fftconvolve(
        y, np.broadcast_to(ir.astype(np.float64), y.shape[:-1] + ir.shape),
        axes=-1)[..., : n]
    y = 0.7 * y + 0.3 * w
    d = jnp.asarray(np.max(np.abs(y), axis=-2))
    env, _ = limiter.decaying_max_scan(d, limiter._release_coeff(100.0, sr),
                                       jnp.zeros(()))
    e2, _ = limiter.onepole_scan(env, limiter._attack_coeff(1.0, sr),
                                 jnp.zeros(()))
    level_db = 20.0 * np.log10(np.maximum(np.asarray(e2), 1e-12))
    over = level_db - (-3.0)
    red = np.where(over <= -3.0, 0.0,
                   np.where(over >= 3.0, over, (over + 3.0) ** 2 / 12.0))
    ref = np.clip(y * 10.0 ** (-red / 20.0)[None], -1.0, 1.0)
    db = rms_db(got - ref, ref)
    assert db <= -80.0, db
    assert wall < 600.0, f"compile+run took {wall:.0f}s"


def test_sp_jit_cache_reuses_and_keys_on_content(mesh, rng):
    """Repeat calls must reuse the cached SPMD program (the entry
    points used to jit a fresh closure per call — a recompile per
    clip), while changed closed-over arrays (taps) must
    MISS the cache instead of reusing a stale baked constant."""
    from xmtpu.parallel import sp as _sp

    x = rng.standard_normal((2, 8 * 512)).astype(np.float32)
    taps_a = np.zeros(9, np.float32); taps_a[0] = 1.0
    taps_b = np.zeros(9, np.float32); taps_b[4] = 1.0  # 4-sample delay
    _sp._JIT_CACHE.clear()
    ya1 = np.asarray(sp_fir(jnp.asarray(x), taps_a, mesh))
    assert len(_sp._JIT_CACHE) == 1
    fn_first = next(iter(_sp._JIT_CACHE.values()))
    ya2 = np.asarray(sp_fir(jnp.asarray(x), taps_a, mesh))
    assert len(_sp._JIT_CACHE) == 1
    assert next(iter(_sp._JIT_CACHE.values())) is fn_first
    np.testing.assert_array_equal(ya1, ya2)
    yb = np.asarray(sp_fir(jnp.asarray(x), taps_b, mesh))
    assert len(_sp._JIT_CACHE) == 2  # content-keyed: new taps, new entry
    # identity taps pass through; delay taps shift — a stale cache hit
    # would have made these equal
    np.testing.assert_allclose(ya1, x, atol=1e-6)
    np.testing.assert_allclose(yb[:, 4:], x[:, :-4], atol=1e-6)
