"""chip_smoke.py off the card: its arguments, its refusal to run without
a GPU, and every phase rehearsed at a tiny size on the CPU (the XLA
engine, so the same checks against the float64 references run here).
The multi-card phases run in a child on four virtual CPU devices."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


@pytest.mark.parametrize("argv,chips,seed", [
    ([], 1, 0), (["--chips", "4"], 4, 0), (["--chips", "1", "--seed", "7"], 1, 7)])
def test_parse_args(argv, chips, seed):
    a = chip_smoke.parse_args(argv)
    assert (a.chips, a.seed) == (chips, seed)


@pytest.mark.parametrize("argv", [["--chips", "2"], ["--bogus"]])
def test_parse_args_rejects(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """No GPU (or no repo beside the script): non-zero, no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        dst = tmp_path / "chip_smoke.py"
        dst.write_bytes(open(script, "rb").read())
        script = str(dst)
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_rms_db_and_require():
    assert chip_smoke.rms_db([1.0, 2.0], [1.0, 2.0]) == float("-inf")
    assert abs(chip_smoke.rms_db([1.1], [1.0]) - (-20.0)) < 1e-9
    with pytest.raises(chip_smoke.PhaseError, match="why"):
        chip_smoke.require(False, "why")


def test_phase_flagship_tiny():
    assert "accuracy_db" in chip_smoke.phase_flagship(0, B=2, seconds=1.0)


def test_phase_effects_tiny():
    assert "XLA float64" in chip_smoke.phase_effects(0, B=2, n=4800)


def test_phase_runner_tiny():
    assert "3 clips" in chip_smoke.phase_runner(
        0, lengths=(44100, 20000, 12345))


def test_phase_serving_tiny():
    assert "pumped twice" in chip_smoke.phase_serving(0, K=4, frames=4,
                                                      groups=2)


def test_phase_lufs_tiny():
    assert "LUFS" in chip_smoke.phase_lufs(0, seconds=30.0)


def test_phase_cli():
    assert "440" in chip_smoke.phase_cli(seconds=1.0)


def test_multi_card_phases_on_virtual_mesh():
    """The --chips 4 phases (dp bit-exactness, mesh pool, sp and dp x sp
    against the float64 reference) on four virtual CPU devices."""
    code = (
        "import chip_smoke as c, jax; assert len(jax.devices()) == 4; "
        "import xmtpu; "
        "print(c.phase_dp(0, 4, B=8, seconds=0.1)); "
        "print(c.phase_pool_mesh(0, 4, K=4, frames=4, groups=2)); "
        "print(c.phase_sp(0, 4, seconds=4.0))")
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=900, env=_cpu_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "bit for bit" in r.stdout and "dp x sp" in r.stdout
