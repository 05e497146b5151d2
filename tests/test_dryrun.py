"""Hermeticity of the self-provisioned multichip dryrun child.

The virtual CPU mesh needs its device count fixed when JAX starts, so
``dryrun_multichip`` runs its legs in a child process with an
allowlisted env (``__graft_entry__._child_env``) and an in-child
cpu-backend assertion. These tests pin that: no parent variable reaches
the child, and a hostile parent still gets a clean CPU child.
"""

from __future__ import annotations

import os
import subprocess
import sys

import __graft_entry__ as ge


def test_child_env_allowlist_drops_parent_vars(monkeypatch):
    """A poisoned parent env must not leak backend-pinning vars into
    the provisioned child."""
    poison = {
        "JAX_PLATFORMS": "cuda",
        "XLA_FLAGS": "--some_parent_flag",
        "JAX_COMPILATION_CACHE_DIR": "/somewhere/foreign",
        "PYTHONPATH": "/somewhere/site",
        "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.9",
        "SOME_RANDOM_DRIVER_VAR": "1",
    }
    for k, v in poison.items():
        monkeypatch.setenv(k, v)
    env = ge._child_env(8)
    for k in poison:
        if k in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH"):
            continue  # overwritten below, assert values instead
        assert k not in env, k
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "--xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]
    assert env["XMTPU_DRYRUN_CHILD"] == "1"
    assert os.path.samefile(env["PYTHONPATH"], os.path.dirname(ge.__file__))
    # nothing outside the allowlist + the vars we set ourselves
    ours = {"PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS",
            "XMTPU_DRYRUN_CHILD"}
    assert set(env) <= set(ge._CHILD_ENV_KEEP) | ours


def test_dryrun_survives_poisoned_parent_env(tmp_path):
    """End-to-end: dryrun_multichip(2) run from a parent whose env and
    PYTHONPATH are hostile (a sitecustomize that pins a fake platform)
    still provisions a clean CPU child and passes the dp leg."""
    hostile = tmp_path / "hostile"
    hostile.mkdir()
    (hostile / "sitecustomize.py").write_text(
        "import os\n"
        "os.environ['JAX_PLATFORMS'] = 'bogus'\n"
    )
    repo = os.path.dirname(os.path.abspath(ge.__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(hostile)
    env["JAX_PLATFORMS"] = "bogus"
    env["XMTPU_DRYRUN_LEGS"] = "dp"  # keep the child cheap
    env.pop("XMTPU_DRYRUN_CHILD", None)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, os.path.join(repo, "__graft_entry__.py"),
         "multichip", "2"],
        env=env, capture_output=True, text=True, timeout=580, cwd=repo)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    assert "dp OK" in res.stdout, res.stdout[-2000:]


def test_dryrun_driver_provisioned_env_still_uses_child(tmp_path):
    """A caller that already provisions ``JAX_PLATFORMS=cpu`` +
    ``--xla_force_host_platform_device_count=8`` must still get the
    child: a startup hook can re-pin the platform at jax-INIT time,
    invisible to any env-var inspection. Emulated by a hostile
    sitecustomize that re-pins the platform via ``jax.config.update``;
    if the legs ran in this process they would crash on the unknown
    platform, so they must run in the hermetic child instead (whose
    PYTHONPATH does not hold the hostile hook)."""
    hostile = tmp_path / "hostile"
    hostile.mkdir()
    (hostile / "sitecustomize.py").write_text(
        "import jax\n"
        "jax.config.update('jax_platforms', 'bogus')\n"
    )
    repo = os.path.dirname(os.path.abspath(ge.__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(hostile)
    env["JAX_PLATFORMS"] = "cpu"  # exactly what the driver sets
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["XMTPU_DRYRUN_LEGS"] = "dp"  # keep the child cheap
    env.pop("XMTPU_DRYRUN_CHILD", None)
    res = subprocess.run(
        [sys.executable, os.path.join(repo, "__graft_entry__.py"),
         "multichip", "2"],
        env=env, capture_output=True, text=True, timeout=580, cwd=repo)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    assert "dp OK" in res.stdout, res.stdout[-2000:]


def _cpu_mesh_or_skip(n):
    import pytest

    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu" or len(jax.devices()) < n:
        pytest.skip(f"needs a cpu backend with >= {n} devices")


def test_single_leg_restrictions_reach_their_leg(monkeypatch, capsys):
    """Every XMTPU_DRYRUN_LEGS single-leg restriction must run (or skip)
    cleanly — the hook exists to bisect a red driver artifact, so it
    must not crash when first used in anger (round 4: legs="2d" alone
    raised NameError on an unbound rng before the leg ran). Runs the
    legs in-process (XMTPU_DRYRUN_CHILD=1) on the test env's virtual
    CPU mesh; one test, shared jit caches."""
    _cpu_mesh_or_skip(4)
    import __graft_entry__ as ge_mod

    monkeypatch.setenv("XMTPU_DRYRUN_CHILD", "1")
    for leg in ("dp", "sp", "pool", "2d", "serve"):
        monkeypatch.setenv("XMTPU_DRYRUN_LEGS", leg)
        ge_mod.dryrun_multichip(4)
        out = capsys.readouterr().out
        assert f"{leg} OK" in out or (
            leg == "2d" and "dp x sp OK" in out), (leg, out)


def test_dryrun_child_asserts_cpu_backend(tmp_path):
    """If the backend somehow comes up non-cpu inside the provisioned
    child, the child must fail IMMEDIATELY with a diagnostic naming the
    platform — not deep inside device_put. Simulated by running the
    child entry with XMTPU_DRYRUN_CHILD=1 and a non-cpu JAX_PLATFORMS
    (nothing on the path corrects it)."""
    repo = os.path.dirname(os.path.abspath(ge.__file__))
    env = {k: os.environ[k] for k in ge._CHILD_ENV_KEEP
           if k in os.environ}
    env["PYTHONPATH"] = repo
    env["JAX_PLATFORMS"] = "cpu"  # backend really IS cpu...
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["XMTPU_DRYRUN_CHILD"] = "1"
    env["XMTPU_DRYRUN_LEGS"] = "dp"
    # ...but the assertion must compare against jax.default_backend(),
    # so patch the expectation by asking for a platform mismatch via a
    # tiny driver script that monkeypatches default_backend.
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys, os\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import jax\n"
        "jax.default_backend = lambda: 'bogus'\n"
        "import __graft_entry__ as ge\n"
        "try:\n"
        "    ge.dryrun_multichip(2)\n"
        "except RuntimeError as e:\n"
        "    assert 'bogus' in str(e) and 'cpu backend' in str(e), e\n"
        "    print('DIAGNOSED')\n"
        "else:\n"
        "    sys.exit('expected RuntimeError')\n"
    )
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    assert "DIAGNOSED" in res.stdout
