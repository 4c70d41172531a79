"""16- and 32-slab certification.

Slab counts past the 8-device dryrun: these tests run
the FULL dryrun battery — oracle DD, window DD exact + sticky modes,
elastic-recovery rebuild, per-slab render — at n_devices ∈ {16, 32} on a
scene wide enough to satisfy the >= 6-owned-columns halo-minor
constraint (2x the 3-cell halo strips).

Device count is fixed at backend init, so each count runs in a fresh
subprocess with its own xla_force_host_platform_device_count (the same
virtual-CPU-mesh substitution the rest of the suite uses, SURVEY §4).
Reference anchor: the parallelism row `pi_sph_fluid.c:610`.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_dryrun(n_devices: int, timeout: int = 1500):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__ as g; "
         f"g.dryrun_multichip({n_devices}, interpret=True); "
         f"print('ok {n_devices}')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"dryrun({n_devices}) failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
    assert f"ok {n_devices}" in r.stdout


@pytest.mark.parametrize("n_devices", [16, 32])
def test_wide_slab_dryrun(n_devices):
    _run_dryrun(n_devices)
