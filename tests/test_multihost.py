"""Multi-host certification: WindowDomain across a process boundary.

Launches tools/multihost_worker.py as 2 REAL processes x 4 virtual CPU
devices each, joined by jax.distributed over a local coordinator — the
slab edge between global devices 3 and 4 crosses the process boundary, so
migration ppermutes, halo exchanges (fresh + carried-tick), the per-slab
render compose, and the export all-gather all ride the cross-process
collective path (gloo here; the network on a cluster, parallel/launch.py).

The certification is PARITY: the 2-process export must equal a
single-process run of the identical 8-device mesh bit-for-bit — process
boundaries are pure transport and may not change the physics.

Reference anchor: the parallelism row `pi_sph_fluid.c:610` (one OpenMP
region); SURVEY §5 names multi-host as the scale-out requirement.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_export(tmp_path_factory):
    """Run the 2-process worker pair once; yields the exported npz."""
    out = str(tmp_path_factory.mktemp("mh") / "export.npz")
    port = _free_port()
    env = dict(os.environ)
    # the worker picks its own platform and virtual device count
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--devices-per-process", "4", "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(stdout)
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{o[-4000:]}"
        assert "multihost OK" in o
    return np.load(out)


def _single_process_reference():
    """The identical run on the in-process 8-device mesh (conftest forces
    8 virtual CPU devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import pi_sph_fluid_tpu as sph
    from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain

    cfg = sph.SPHConfig()
    fluid, braw = sph.build_dam_break_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("x",))
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, mesh,
                      qb=8, cap=256, seg_q=2, interpret=True)
    state = dd.init(fluid)
    g = jnp.asarray((0.0, -9.81), jnp.float32)
    state, _ = jax.jit(dd.make_step())(state, g)
    multi = jax.jit(dd.make_multi_step(resort_every=2))
    state, _ = multi(state, jnp.broadcast_to(g, (8, 2)))
    fb, _ = jax.jit(dd.make_render(64, 128))(state)
    fl, au, av = dd.export(state)
    return fl, au, av, np.asarray(fb)


def test_two_process_matches_single_process(two_process_export):
    """Bitwise parity: transport topology must not change the physics."""
    fl, au, av, fb = _single_process_reference()
    got = two_process_export
    for f in type(fl)._fields:
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(fl, f)), err_msg=f"field {f}")
    np.testing.assert_array_equal(got["au"], au)
    np.testing.assert_array_equal(got["av"], av)
    np.testing.assert_array_equal(got["fb"], fb)


def test_cli_accepts_distributed_flags():
    """--num-processes > 1 without a coordinator must fail loudly, and the
    single-process default must not touch jax.distributed."""
    from pi_sph_fluid_tpu import cli

    with pytest.raises(SystemExit):
        cli.main(["bench", "--num-processes", "2", "--n", "100",
                  "--steps", "2", "--backend", "reference"])
