#!/usr/bin/env python3
"""One process of a multi-host WindowDomain run (the multi-host test fixture).

Launched N times (same command, different --process-id) by
tests/test_multihost.py and __graft_entry__.dryrun_multihost: each process
forces the CPU platform with --devices-per-process virtual devices, joins
the cross-process JAX runtime, and runs the FULL dd machinery —
migration + halo ppermutes + sticky groups + per-slab render — over a
mesh whose slab edges *cross the process boundary* (devices d/2-1 <-> d/2
live in different processes, so their halo exchange rides the
cross-process collective path, gloo here, the network on a cluster).

Process 0 writes the final exported state to --out; the harness compares
it against a single-process run of the identical mesh shape — bit-level
agreement certifies that nothing about process boundaries changes the
physics.  This is the JAX analog of the reference's compile-time backend
substitution (SURVEY §4; `Makefile:18-23`), applied to the cluster.
"""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="127.0.0.1:9933")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--resort-every", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None, help="npz path for the exported "
                    "final state (written by process 0)")
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.devices_per_process}").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from pi_sph_fluid_tpu.parallel.launch import init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     initialization_timeout=60)
    assert jax.process_count() == args.num_processes
    n_dev = args.num_processes * args.devices_per_process
    assert len(jax.devices()) == n_dev, (len(jax.devices()), n_dev)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import pi_sph_fluid_tpu as sph
    from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain

    cfg = sph.SPHConfig()   # 441-particle dam break, 21 grid columns
    fluid, braw = sph.build_dam_break_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    mesh = Mesh(np.asarray(jax.devices()), ("x",))
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, mesh,
                      qb=8, cap=256, seg_q=2, interpret=True)
    state = dd.init(fluid)
    g = jnp.asarray((0.0, -9.81), jnp.float32)

    # exact step (per-step relayout path: migration + halo exchange)
    step = jax.jit(dd.make_step())
    state, st = step(state, g)
    assert int(st["n_valid"]) == fluid.n, (int(st["n_valid"]), fluid.n)
    assert int(st["overflow"]) == 0
    assert np.isfinite(float(st["max_speed"]))

    # sticky groups (carried-halo ppermutes across the process boundary)
    multi = jax.jit(dd.make_multi_step(resort_every=args.resort_every))
    g_tr = jnp.broadcast_to(g, (args.steps, 2))
    state, stm = multi(state, g_tr)
    nv = int(np.asarray(stm["n_valid"])[-1])
    assert nv == fluid.n, (nv, fluid.n)
    assert int(np.max(np.asarray(stm["overflow"]))) == 0
    assert int(np.sum(np.asarray(stm["stale"]))) == 0

    # per-slab render composes across processes too
    render = jax.jit(dd.make_render(64, 128))
    fb, r_ov = render(state)
    fb = np.asarray(fb)
    assert int(r_ov) == 0
    assert 0 < int(np.unpackbits(fb).sum()) < 64 * 128

    # lossless export (process_allgather over the process boundary)
    fl, au, av = dd.export(state)
    assert fl.x.shape[0] == fluid.n
    if args.out and jax.process_index() == 0:
        np.savez(args.out,
                 **{f: np.asarray(getattr(fl, f))
                    for f in type(fl)._fields},
                 au=au, av=av, fb=fb)
    print(f"[proc {args.process_id}] multihost OK: {args.num_processes} "
          f"procs x {args.devices_per_process} devs, n_valid={nv}",
          flush=True)


if __name__ == "__main__":
    main()
