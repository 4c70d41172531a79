#!/usr/bin/env python3
"""Bring-up check of the WCSPH main path on a GPU, in one process.

    python chip_smoke.py           # phases 1-5 on one GPU
    python chip_smoke.py --multi   # the 4-GPU domain decomposition only

Phases (each failure raises, so the exit code is nonzero and the final
``"ok": true`` line is never printed):

1. device    JAX's default device must be a GPU.
2. kernels   at the 100k pool after one relayout: the compiled Triton
             density/forces passes vs the plain jax.numpy passes (rho rtol
             1e-5; accelerations within 1e-4 of max |a|); the window
             field pass vs a brute-force field (>= 99.9% of pixels agree
             after the threshold); then WindowEngine vs the jnp oracle for
             100 exact steps (positions atol 1e-5 m).
3. golden    the 3k C-golden drop through the production engine with the
             gates of tests/test_parity_3k.py (3e-6 m at step 500, 1e-5 at
             1000, 5e-5 at 2000).
4. toy       ``cli run`` on the 269-particle drop with rendering and
             --realtime for one sim-second to a file display: frames
             written, zero overflow; ticks/s printed beside the reference's
             4102.
5. scale     the 1M pool through SimRunner as ``cli bench --n 1000000
             --resort-every 64 --render`` runs it: zero stale drift, zero
             overflow (window and render), finite state, max rho error
             < 2%; ms/step and peak device memory printed.
6. --multi   WindowDomain over 4 GPUs vs the single-GPU WindowEngine on
             the 1M pool: 64 exact steps, then one resort-64 sticky group;
             positions atol 1e-5 m (see phase_multi), every overflow
             category 0.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
G = (0.0, -9.81)


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def _pool(n: int):
    import pi_sph_fluid_tpu as sph

    cfg = sph.SPHConfig(r=math.sqrt(6.35 / n))
    fluid, braw = sph.build_pool_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    return cfg, fluid, braw, boundary, bgrid


def _pair_passes(eng, passes, pk, ctx):
    """One density + forces evaluation of ``eng``'s frame with the given
    (density, forces) implementations — the plumbing of
    WindowEngine._pair_core."""
    import jax.numpy as jnp

    density, forces = passes
    cfg, spec = eng.cfg, eng.spec
    zcol = jnp.zeros((pk.shape[0], 1), jnp.float32)
    src_d = jnp.concatenate([jnp.concatenate([pk[:, 0:2], pk[:, 4:5], zcol], 1),
                             eng.b_geo_d, eng.inert_row_d], 0)
    geo8, rp = density(pk, src_d[ctx.trip_src].T, ctx.w_start, ctx.w_len,
                       cfg, spec)
    src_f = jnp.concatenate([geo8, eng.b_geo, eng.inert_row], 0)
    _, acc = forces(pk, geo8, rp, src_f[ctx.trip_src].T, ctx.w_start,
                    ctx.w_len, jnp.asarray(G, jnp.float32), cfg, spec,
                    half_dt=0.5 * cfg.dt, damp=1.0)
    return rp[:, 0], acc


def _brute_field(cfg, fluid_x, fluid_y, rows, cols, field_scale):
    """Dense pixels x particles metaball field, particle chunks in a scan."""
    import jax
    import jax.numpy as jnp

    from pi_sph_fluid_tpu.models.scene import pixel_centers

    px, py = (jnp.asarray(a) for a in pixel_centers(cfg, rows, cols))
    chunk = 8192
    n = fluid_x.shape[0]
    pad = -n % chunk
    fx = jnp.pad(fluid_x, (0, pad), constant_values=-1e6).reshape(-1, chunk)
    fy = jnp.pad(fluid_y, (0, pad), constant_values=-1e6).reshape(-1, chunk)
    h = jnp.float32(cfg.h)

    def body(acc, xy):
        dx = px[:, None] - xy[0][None, :]
        dy = py[:, None] - xy[1][None, :]
        r = jnp.sqrt(dx * dx + dy * dy)
        t1 = jnp.maximum(1.0 - (jnp.float32(0.5) / h) * r, 0.0)
        t1sq = t1 * t1
        w = (t1sq * t1sq) * (1.0 + (jnp.float32(2.0) / h) * r)
        return acc + jnp.sum(w, axis=1), None

    acc, _ = jax.lax.scan(body, jnp.zeros(px.shape, jnp.float32), (fx, fy))
    return acc * jnp.float32(field_scale)


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine
    from pi_sph_fluid_tpu.models.simulation import make_multi_step, prime
    from pi_sph_fluid_tpu.ops.pallas import window_kernels as wk
    from pi_sph_fluid_tpu.render.metaballs_window import WindowRenderer

    cfg, fluid, _, boundary, bgrid = _pool(100_000)
    log(f"  100k pool: {fluid.n} fluid particles")
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n)
    sim = eng.prime(fluid, G)
    pk, ctx, ov = jax.jit(eng._relayout)(sim.packed)
    check(int(ov) == 0, "relayout overflow 0")
    kern = jax.jit(lambda pk, ctx: _pair_passes(
        eng, (wk.density_window_call, wk.forces_window_call), pk, ctx))
    plain = jax.jit(lambda pk, ctx: _pair_passes(
        eng, (wk.density_plain, wk.forces_plain), pk, ctx))
    (rho_k, acc_k), (rho_p, acc_p) = kern(pk, ctx), plain(pk, ctx)
    real = np.asarray(pk[:, 4]) > 0
    rho_k, rho_p = np.asarray(rho_k)[real], np.asarray(rho_p)[real]
    acc_k, acc_p = np.asarray(acc_k)[real], np.asarray(acc_p)[real]
    rho_rel = float(np.max(np.abs(rho_k - rho_p) / rho_p))
    acc_rel = float(np.max(np.abs(acc_k - acc_p)) / np.max(np.abs(acc_p)))
    log(f"  density: max rel err {rho_rel:.3e}; forces: max err / max|a| "
        f"{acc_rel:.3e}")
    check(rho_rel <= 1e-5, "Triton density vs plain, rtol 1e-5")
    check(acc_rel <= 1e-4, "Triton forces vs plain, 1e-4 of max |a|")

    # field pass: frame-reuse render of a layout-fresh state vs brute force
    multi1 = jax.jit(eng.make_multi_step(resort_every=1, return_frame=True))
    g1 = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (1, 2))
    sim1, _, frame = multi1(sim, g1)
    rend = WindowRenderer(eng, 64, 128)
    field, f_ov = jax.jit(rend.field_from_frame)(sim1, frame)
    check(int(f_ov) == 0, "field window overflow 0")
    real1 = sim1.packed[:, 4] > 0
    ref = _brute_field(cfg, sim1.packed[:, 0][real1], sim1.packed[:, 1][real1],
                       64, 128, rend.field_scale)
    agree = float(np.mean((np.asarray(field) >= 1.0) == (np.asarray(ref) >= 1.0)))
    log(f"  field: lit-pixel agreement {agree:.5f}")
    check(agree >= 0.999, "window field vs brute force, >= 99.9% pixels")

    # engine vs the jnp oracle, both here, 100 exact steps
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (100, 2))
    e_sim, e_st = jax.jit(eng.make_multi_step(resort_every=1))(sim, g)
    o_sim = prime(fluid, boundary, bgrid, G, cfg)
    o_sim, _ = jax.jit(make_multi_step(cfg, boundary, bgrid))(o_sim, g)
    check(int(jnp.max(e_st.neighbor_overflow)) == 0, "engine overflow 0")
    e = eng.unpad(e_sim)
    inv = np.argsort(np.asarray(o_sim.ids))
    dpos = max(float(np.max(np.abs(np.asarray(e.x) - np.asarray(o_sim.fluid.x)[inv]))),
               float(np.max(np.abs(np.asarray(e.y) - np.asarray(o_sim.fluid.y)[inv]))))
    log(f"  engine vs oracle after 100 steps: max |dpos| {dpos:.3e} m")
    check(dpos <= 1e-5, "engine vs oracle positions, atol 1e-5 m")


def phase_golden():
    import jax
    import jax.numpy as jnp

    import pi_sph_fluid_tpu as sph
    from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine

    golden = np.load(os.path.join(REPO, "tests", "fixtures",
                                  "golden_drop_3k.npz"))
    cfg = sph.SPHConfig(r=0.0226)
    fluid, braw = sph.build_drop_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    # cap=384 as in tests/test_parity_3k.py: parity needs the window cap
    # clear of this fine-resolution fall's sparse free-surface blocks
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, cap=384)
    sim = eng.prime(fluid, G)
    multi = jax.jit(eng.make_multi_step())
    g100 = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (100, 2))
    gates = {500: (3e-6, 5e-4), 1000: (1e-5, 5e-4), 2000: (5e-5, 2e-3)}
    worst_ov = 0
    for k in range(1, 21):
        sim, st = multi(sim, g100)
        worst_ov = max(worst_ov, int(jnp.max(st.neighbor_overflow)))
        step = k * 100
        if step not in gates:
            continue
        pos_tol, vel_tol = gates[step]
        ours = eng.unpad(sim)
        gs = golden["states"][k]
        assert int(golden["steps"][k]) == step
        dpos = max(float(np.max(np.abs(np.asarray(ours.x) - gs[:, 0]))),
                   float(np.max(np.abs(np.asarray(ours.y) - gs[:, 1]))))
        dvel = max(float(np.max(np.abs(np.asarray(ours.u) - gs[:, 2]))),
                   float(np.max(np.abs(np.asarray(ours.v) - gs[:, 3]))))
        drho = float(np.max(np.abs(np.asarray(ours.rho) - gs[:, 5]) / gs[:, 5]))
        log(f"  step {step}: |dpos| {dpos:.3e} m, |dvel| {dvel:.3e} m/s, "
            f"rho rel {drho:.3e}")
        check(dpos <= pos_tol and dvel <= vel_tol and drho <= 3e-4,
              f"C golden at step {step} (pos {pos_tol}, vel {vel_tol}, "
              f"rho 3e-4)")
    check(worst_ov == 0, "golden run overflow 0")


def phase_toy():
    from pi_sph_fluid_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        warm = os.path.join(tmp, "warm.bin")
        frames = os.path.join(tmp, "frames.bin")
        base = ["run", "--scene", "drop", "--realtime"]
        # a short run first compiles the dispatch into the persistent cache
        cli.main(base + ["--seconds", "0.1", "--display", f"file:{warm}"])
        res = cli.main(base + ["--seconds", "1.0", "--display",
                               f"file:{frames}"])
        size = os.path.getsize(frames)
    n_frames = size // 1024
    ticks = res.steps / res.wall_s
    log(f"  {res.steps} ticks in {res.wall_s:.3f} s: {ticks:.0f} ticks/s "
        f"(reference enforces 4102), {n_frames} frames")
    check(size > 0 and size % 1024 == 0, "frames written")
    check(res.reporter.total_overflow == 0, "neighbor_overflow 0")


def phase_scale():
    import jax

    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.utils.profiling import device_memory

    cfg, fluid, braw, _, _ = _pool(1_000_000)
    steps = 256
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(cap=256), render=True,
                       resort_every=64, auto_cap=False)
    gravity = ConstantGravity(cfg)
    runner.run(gravity, None, sim_seconds=steps * cfg.dt,
               steps_per_dispatch=steps)   # compile + warm
    res = runner.run(gravity, None, sim_seconds=steps * cfg.dt,
                     steps_per_dispatch=steps)
    rep = res.reporter
    pk = np.asarray(res.sim.packed)
    real = pk[:, 4] > 0
    mem = device_memory().get(str(jax.devices()[0]), {})
    log(f"  {fluid.n} particles, {res.steps} steps: "
        f"{res.wall_s / res.steps * 1e3:.3f} ms/step "
        f"({res.particle_steps_per_s:.4g} particle-steps/s, render in loop), "
        f"peak device memory {mem.get('peak_bytes_in_use')} B")
    log(f"  stale_drift {rep.total_stale}, neighbor_overflow "
        f"{rep.total_overflow}, max rho error {rep.worst_rho_error_pct:.3f}%")
    check(rep.total_stale == 0, "stale_drift 0")
    check(rep.total_overflow == 0, "neighbor and render overflow 0")
    check(bool(np.isfinite(pk[real]).all()), "finite state")
    check(rep.worst_rho_error_pct < 2.0, "max rho error < 2%")


def phase_multi():
    """4-GPU WindowDomain vs the single-GPU WindowEngine on the 1M pool.

    Tolerance: positions atol 1e-5 m.  tests/test_parallel_window.py holds
    the dam scene to 1e-6 m after 15 steps; here the trajectories run 128
    steps at 1M, and ghost densities are summed in another order than the
    single-device windows (a ~1 ulp difference that the dynamics amplify),
    so the bound is the oracle comparison's 1e-5 m."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine
    from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain

    devs = jax.devices()
    check(len(devs) >= 4, f"4 GPUs visible ({len(devs)})")
    cfg, fluid, _, boundary, bgrid = _pool(1_000_000)
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n,
                      Mesh(np.asarray(devs[:4]), ("x",)))
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n)
    sim = eng.prime(fluid, G)
    sim = sim._replace(au=sim.au * 0, av=sim.av * 0)  # dd starts at zero acc
    state = dd.init(fluid)
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (64, 2))
    for resort in (1, 64):
        d_multi = jax.jit(dd.make_multi_step(resort_every=resort))
        e_multi = jax.jit(eng.make_multi_step(resort_every=resort))
        state, st = d_multi(state, g)
        sim, _ = e_multi(sim, g)
        jax.block_until_ready((state.fluid.x, sim.packed))
        t0 = time.perf_counter()
        jax.block_until_ready(d_multi(state, g)[0].fluid.x)
        t_dd = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(e_multi(sim, g)[0].packed)
        t_one = time.perf_counter() - t0
        fd, fe = dd.gather(state), eng.unpad(sim)
        dpos = max(float(np.max(np.abs(np.asarray(fd.x) - np.asarray(fe.x)))),
                   float(np.max(np.abs(np.asarray(fd.y) - np.asarray(fe.y)))))
        by = np.asarray(st["overflow_by"]).sum(axis=0)
        stale = int(np.sum(np.asarray(st["stale"]))) if "stale" in st else 0
        log(f"  resort {resort}: 64 steps, max |dpos| {dpos:.3e} m, "
            f"overflow_by [window, halo, mig, slab] = {by.tolist()}, "
            f"stale {stale}; ms/step 4 GPUs {t_dd / 64 * 1e3:.3f}, "
            f"1 GPU {t_one / 64 * 1e3:.3f}")
        check(int(np.max(np.asarray(st["overflow"]))) == 0
              and int(by.sum()) == 0, f"resort {resort}: every overflow 0")
        check(int(np.asarray(st["n_valid"])[-1]) == fluid.n,
              f"resort {resort}: no particle lost")
        check(stale == 0, f"resort {resort}: stale drift 0")
        check(dpos <= 1e-5, f"resort {resort}: 4 GPUs vs 1, atol 1e-5 m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU domain decomposition phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from pi_sph_fluid_tpu.utils.compile_cache import configure_compile_cache
    from pi_sph_fluid_tpu.utils.profiling import (gpu_name_and_power_limit,
                                                  require_gpu)

    import jax

    require_gpu()   # phase 1
    dev = jax.devices()[0]
    log(f"compile cache: {configure_compile_cache()}")
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    phases = ([("multi", phase_multi)] if args.multi else
              [("kernels", phase_kernels), ("golden", phase_golden),
               ("toy", phase_toy), ("scale", phase_scale)])
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}")
        fn()
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(f"nvidia-smi: {gpu_name_and_power_limit()}")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
