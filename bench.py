#!/usr/bin/env python3
"""Benchmark: WCSPH particle-steps/second on one GPU.

Runs the **pool scene** (settled steady state — the layout's sizing case;
the dam-break differs only in initial shape) through the window engine,
free-running (REALTIME off, `pi_sph_fluid.c:10`), whole steps resident in
XLA via lax.scan.  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {...}, ...}

``value`` is the sticky-layout throughput at resort_every=64, the resort
ladder's ceiling (SimRunner raises 8 -> 64 on clean intervals and halves +
pins the ceiling on a trip); every carried tick counts particles drifting
past the 0.3*H fringe margin (StepStats.stale) and ``stale_drift`` must
read 0.  ``exact_ps_per_s`` is the resort-every-step number.
``neighbor_overflow`` must read 0: window caps are sized so the run loses
no pairs.  ``m1`` is the 1M-particle operating point (the north-star
scene, BASELINE.md); ``dd`` and ``dd_strong`` are 1-slab WindowDomain runs
at the per-slab loads of a 4M and a 1M decomposition.

vs_baseline is against the reference's implied real-time throughput on a
Raspberry Pi 4: 431 particles x 4102 enforced ticks/s ~= 1.77e6
particle-steps/s (BASELINE.md).  ``smallN_ticks_per_s`` measures the
reference's own operating point — the 269-particle drop scene
(`pi_sph_fluid.c:484-543`) — against its enforced 4102 ticks/s.

Every result names the device it ran on; without a GPU the script exits
nonzero instead of measuring anything else.
"""

import json
import math
import time

import jax
import jax.numpy as jnp

import pi_sph_fluid_tpu as sph

BASELINE_PS = 431 * 4102   # reference implied particle-steps/s (BASELINE.md)
REALTIME_TICKS = 4102      # reference enforced tick rate (pi_sph_fluid.c:694-701)


def _run(multi, sim, g_trace):
    sim2, st = multi(sim, g_trace)  # compile + warm
    jax.block_until_ready(sim2.packed if hasattr(sim2, "packed") else sim2.fluid.x)
    t0 = time.perf_counter()
    sim2, st = multi(sim, g_trace)
    jax.block_until_ready(sim2.packed if hasattr(sim2, "packed") else sim2.fluid.x)
    return time.perf_counter() - t0, st


def bench_window(target_n: int, steps: int) -> dict:
    from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine

    r = math.sqrt(6.35 / target_n)
    cfg = sph.SPHConfig(r=r)
    fluid, braw = sph.build_pool_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n)
    sim = eng.prime(fluid, (0.0, -9.81))
    g = jnp.broadcast_to(jnp.asarray((0.0, -9.81), jnp.float32), (steps, 2))

    # the sticky headline run ALSO yields the relayout frame for the
    # renderer measurement (return_frame shares one compiled executable);
    # resort=64 guarded (the runtime ladder's ceiling) — stale_drift
    # certifies the pool never left the 0.3*H drift envelope (docstring)
    multi8 = jax.jit(eng.make_multi_step(resort_every=64, return_frame=True))
    sim4, st4, frame = multi8(sim, g)          # compile + warm
    jax.block_until_ready(sim4.packed)
    # median-of-3 dispatches with min/max: run-to-run spread must be
    # visible in the number, not hidden behind a single timing
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sim4, st4, frame = multi8(sim, g)
        jax.block_until_ready(sim4.packed)
        walls.append(time.perf_counter() - t0)
    wall4 = sorted(walls)[1]
    wall1, st1 = _run(jax.jit(eng.make_multi_step(resort_every=1)), sim, g)

    # render-in-loop cost: one 64x128 frame from the engine's reused
    # candidate structure (render/metaballs_window.render_from_frame);
    # the 60 Hz budget is 16.7 ms
    from pi_sph_fluid_tpu.render.metaballs_window import WindowRenderer

    rend = WindowRenderer(eng, 64, 128)
    reuse = jax.jit(rend.render_from_frame)
    jax.block_until_ready(reuse(sim4, frame))
    t0 = time.perf_counter()
    for _ in range(10):
        fb, f_ov = reuse(sim4, frame)
    jax.block_until_ready(fb)
    frame_ms = (time.perf_counter() - t0) / 10 * 1e3

    # the reference's own operating point: 269-particle drop, ticks/s vs the
    # enforced 4102 (`pi_sph_fluid.c:694-701`); one K-step dispatch per
    # display frame satisfies real-time by construction when ticks/s >= 4102
    cfg_s = sph.SPHConfig()
    fluid_s, braw_s = sph.build_drop_scene(cfg_s)
    boundary_s, bgrid_s = sph.prepare_boundary(braw_s, cfg_s)
    eng_s = WindowEngine(cfg_s, boundary_s, bgrid_s, fluid_s.n,
                         qb=8, cap=256, seg_q=2)
    sim_s = eng_s.prime(fluid_s, (0.0, -9.81))
    steps_s = 4096
    g_s = jnp.broadcast_to(jnp.asarray((0.0, -9.81), jnp.float32), (steps_s, 2))
    wall_s, _ = _run(jax.jit(eng_s.make_multi_step(resort_every=4)), sim_s, g_s)

    # the 1M operating point: the north-star scene (1M @ 60 steps/s would
    # be 6e7... the target is ps/s; steps/s shows the 60 Hz distance)
    m1 = bench_1m()

    # the scale-out backend at its per-slab design load
    dd = bench_dd()

    # per-slab loads of a 4- and an 8-way decomposition of the 1M pool
    dd_strong = bench_dd_strong()

    return {
        "n_fluid": fluid.n,
        "steps": steps,
        "wall_s": wall4,
        "ps_per_s": fluid.n * steps / wall4,
        "ps_per_s_min": fluid.n * steps / max(walls),
        "ps_per_s_max": fluid.n * steps / min(walls),
        "exact_ps_per_s": fluid.n * steps / wall1,
        "resort_every": 64,
        "stale_drift": int(jnp.sum(st4.stale)),
        "scene": "pool",
        "max_rho_error_pct": float(jnp.max(st4.max_rho_error_pct)),
        "neighbor_overflow": int(jnp.max(st4.neighbor_overflow)),
        "frame_ms": frame_ms,
        "render_overflow": int(f_ov),
        "m1": m1,
        "dd": dd,
        "dd_strong": dd_strong,
        "smallN_ticks_per_s": steps_s / wall_s,
        "smallN_vs_realtime": (steps_s / wall_s) / REALTIME_TICKS,
        "backend": "window-v3",
    }


def bench_1m(steps: int = 64) -> dict:
    """The 1M-particle north-star operating point (BASELINE.md: 1M @ 60+
    steps/s on one chip), guarded at the ladder-ceiling resort=64."""
    from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine

    r = math.sqrt(6.35 / 1_000_000)
    cfg = sph.SPHConfig(r=r)
    fluid, braw = sph.build_pool_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n)
    sim = eng.prime(fluid, (0.0, -9.81))
    g = jnp.broadcast_to(jnp.asarray((0.0, -9.81), jnp.float32), (steps, 2))
    wall, st = _run(jax.jit(eng.make_multi_step(resort_every=64)), sim, g)
    return {
        "n_fluid": fluid.n,
        "ps_per_s": fluid.n * steps / wall,
        "steps_per_s": steps / wall,
        "ms_per_step": wall / steps * 1e3,
        "stale_drift": int(jnp.sum(st.stale)),
        "neighbor_overflow": int(jnp.max(st.neighbor_overflow)),
    }


def bench_dd(per_slab_n: int = 500_000, steps: int = 384,
             resort_every: int = 64) -> dict:
    """The domain-decomposition backend at a per-slab load (500k/slab is
    a 4M pool over 8 slabs): a 1-slab WindowDomain carrying the full DD
    machinery — sticky-group migration, halo ppermutes (self-edges on one
    device), per-capacity overflow attribution.  ``stale_drift`` must read
    0 for the sticky period to hold its fringe bound."""
    import numpy as np
    from jax.sharding import Mesh

    from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain

    r = math.sqrt(6.35 / per_slab_n)
    cfg = sph.SPHConfig(r=r)
    fluid, braw = sph.build_pool_scene(cfg)
    boundary, bgrid = sph.prepare_boundary(braw, cfg)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, mesh)
    state = dd.init(fluid)
    multi = jax.jit(dd.make_multi_step(resort_every=resort_every))
    g = jnp.broadcast_to(jnp.asarray((0.0, -9.81), jnp.float32), (steps, 2))
    state2, st = multi(state, g)               # compile + warm
    jax.block_until_ready(state2.fluid.x)
    t0 = time.perf_counter()
    state2, st = multi(state, g)
    jax.block_until_ready(state2.fluid.x)
    wall = time.perf_counter() - t0
    return {
        "slabs_measured": 1,
        "n_fluid_per_slab": fluid.n,
        "ps_per_s_per_slab": fluid.n * steps / wall,
        "ms_per_step": wall / steps * 1e3,
        "resort_every": resort_every,
        "overflow": int(np.max(np.asarray(st["overflow"]))),
        "stale_drift": int(np.sum(np.asarray(st["stale"]))),
    }


def bench_dd_strong() -> dict:
    """1-slab WindowDomain runs at the per-slab loads that a 4-slab
    (250k/slab) and an 8-slab (125k/slab) decomposition of the 1M pool
    would carry.  Reference: the real-time loop `pi_sph_fluid.c:694-701`."""
    points = {}
    for slabs, per_slab in ((4, 250_000), (8, 125_000)):
        d = bench_dd(per_slab_n=per_slab, steps=384)
        d["slabs_for_1m"] = slabs
        points[f"slab_{per_slab // 1000}k"] = d
    return points


def main():
    from pi_sph_fluid_tpu.utils.compile_cache import configure_compile_cache
    from pi_sph_fluid_tpu.utils.profiling import device_summary, require_gpu

    require_gpu()
    configure_compile_cache()
    # 384 = 6 sticky groups at the ladder-ceiling resort=64
    result = bench_window(target_n=100_000, steps=384)
    out = {
        "metric": "particle_steps_per_s",
        "value": result["ps_per_s"],
        "unit": "particle-steps/s",
        "vs_baseline": result["ps_per_s"] / BASELINE_PS,
        "device": device_summary(),
        **{k: v for k, v in result.items() if k != "ps_per_s"},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
