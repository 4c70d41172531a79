"""The WCSPH time stepper: leapfrog KDK, entirely inside XLA.

Mirrors the reference main loop (`pi_sph_fluid.c:610-644`):

    kick(DT/2, old accel) -> drift(DT) -> rebuild grid ->
    density -> EOS -> accelerations -> kick(DT/2, new accel)

with the priming pass (`pi_sph_fluid.c:604-607`) computing the step-0
accelerations.  Differences by design (SURVEY.md §7):

* the grid rebuild is a counting sort and the whole fluid state is kept in
  grid-sorted order (``ids`` tracks original identity for parity tests);
* one tick is one XLA computation; ``multi_step`` scans K ticks per host
  dispatch so the device never round-trips to the host per step
  (the accelerator analog of running free with REALTIME off);
* per-step stats (max density error, max speed — `pi_sph_fluid.c:656-675`)
  are on-device reductions returned with the state.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SPHConfig
from ..state import BoundaryState, FluidState
from ..ops.density import density_pass
from ..ops.forces import acceleration_pass
from ..ops.grid import GridContext, build_grid
from ..ops.neighbors import gather_candidates, span_overflow
from ..core.eos import tait_pressure

__all__ = ["SimState", "StepStats", "prime", "make_step", "make_multi_step", "stats"]


class SimState(NamedTuple):
    fluid: FluidState     # grid-sorted
    ids: jnp.ndarray      # (N,) int32, original particle id of each slot
    au: jnp.ndarray       # (N,) accelerations from the previous force pass
    av: jnp.ndarray


# Index order of StepStats.overflow_by — the single source for every
# consumer (domain_window stacks the counters in this order; host_loop's
# targeted recovery and the CLI's summary name categories by it).
OVERFLOW_CATEGORIES = ("window", "halo", "mig", "slab")


class StepStats(NamedTuple):
    """On-device per-tick invariants (`pi_sph_fluid.c:656-675`), with the
    reference's max-rho comparison bug fixed (SURVEY.md §2 #16: intent is the
    true max density error)."""

    max_rho_error_pct: jnp.ndarray
    max_speed: jnp.ndarray
    neighbor_overflow: jnp.ndarray  # candidates dropped by fixed capacity
    # Per-capacity attribution in OVERFLOW_CATEGORIES order, dd backend
    # only (None elsewhere): lets elastic recovery grow exactly the starved
    # buffer instead of every capacity at once.  The aggregate counter above
    # stays authoritative (it also carries the non-finite/lost screams).
    overflow_by: jnp.ndarray | None = None
    # Sticky-layout staleness guard (sticky modes only, None elsewhere):
    # count of real particles whose displacement since the group's layout
    # was built exceeds 0.3*H — the per-particle drift the k<=4-at-C/10
    # fringe analysis permits (a layout stale by k-1 ticks misses pairs
    # only in the outer 0.2*(k-1)*H support shell; at the design bound
    # `pi_sph_fluid.c:16` each particle moves <= 0.1*H/tick, so k=4 tops
    # out at 0.3*H).  While this reads 0, ANY resort_every runs within the
    # certified k<=4 envelope; nonzero means pairs may be missed beyond
    # the argued fringe and the runner downgrades resort_every (counted,
    # never silent — like every other loss channel).
    stale: jnp.ndarray | None = None


def _sort_and_neighbors(fluid: FluidState, ids, boundary_grid: GridContext, cfg: SPHConfig):
    grid = build_grid(fluid.x, fluid.y, cfg)
    fluid = fluid.permute(grid.order)
    ids = ids[grid.order]
    cand_ff = gather_candidates(fluid.x, fluid.y, grid, cfg)
    cand_fb = gather_candidates(fluid.x, fluid.y, boundary_grid, cfg)
    overflow = span_overflow(fluid.x, fluid.y, grid, cfg) + span_overflow(
        fluid.x, fluid.y, boundary_grid, cfg
    )
    return fluid, ids, cand_ff, cand_fb, overflow


def _forces(fluid: FluidState, boundary: BoundaryState, cand_ff, cand_fb, g, cfg: SPHConfig):
    rho = density_pass(fluid, boundary, cand_ff, cand_fb, cfg)
    p = tait_pressure(rho, cfg)
    fluid = fluid._replace(rho=rho, p=p)
    au, av = acceleration_pass(fluid, boundary, cand_ff, cand_fb, g[0], g[1], cfg)
    return fluid, au, av


def prime(fluid: FluidState, boundary: BoundaryState, boundary_grid: GridContext,
          g, cfg: SPHConfig) -> SimState:
    """Step-0 initialisation (`pi_sph_fluid.c:604-607`): sort, density, EOS,
    accelerations — no integration."""
    ids = jnp.arange(fluid.n, dtype=jnp.int32)
    fluid, ids, cand_ff, cand_fb, _ = _sort_and_neighbors(fluid, ids, boundary_grid, cfg)
    fluid, au, av = _forces(fluid, boundary, cand_ff, cand_fb, jnp.asarray(g, jnp.float32), cfg)
    return SimState(fluid=fluid, ids=ids, au=au, av=av)


def make_step(cfg: SPHConfig, boundary: BoundaryState, boundary_grid: GridContext,
              damping: float = 1.0):
    """Build the single-tick function ``step(sim, g) -> (sim, StepStats)``.

    ``boundary``/``boundary_grid`` are static captures: immutable after scene
    build, exactly like the reference (`pi_sph_fluid.c:599-601`).
    ``damping`` < 1 scales velocities per step (settling runs; see
    engine_v3.make_step).
    """
    dt = jnp.float32(cfg.dt)
    half_dt = jnp.float32(0.5) * dt
    damp = jnp.float32(damping)

    def step(sim: SimState, g) -> tuple[SimState, StepStats]:
        g = jnp.asarray(g, jnp.float32)
        f = sim.fluid
        # kick (old accelerations) + drift (`pi_sph_fluid.c:614-624`)
        u = f.u + half_dt * sim.au
        v = f.v + half_dt * sim.av
        x = f.x + dt * u
        y = f.y + dt * v
        f = f._replace(x=x, y=y, u=u, v=v)

        f, ids, cand_ff, cand_fb, overflow = _sort_and_neighbors(f, sim.ids, boundary_grid, cfg)
        f, au, av = _forces(f, boundary, cand_ff, cand_fb, g, cfg)

        # kick (new accelerations) (`pi_sph_fluid.c:637-640`)
        f = f._replace(u=(f.u + half_dt * au) * damp, v=(f.v + half_dt * av) * damp)

        new_sim = SimState(fluid=f, ids=ids, au=au, av=av)
        return new_sim, stats(new_sim, cfg, overflow)

    return step


def make_multi_step(cfg: SPHConfig, boundary: BoundaryState, boundary_grid: GridContext,
                    damping: float = 1.0):
    """Build ``multi_step(sim, g_trace) -> (sim, StepStats[K])``: K ticks per
    host dispatch via lax.scan.  ``g_trace`` has shape (K, 2) — a constant
    gravity is broadcast by the caller; a replayed accelerometer trace slots
    straight in (SURVEY.md §2 #14)."""
    step = make_step(cfg, boundary, boundary_grid, damping)

    def multi_step(sim: SimState, g_trace):
        return jax.lax.scan(step, sim, jnp.asarray(g_trace, jnp.float32))

    return multi_step


def stats(sim: SimState, cfg: SPHConfig, overflow=None) -> StepStats:
    """On-device invariant reductions (`pi_sph_fluid.c:656-675`).

    Non-finite state rows are folded into the overflow scream (x1e6, like
    capacity-lost rows): a max reduction need not propagate NaN operands,
    so a NaN'd state could otherwise print healthy-looking max stats."""
    rho0 = jnp.float32(cfg.rho_0)
    max_rho_error = jnp.max(sim.fluid.rho - rho0)
    speed2 = sim.fluid.u * sim.fluid.u + sim.fluid.v * sim.fluid.v
    probe = sim.fluid.x + speed2 + sim.fluid.rho   # NaN/inf propagates
    bad = jnp.sum((~jnp.isfinite(probe)).astype(jnp.int32))
    ov = jnp.asarray(0, jnp.int32) if overflow is None else overflow
    return StepStats(
        max_rho_error_pct=jnp.maximum(max_rho_error, 0.0) / rho0 * 100.0,
        max_speed=jnp.sqrt(jnp.max(speed2)),
        neighbor_overflow=ov + jnp.minimum(bad, 1000) * jnp.int32(1_000_000),
    )
