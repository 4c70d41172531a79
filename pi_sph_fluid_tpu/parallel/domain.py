"""Multi-chip WCSPH: slab domain decomposition over a device mesh.

The reference's only parallelism is 4 OpenMP threads in one address space
(`pi_sph_fluid.c:610`, SURVEY.md §2 #18).  The accelerator scale-out equivalent
(SURVEY.md §5) is **spatial domain decomposition**: the x-axis is cut into D
slabs, one per device; each device owns the particles inside its slab in
fixed-capacity arrays, and per step exchanges with its two neighbors
via `jax.lax.ppermute` inside `shard_map`:

* **migration** — particles that drifted across a slab edge move to the
  neighbor (payload: x, y, u, v, m, id; accelerations are recomputed),
* **halo exchange** — particles within 2H of a slab edge are copied to the
  neighbor as read-only *ghosts*, once before the density pass (positions)
  and again before the force pass (so ghosts carry fresh rho/p).

Everything is shape-static: slab/migration/halo buffers have fixed
capacities with overflow *counted* (never silent), and slot validity is
encoded as m > 0 — which makes ppermute's zero-filled edge buffers and
padded lanes naturally inert in every pair sum (mass multiplies every
contribution).

The pair passes are the jnp oracle passes (ops/density.py, ops/forces.py),
which makes this path runnable and testable on a virtual CPU mesh —
fusing the Pallas kernels into the sharded path is a planned next step.
"""

from __future__ import annotations


from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import SPHConfig
from ..state import BoundaryState, FluidState
from ..core.eos import tait_pressure
from ..ops.density import density_pass
from ..ops.forces import acceleration_pass
from ..ops.grid import GridContext, cell_ids
from ..ops.neighbors import gather_candidates, span_overflow

__all__ = ["DomainState", "DomainDecomposition"]

INERT_X = -1e6


class DomainState(NamedTuple):
    """Sharded simulation state: every array is (D * slab_cap,) partitioned
    over the mesh axis; slot validity is m > 0."""

    fluid: FluidState
    ids: jnp.ndarray
    au: jnp.ndarray
    av: jnp.ndarray


def _masked_grid(x, y, valid, cfg: SPHConfig) -> GridContext:
    """build_grid with invalid slots forced to the out-of-range key, so they
    sort last and join no cell span."""
    keys = jnp.where(valid, cell_ids(x, y, cfg), cfg.n_cells)
    order = jnp.argsort(keys, stable=True).astype(jnp.int32)
    sorted_cells = keys[order]
    counts = jnp.zeros(cfg.n_cells + 2, jnp.int32).at[keys + 1].add(1)
    cell_starts = jnp.cumsum(counts, dtype=jnp.int32)
    return GridContext(order=order, sorted_cells=sorted_cells, cell_starts=cell_starts)


def _take_first(mask, arrays, cap):
    """Stable-pack slots where ``mask`` holds into the first ``cap`` lanes.
    Returns (packed arrays, lane validity, overflow count).

    Same-dtype arrays are stacked and gathered as rows: one row gather
    instead of one 1-D element gather per array, several times per sharded
    step.
    """
    order = jnp.argsort(~mask, stable=True).astype(jnp.int32)
    n = mask.shape[0]
    if cap > n:
        # callers size receive buffers statically by ``cap``; a source
        # array shorter than that must PAD to cap, not silently clamp at
        # the python slice (order[:cap] of a shorter array) — that shape
        # drift broke halo exchanges whenever halo_cap > slab_cap
        idx = jnp.concatenate([order, jnp.zeros((cap - n,), jnp.int32)])
        lane_valid = jnp.concatenate(
            [mask[order], jnp.zeros((cap - n,), bool)])
    else:
        idx = order[:cap]
        lane_valid = mask[idx]
    f32 = [i for i, a in enumerate(arrays) if a.dtype == jnp.float32]
    packed = list(arrays)
    if len(f32) > 1:
        stacked = jnp.stack([arrays[i] for i in f32], axis=1)[idx]
        for col, i in enumerate(f32):
            packed[i] = jnp.where(lane_valid, stacked[:, col], 0)
    else:
        for i in f32:
            packed[i] = jnp.where(lane_valid, arrays[i][idx], 0)
    for i, a in enumerate(arrays):
        if i not in f32:
            packed[i] = jnp.where(lane_valid, a[idx], 0)
    overflow = jnp.maximum(jnp.sum(mask) - cap, 0)
    return packed, lane_valid, overflow


def _perm_lists(d: int, direction: int):
    if direction > 0:
        return [(i, i + 1) for i in range(d - 1)]
    return [(i, i - 1) for i in range(1, d)]


def _exchange_impl(axis: str, d: int, mask_l, mask_r, arrays, cap):
    """Pack boundary-crossing/halo slots and ppermute both directions.
    Returns (received from left neighbor, from right neighbor, overflow).

    Direction bookkeeping: my LEFT-bound buffer must land on device my-1,
    i.e. ride perm [(i, i-1)] — and what I *receive* through that
    permutation is my RIGHT neighbor's left-bound buffer."""
    left, _, ov_l = _take_first(mask_l, arrays, cap)
    right, _, ov_r = _take_first(mask_r, arrays, cap)
    # ppermute fills devices with no source with zeros -> m=0 -> inert
    from_right = [jax.lax.ppermute(a, axis, _perm_lists(d, -1)) for a in left]
    from_left = [jax.lax.ppermute(a, axis, _perm_lists(d, +1)) for a in right]
    return from_left, from_right, ov_l + ov_r


def _inert(fluid: FluidState, valid) -> FluidState:
    """Force invalid slots to the inert pattern (m=0, far away, at rest)."""
    return FluidState(
        x=jnp.where(valid, fluid.x, INERT_X),
        y=jnp.where(valid, fluid.y, INERT_X),
        u=jnp.where(valid, fluid.u, 0.0),
        v=jnp.where(valid, fluid.v, 0.0),
        m=jnp.where(valid, fluid.m, 0.0),
        rho=jnp.where(valid, fluid.rho, 0.0),
        p=jnp.where(valid, fluid.p, 0.0),
    )


class DomainDecomposition:
    def __init__(
        self,
        cfg: SPHConfig,
        boundary: BoundaryState,
        boundary_grid: GridContext,
        n_global: int,
        mesh: Mesh,
        axis: str = "x",
        slab_cap: int | None = None,
        mig_cap: int | None = None,
        halo_cap: int | None = None,
    ):
        self.cfg = cfg
        self.boundary = boundary
        self.b_grid = boundary_grid
        self.mesh = mesh
        self.axis = axis
        self.n_devices = mesh.shape[axis]
        d = self.n_devices
        self.slab_w = cfg.width / d
        # Capacities are *physical area* bounds, not averages: a dam break
        # starts with every particle in the leftmost slabs, and fluid
        # settles into the bottom of whichever slab it ends up in.  A slab
        # can hold at most its area / R^2 (rest spacing) x compression
        # slack; same logic for the 2H halo strip.  Per-step migration is
        # bounded by the max-displacement strip v_max*dt = H/10 (C/10 speed
        # bound x H/C step, `pi_sph_fluid.c:16,19`), padded generously.
        def area_cap(strip_w: float, slack: float = 1.35) -> int:
            return int(strip_w * cfg.height / (cfg.r * cfg.r) * slack) + 1

        self.slab_cap = slab_cap or _round_up(
            min(area_cap(self.slab_w), n_global) + 64, 128)
        self.halo_cap = halo_cap or _round_up(
            min(area_cap(2 * cfg.h), n_global) + 64, 64)
        self.mig_cap = mig_cap or _round_up(
            min(area_cap(cfg.h), n_global) + 64, 64)

    # ------------------------------------------------------------------
    def init(self, fluid: FluidState) -> DomainState:
        """Distribute a global FluidState into sharded slab arrays."""
        d, cap = self.n_devices, self.slab_cap
        x = np.asarray(fluid.x)
        dest = np.clip((x / self.slab_w).astype(np.int64), 0, d - 1)
        out = {f: np.zeros((d, cap), np.float32) for f in FluidState._fields}
        out["x"][:] = INERT_X
        out["y"][:] = INERT_X
        ids = np.full((d, cap), -1, np.int32)
        for dev in range(d):
            sel = np.nonzero(dest == dev)[0]
            if len(sel) > cap:
                raise ValueError(f"slab {dev} over capacity: {len(sel)} > {cap}")
            for f in FluidState._fields:
                out[f][dev, : len(sel)] = np.asarray(getattr(fluid, f))[sel]
            ids[dev, : len(sel)] = sel
        sharding = NamedSharding(self.mesh, P(self.axis))
        state = FluidState(**{
            f: jax.device_put(out[f].reshape(-1), sharding) for f in FluidState._fields
        })
        zeros = jax.device_put(np.zeros(d * cap, np.float32), sharding)
        return DomainState(
            fluid=state,
            ids=jax.device_put(ids.reshape(-1), sharding),
            au=zeros, av=zeros,
        )

    # ------------------------------------------------------------------
    def _exchange(self, mask_l, mask_r, arrays, cap):
        return _exchange_impl(self.axis, self.n_devices, mask_l, mask_r,
                              arrays, cap)

    def _halo_masks(self, fluid, valid, my):
        x_lo = my.astype(jnp.float32) * self.slab_w
        x_hi = x_lo + self.slab_w
        strip = jnp.float32(self.cfg.support_radius)
        return (valid & (fluid.x < x_lo + strip),
                valid & (fluid.x > x_hi - strip))

    def _combined_pass(self, fluid, ids, valid, my, pass_fn):
        """halo-exchange -> merge ghosts -> cell sort -> pair pass.
        ids and the owner mask ride the same permutation as the fields so
        identity survives the sort.  Returns (combined fluid sorted,
        combined ids, owner mask, pass result, overflow)."""
        cfg = self.cfg
        halo_l, halo_r = self._halo_masks(fluid, valid, my)
        fields = list(fluid)
        from_left, from_right, ov = self._exchange(halo_l, halo_r, fields, self.halo_cap)
        ghosts = [jnp.concatenate([a, b]) for a, b in zip(from_left, from_right)]
        comb = FluidState(*(jnp.concatenate([f, g]) for f, g in zip(fields, ghosts)))
        comb_ids = jnp.concatenate([ids, jnp.full(2 * self.halo_cap, -1, jnp.int32)])
        owner = jnp.concatenate([
            jnp.ones(self.slab_cap, bool), jnp.zeros(2 * self.halo_cap, bool)
        ])
        comb_valid = comb.m > 0
        grid = _masked_grid(comb.x, comb.y, comb_valid, cfg)
        comb = comb.permute(grid.order)
        comb_ids = comb_ids[grid.order]
        owner = owner[grid.order]
        cand_ff = gather_candidates(comb.x, comb.y, grid, cfg)
        cand_fb = gather_candidates(comb.x, comb.y, self.b_grid, cfg)
        ov = ov + span_overflow(comb.x, comb.y, grid, cfg) \
            + span_overflow(comb.x, comb.y, self.b_grid, cfg)
        result = pass_fn(comb, cand_ff, cand_fb)
        return comb, comb_ids, owner, result, ov

    def _drop_ghosts(self, comb: FluidState, comb_ids, owner, extras=()):
        """Keep owned valid slots (stable pack -> still cell-sorted within
        the slab), padding back to slab_cap.  Returns (fluid, ids,
        packed extras, lane validity)."""
        arrays = list(comb) + [comb_ids] + list(extras)
        packed, lane_valid, _ = _take_first(owner & (comb.m > 0), arrays, self.slab_cap)
        fluid = _inert(FluidState(*packed[:7]), lane_valid)
        ids = jnp.where(lane_valid, packed[7], -1)
        extras_out = [jnp.where(lane_valid, e, 0.0) for e in packed[8:]]
        return fluid, ids, extras_out, lane_valid

    # ------------------------------------------------------------------
    def make_step(self):
        """Build the sharded step: (DomainState, g) -> (DomainState, stats).

        Call under jit; internally shard_map over the mesh.
        """
        cfg = self.cfg
        dt = jnp.float32(cfg.dt)
        half = jnp.float32(0.5) * dt
        d = self.n_devices

        def local_step(fluid_flat, ids, au, av, g):
            fluid = FluidState(*fluid_flat)
            my = jax.lax.axis_index(self.axis)
            valid = fluid.m > 0

            # kick + drift (`pi_sph_fluid.c:614-624`)
            u = fluid.u + half * au
            v = fluid.v + half * av
            fluid = fluid._replace(
                x=jnp.where(valid, fluid.x + dt * u, fluid.x),
                y=jnp.where(valid, fluid.y + dt * v, fluid.y),
                u=jnp.where(valid, u, 0.0), v=jnp.where(valid, v, 0.0),
            )

            # migration: move slab-crossers to the neighbor
            dest = jnp.clip((fluid.x / jnp.float32(self.slab_w)).astype(jnp.int32), 0, d - 1)
            go_l = valid & (dest < my)
            go_r = valid & (dest > my)
            stay = valid & ~(go_l | go_r)
            # ids travel as int32 through pack + ppermute (index ops and
            # collectives are exact at any particle count; a float32 round
            # trip would corrupt ids above 2^24)
            payload = list(fluid) + [ids]
            from_left, from_right, ov_mig = self._exchange(go_l, go_r, payload, self.mig_cap)
            fluid = _inert(fluid, stay)
            ids = jnp.where(stay, ids, -1)
            merged = [
                jnp.concatenate([f, a, b])
                for f, a, b in zip(list(fluid) + [ids], from_left, from_right)
            ]
            merged_valid = merged[4] > 0  # m field
            packed, lane_valid, ov_cap = _take_first(merged_valid, merged, self.slab_cap)
            fluid = _inert(FluidState(*packed[:7]), lane_valid)
            ids = jnp.where(lane_valid, packed[7], -1)
            valid = lane_valid

            # phase 1: density + EOS on local + position ghosts
            def density_fn(comb, cand_ff, cand_fb):
                rho = density_pass(comb, self.boundary, cand_ff, cand_fb, cfg)
                return rho, tait_pressure(rho, cfg)

            comb, comb_ids, owner, (rho, p), ov_d = self._combined_pass(
                fluid, ids, valid, my, density_fn)
            comb = comb._replace(rho=rho, p=p)
            fluid, ids, _, valid = self._drop_ghosts(comb, comb_ids, owner)

            # phase 2: forces on local + rho/p ghosts
            def force_fn(comb2, cand_ff, cand_fb):
                # guard pad slots (rho = 0) against 0/0 in the pressure term
                safe = comb2._replace(rho=jnp.where(comb2.rho > 0, comb2.rho, 1.0))
                return acceleration_pass(safe, self.boundary, cand_ff, cand_fb,
                                         g[0], g[1], cfg)

            comb2, comb_ids2, owner2, (au2, av2), ov_f = self._combined_pass(
                fluid, ids, valid, my, force_fn)
            fluid, ids, (au, av), valid = self._drop_ghosts(
                comb2, comb_ids2, owner2, (au2, av2))

            # kick with new accelerations
            fluid = fluid._replace(
                u=jnp.where(valid, fluid.u + half * au, 0.0),
                v=jnp.where(valid, fluid.v + half * av, 0.0),
            )

            overflow = (ov_mig + ov_cap + ov_d + ov_f).astype(jnp.int32)
            rho0 = jnp.float32(cfg.rho_0)
            rho_err = jnp.max(jnp.where(valid, fluid.rho - rho0, -rho0))
            speed2 = jnp.max(jnp.where(valid, fluid.u**2 + fluid.v**2, 0.0))
            stats = (
                jax.lax.pmax(jnp.maximum(rho_err, 0.0) / rho0 * 100.0, self.axis),
                jnp.sqrt(jax.lax.pmax(speed2, self.axis)),
                jax.lax.psum(overflow, self.axis),
                jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), self.axis),
            )
            return tuple(fluid), ids, au, av, stats

        spec = P(self.axis)
        sharded = shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(tuple([spec] * 7), spec, spec, spec, P()),
            out_specs=(tuple([spec] * 7), spec, spec, spec,
                       (P(), P(), P(), P())),
        )

        def step(state: DomainState, g):
            fluid_t, ids, au, av, stats = sharded(
                tuple(state.fluid), state.ids, state.au, state.av,
                jnp.asarray(g, jnp.float32),
            )
            new = DomainState(fluid=FluidState(*fluid_t), ids=ids, au=au, av=av)
            return new, {
                "max_rho_error_pct": stats[0],
                "max_speed": stats[1],
                "overflow": stats[2],
                "n_valid": stats[3],
            }

        return step

    # ------------------------------------------------------------------
    def gather(self, state: DomainState) -> FluidState:
        """Collect the global fluid state in original id order (host-side)."""
        ids = np.asarray(state.ids)
        sel = ids >= 0
        order = np.argsort(ids[sel])
        return FluidState(*(
            jnp.asarray(np.asarray(f)[sel][order]) for f in state.fluid
        ))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m
