"""Window-kernel simulation engine — the production GPU path.

Same physics and integration order as models/simulation.py (the jnp oracle),
built around per-query-block candidate windows:

* pair passes are the per-query-block window kernels over the row-triple
  merged candidate layout (ops/pallas/triple.py) — computed pair lanes
  track the true 3x3-cell stencil of each block;
* the relayout uses one pair-sort that yields sorted keys AND order with no
  key gather, per-particle cell constants ride one row gather of a per-cell
  table, and particle ids travel inside the packed array (float-valued
  column 7) so they relayout for free;
* p/rho^2 is computed once per particle (density-pass epilogue) instead of
  once per pair lane;
* fluid and boundary candidates share lanes (one window per query block) —
  the reference's separate fluid/boundary loops (`pi_sph_fluid.c:311-366`)
  become per-candidate constants.

State layout: (n_layout, 8) float32 [x, y, u, v, m, rho, p, id(as float)],
row-padded (pads: m = 0, x = -1e6).  ``multi_step`` scans K ticks per
dispatch; ``resort_every`` > 1 reuses the layout/windows across a group of
ticks (sticky layout — see make_multi_step).

Observability: StepStats.neighbor_overflow = window-cap losses plus
(weighted x1e6) row-capacity losses — both must read 0 in a healthy run.
"""

from __future__ import annotations

import numpy as np
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SPHConfig
from ..state import BoundaryState, FluidState
from ..ops.grid import GridContext, cell_ids
from ..ops.pallas.triple import (INERT_X, TripleCtx, TripleSpec,
                                 block_windows, build_frame, triple_spec)
from ..ops.pallas.window_kernels import density_window_call, forces_window_call
from .simulation import StepStats

__all__ = ["WindowEngine", "TripleSpec", "PackedSim"]

# ids travel in packed column 7 as float32 *values* (exact below 2^24 ~ 16.7M
# particles, asserted at engine build).  NOT as int32 bitcasts: ids < 2^23
# bitcast to denormal floats, which a compute unit that flushes denormals to
# zero would collapse.
_INERT_ROW = np.asarray([INERT_X, INERT_X, 0, 0, 0, 0, 0, -1.0], np.float32)


class PackedSim(NamedTuple):
    """Simulation state in packed layout space."""

    packed: jnp.ndarray   # (n_layout, 8): x, y, u, v, m, rho, p, pad
    ids: jnp.ndarray      # (n_layout,) int32, -1 on pad slots
    au: jnp.ndarray       # (n_layout,)
    av: jnp.ndarray

    @property
    def fluid(self) -> FluidState:
        """FluidState view (column slices; cheap inside jit)."""
        p = self.packed
        return FluidState(x=p[:, 0], y=p[:, 1], u=p[:, 2], v=p[:, 3],
                          m=p[:, 4], rho=p[:, 5], p=p[:, 6])


class WindowEngine:
    """Owns the static scene (boundary, capacities) and builds jittable
    prime/step/multi_step functions for a fixed fluid particle count."""

    def __init__(
        self,
        cfg: SPHConfig,
        boundary: BoundaryState,
        boundary_grid: GridContext,
        n_real: int,
        qb: int = 16,
        cap: int = 256,
        seg_q: int = 2,
        interpret: bool = False,
    ):
        self.cfg = cfg
        self.n_real = int(n_real)
        assert n_real < (1 << 24), "float-valued ids are exact only below 2^24"
        nb = int(boundary.x.shape[0])
        self.spec = triple_spec(cfg, self.n_real, nb, qb, cap, seg_q)
        # Pallas interpret mode: only when a caller asks (CPU tests, dry runs)
        self.interpret = interpret
        self.boundary = boundary
        self.b_cell_starts = boundary_grid.cell_starts
        # static gather-source rows for boundary + the inert row.  Force
        # candidates: [x, y, u=0, v=0, psi, cp=0, re=0, a=1.0] — c_press=0
        # is the boundary's fluid-only pressure (`pi_sph_fluid.c:350`);
        # a=1.0 with re=0 makes the viscosity denominator the fluid-only
        # rho_i (`pi_sph_fluid.c:362`; fluid rows carry a=0.5, re=rho/2 for
        # the pair mean — both exact f32 halvings).  Density candidates are
        # slim [x, y, psi, 0] rows.
        zb = jnp.zeros_like(boundary.x)
        self.b_geo = jnp.stack(
            [boundary.x, boundary.y, zb, zb, boundary.m, zb, zb, zb + 1.0],
            axis=1)
        self.b_geo_d = jnp.stack(
            [boundary.x, boundary.y, boundary.m, zb], axis=1)
        self.inert_row = jnp.asarray(
            [[INERT_X, INERT_X, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]], jnp.float32)
        self.inert_row_d = jnp.asarray(
            [[INERT_X, INERT_X, 0.0, 0.0]], dtype=jnp.float32)
        # loop-invariant zero column for the density-geometry build
        self._zcol = jnp.zeros((self.spec.n_layout, 1), jnp.float32)

    # ------------------------------------------------------------------
    @property
    def n_layout(self) -> int:
        return self.spec.n_layout

    # ------------------------------------------------------------------
    def _relayout(self, packed):
        """Sort into the qb-quantized row layout and build the triple
        context.  Row gathers + arithmetic + one scatter-max/cummax only;
        ids ride in packed col 7 (as float values) so they relayout for free.
        """
        cfg, spec = self.cfg, self.spec
        x, y, m = packed[:, 0], packed[:, 1], packed[:, 4]
        keys = jnp.where(m > 0, cell_ids(x, y, cfg), cfg.n_cells)
        order = jnp.argsort(keys, stable=True).astype(jnp.int32)
        counts = jnp.zeros(cfg.n_cells + 2, jnp.int32).at[keys + 1].add(1)
        cell_starts = jnp.cumsum(counts, dtype=jnp.int32)

        layout_src, trip_src, T = build_frame(spec, cfg, cell_starts,
                                              self.b_cell_starts)
        packed_sorted = jnp.concatenate(
            [packed[order], jnp.asarray(_INERT_ROW)[None, :]], axis=0)
        packed_new = packed_sorted[layout_src]
        cells = jnp.where(packed_new[:, 4] > 0,
                          cell_ids(packed_new[:, 0], packed_new[:, 1], cfg),
                          cfg.n_cells)
        w_start, w_len, overflow = block_windows(spec, cfg, cells, T)
        ctx = TripleCtx(layout_src=layout_src, trip_src=trip_src,
                        w_start=w_start, w_len=w_len, T=T, overflow=overflow)
        return packed_new, ctx, overflow

    # ------------------------------------------------------------------
    def _pair_core(self, packed, ctx: TripleCtx, g,
                   half_dt: float = 0.0, damp: float = 1.0):
        """density -> EOS -> forces -> trailing half-kick over one
        candidate frame; returns (pk_next (n_layout, 8), acc
        (n_layout, 2)).  pk_next = [x, y, (u + half_dt*au)*damp, (v +
        half_dt*av)*damp, m, rho, p, id] — the finished state of the
        tick; the defaults (half_dt=0, damp=1) leave u/v unchanged,
        which IS the priming pass.

        Two gathers per tick — slim (L, 4) density geometry before the
        density pass, full (L, 8) force candidates (with the fresh
        c_press/rho_eff of the density epilogue) after it.  The density
        pass emits the assembled fluid force-candidate rows geo8 =
        [x,y,u,v,m,cp,re,a] directly."""
        cfg, spec = self.cfg, self.spec
        geo_d_src = jnp.concatenate([
            jnp.concatenate([packed[:, 0:2], packed[:, 4:5], self._zcol],
                            axis=1),
            self.b_geo_d, self.inert_row_d], axis=0)
        geo_d = geo_d_src[ctx.trip_src].T                   # (4, L)
        geo8, rp = density_window_call(packed, geo_d, ctx.w_start, ctx.w_len,
                                       cfg, spec, interpret=self.interpret)
        # force candidates: fluid rows straight from the density kernel
        geo_f_src = jnp.concatenate([geo8, self.b_geo, self.inert_row],
                                    axis=0)
        geo_f = geo_f_src[ctx.trip_src].T                   # (8, L)
        pk_next, acc = forces_window_call(
            packed, geo8, rp, geo_f, ctx.w_start, ctx.w_len, g, cfg, spec,
            half_dt=half_dt, damp=damp, interpret=self.interpret)
        return pk_next, acc

    def _pair_passes(self, packed, ctx: TripleCtx, g,
                     half_dt: float = 0.0, damp: float = 1.0):
        pk_next, acc = self._pair_core(packed, ctx, g, half_dt, damp)
        return pk_next, acc[:, 0], acc[:, 1]

    def _force_pass(self, packed, g):
        packed, ctx, overflow = self._relayout(packed)
        packed, au, av = self._pair_passes(packed, ctx, g)
        return packed, au, av, overflow

    # ------------------------------------------------------------------
    def _initial_packed(self, fluid: FluidState):
        extra = self.spec.n_layout - fluid.n
        assert extra >= 0, "scene larger than layout capacity"
        cols = np.zeros((self.spec.n_layout, 8), np.float32)
        cols[fluid.n:] = _INERT_ROW
        for j, f in enumerate((fluid.x, fluid.y, fluid.u, fluid.v,
                               fluid.m, fluid.rho, fluid.p)):
            cols[: fluid.n, j] = np.asarray(f)
        cols[: fluid.n, 7] = np.arange(fluid.n, dtype=np.float32)
        return jnp.asarray(cols)

    @staticmethod
    def _ids(packed):
        return packed[:, 7].astype(jnp.int32)

    def prime(self, fluid: FluidState, g) -> PackedSim:
        """Step-0 pass (`pi_sph_fluid.c:604-607`) into layout space."""
        packed = self._initial_packed(fluid)

        @jax.jit
        def _prime(packed, g):
            pk, au, av, _ = self._force_pass(packed, jnp.asarray(g, jnp.float32))
            return PackedSim(packed=pk, ids=self._ids(pk), au=au, av=av)

        return _prime(packed, jnp.asarray(g, jnp.float32))

    # ------------------------------------------------------------------
    def make_step(self, damping: float = 1.0):
        """One tick (kick-drift-forces-kick, `pi_sph_fluid.c:614-644`)."""
        step_ctx = self._make_step_ctx(damping)

        def step(sim: PackedSim, g):
            sim, stats, _ = step_ctx(sim, g)
            return sim, stats

        return step

    def _make_step_ctx(self, damping: float = 1.0):
        """One tick, additionally returning the relayout frame context
        (trip_src + per-cell window table) for renderer frame reuse."""
        dt = jnp.float32(self.cfg.dt)
        half_dt = jnp.float32(0.5) * dt
        half_f = 0.5 * float(self.cfg.dt)   # static kernel param, same bits

        def step(sim: PackedSim, g):
            g = jnp.asarray(g, jnp.float32)
            pk = self._kick_drift(sim, dt, half_dt)
            pk, ctx, overflow = self._relayout(pk)
            pk, au, av = self._pair_passes(pk, ctx, g, half_f,
                                           float(damping))
            sim = PackedSim(packed=pk, ids=self._ids(pk), au=au, av=av)
            return sim, self.stats(sim, overflow), (ctx.trip_src, ctx.T)

        return step

    @staticmethod
    def _kick_drift(sim: PackedSim, dt, half_dt):
        pk = sim.packed
        u = pk[:, 2] + half_dt * sim.au
        v = pk[:, 3] + half_dt * sim.av
        x = pk[:, 0] + dt * u
        y = pk[:, 1] + dt * v
        return jnp.concatenate(
            [x[:, None], y[:, None], u[:, None], v[:, None], pk[:, 4:]], axis=1)

    # NOTE: the trailing half-kick lives in the forces pass epilogue
    # (forces_window_call(half_dt=, damp=) returns the finished state).

    def make_multi_step(self, damping: float = 1.0, resort_every: int = 1,
                        return_frame: bool = False):
        """K ticks per dispatch; ``resort_every`` > 1 reuses layout + windows
        across each group (sticky layout).  Staleness bound as in round 1:
        with v <= C/10 (the WCSPH design bound, `pi_sph_fluid.c:16`) a layout
        stale by k-1 ticks can only miss pairs in the outer 0.2*(k-1)*H shell
        of the support; the triple windows span full cells, so every computed
        pair stays exact.

        ``return_frame=True`` additionally returns the LAST relayout's frame
        context (trip_src, T) so a renderer can reuse the engine's candidate
        structure instead of re-sorting the fluid (see
        render/metaballs_window.WindowRenderer.render_from_frame); the frame
        is ``resort_every - 1`` ticks stale relative to the returned state —
        the same fringe bound as the physics."""
        dt = jnp.float32(self.cfg.dt)
        half_dt = jnp.float32(0.5) * dt
        half_f = 0.5 * float(self.cfg.dt)   # static kernel param, same bits
        damp_f = float(damping)

        if resort_every <= 1:
            if return_frame:
                step_ctx = self._make_step_ctx(damping)

                def multi_step_f(sim: PackedSim, g_trace):
                    frame0 = self._empty_frame()

                    def body(carry, g):
                        sim, _ = carry
                        sim, stats, frame = step_ctx(sim, g)
                        return (sim, frame), stats

                    (sim, frame), stats = jax.lax.scan(
                        body, (sim, frame0), jnp.asarray(g_trace, jnp.float32))
                    return sim, stats, frame

                return multi_step_f
            step = self.make_step(damping)

            def multi_step(sim: PackedSim, g_trace):
                return jax.lax.scan(step, sim, jnp.asarray(g_trace, jnp.float32))

            return multi_step

        zero = jnp.asarray(0, jnp.int32)
        # staleness-guard margin: 0.3*H = the per-particle drift the k<=4
        # fringe analysis permits at the C/10 design bound (see
        # StepStats.stale).  Squared compare, strict >, so a run AT the
        # bound with resort_every <= 4 never trips.
        margin2 = jnp.float32((0.3 * self.cfg.h) ** 2)

        def group(sim: PackedSim, g_group):
            pk = self._kick_drift(sim, dt, half_dt)
            pk, ctx, overflow = self._relayout(pk)
            # layout-time positions + liveness: the staleness-guard datum.
            # Tick 0 computes pairs at exactly these positions (pair passes
            # never move particles), so its stale count is 0 by definition.
            x0, y0, live = pk[:, 0], pk[:, 1], pk[:, 4] > 0
            pk, au, av = self._pair_passes(pk, ctx, g_group[0], half_f,
                                           damp_f)
            sim = PackedSim(packed=pk, ids=self._ids(pk), au=au, av=av)
            st0 = self.stats(sim, overflow, stale=zero)

            # carried ticks as an inner scan: a python-unrolled group keeps
            # every tick's candidate-array temporaries live simultaneously
            # in XLA's buffer assignment; the scan reuses one tick's worth.
            #
            # Stats are SAMPLED on sticky groups: the max-rho / max-speed /
            # non-finite REDUCTIONS run on the fresh tick and the group's
            # final tick only — the reporter maxes over report intervals
            # anyway.  Carried ticks
            # DO fold their rho/speed into per-particle running maxima
            # (two elementwise maxes, no reduction: in-group
            # transient spikes must not vanish from worst-case tracking),
            # so the final tick's sampled stats report the GROUP max, not
            # the final-tick value.  The counted loss channels keep their
            # guarantees: window overflow only arises on the fresh tick's
            # relayout, the STALE drift guard runs on EVERY carried tick,
            # and a non-finite state persists, so the scream is delayed at
            # most k-1 ticks and the run's final tick is always sampled.
            rho_hi = jnp.where(live, pk[:, 5], 0.0)
            sp2_hi = pk[:, 2] ** 2 + pk[:, 3] ** 2   # pads carry u = v = 0

            def carried(carry, g_j):
                sim, rho_hi, sp2_hi = carry
                pk = self._kick_drift(sim, dt, half_dt)
                dx = pk[:, 0] - x0
                dy = pk[:, 1] - y0
                stale = jnp.sum(
                    (live & (dx * dx + dy * dy > margin2)).astype(jnp.int32))
                pk, au, av = self._pair_passes(pk, ctx, g_j, half_f, damp_f)
                rho_hi = jnp.maximum(rho_hi, jnp.where(live, pk[:, 5], 0.0))
                sp2_hi = jnp.maximum(sp2_hi, pk[:, 2] ** 2 + pk[:, 3] ** 2)
                sim = PackedSim(packed=pk, ids=self._ids(pk), au=au, av=av)
                return (sim, rho_hi, sp2_hi), stale

            (sim, rho_hi, sp2_hi), stales = jax.lax.scan(
                carried, (sim, rho_hi, sp2_hi), g_group[1:])
            st_last = self.stats(sim, zero, stale=stales[-1],
                                 rho_hi=rho_hi, sp2_hi=sp2_hi)
            k1 = resort_every - 1
            st_rest = StepStats(
                max_rho_error_pct=jnp.zeros((k1,), jnp.float32)
                    .at[-1].set(st_last.max_rho_error_pct),
                max_speed=jnp.zeros((k1,), jnp.float32)
                    .at[-1].set(st_last.max_speed),
                neighbor_overflow=jnp.zeros((k1,), jnp.int32)
                    .at[-1].set(st_last.neighbor_overflow),
                stale=stales,
            )
            stats = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a[None], b]), st0, st_rest)
            return sim, stats, (ctx.trip_src, ctx.T)

        def multi_step(sim: PackedSim, g_trace):
            g_trace = jnp.asarray(g_trace, jnp.float32)
            k = g_trace.shape[0]
            assert k % resort_every == 0, \
                f"trace length {k} not a multiple of resort_every={resort_every}"
            groups = g_trace.reshape(k // resort_every, resort_every, 2)

            if return_frame:
                def body(carry, g_group):
                    sim, _ = carry
                    sim, stats, frame = group(sim, g_group)
                    return (sim, frame), stats

                (sim, frame), stats = jax.lax.scan(
                    body, (sim, self._empty_frame()), groups)
            else:
                def body(sim, g_group):
                    sim, stats, _ = group(sim, g_group)
                    return sim, stats

                sim, stats = jax.lax.scan(body, sim, groups)
            flat = jax.tree_util.tree_map(lambda a: a.reshape(k, *a.shape[2:]), stats)
            return (sim, flat, frame) if return_frame else (sim, flat)

        return multi_step

    def _empty_frame(self):
        """Zero-valued frame context (trip_src, T) as the scan-carry seed
        for ``return_frame`` — overwritten by the first tick/group."""
        return (jnp.zeros((self.spec.L,), jnp.int32),
                jnp.zeros((self.cfg.n_cells + 1, 8), jnp.int32))

    # ------------------------------------------------------------------
    def stats(self, sim: PackedSim, overflow=None, stale=None,
              rho_hi=None, sp2_hi=None) -> StepStats:
        """Non-finite real rows fold into the overflow scream (x1e6): a max
        reduction is not guaranteed to propagate NaN on every backend, so a
        NaN'd state could otherwise print healthy max stats.

        ``rho_hi``/``sp2_hi``: optional per-particle running maxima (pads
        zeroed) replacing the state's own rho/speed in the max reductions —
        the sticky-group sampled tick passes the group-wide elementwise
        maxima so interior-tick transients reach the reporter's worst-case
        tracking.  The non-finite probe always reads the
        current state (NaN persists; running maxima may drop it)."""
        rho0 = jnp.float32(self.cfg.rho_0)
        m = sim.packed[:, 4]
        rho = sim.packed[:, 5]
        rho_m = jnp.where(m > 0, rho, 0.0) if rho_hi is None else rho_hi
        max_rho_error = jnp.max(rho_m - rho0)
        speed2 = sim.packed[:, 2] ** 2 + sim.packed[:, 3] ** 2
        probe = sim.packed[:, 0] + speed2 + rho        # NaN/inf propagates
        bad = jnp.sum(((m > 0) & ~jnp.isfinite(probe)).astype(jnp.int32))
        if sp2_hi is not None:
            speed2 = sp2_hi
        ov = jnp.asarray(0, jnp.int32) if overflow is None else overflow
        return StepStats(
            max_rho_error_pct=jnp.maximum(max_rho_error, 0.0) / rho0 * 100.0,
            max_speed=jnp.sqrt(jnp.max(speed2)),
            neighbor_overflow=ov + jnp.minimum(bad, 1000) * jnp.int32(1_000_000),
            stale=stale,
        )

    # ------------------------------------------------------------------
    def unpad(self, sim: PackedSim) -> FluidState:
        """Real particles in original id order (host-side convenience)."""
        ids = np.asarray(sim.ids)
        sel = np.nonzero(ids >= 0)[0]
        inv = sel[np.argsort(ids[sel])]
        pk = np.asarray(sim.packed)[inv]
        return FluidState(*(jnp.asarray(pk[:, j]) for j in range(7)))
