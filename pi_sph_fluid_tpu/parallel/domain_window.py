"""Multi-chip WCSPH with the window kernels inside shard_map.

Round 1's DomainDecomposition (parallel/domain.py) proved slab domain
decomposition with ppermute migration + two-phase halo exchange, but ran
the jnp oracle passes per slab — correctness-only at scale.  This is the
production variant: each device runs the window-kernel pipeline
(ops/pallas/triple.py + ops/pallas/window_kernels.py) on a *local* grid.

Design (SURVEY.md §5 "distributed communication backend"):

* slabs are **cell-aligned**: device s owns grid columns
  [s*k, (s+1)*k), k = ceil(m/d) — so local cell indexing is a column
  shift of the global grid and every slab compiles the same program;
* the local grid is k+6 columns: the owned k plus a 3-cell halo each side.
  Ghost strips are 3 cells wide so that ghost *densities* are locally
  computable: an owned edge query consumes candidates one cell into the
  halo; those ghosts' own 3x3 neighborhoods lie within the first two halo
  cells, both fully present.  The third cell supplies their neighbors (and
  one cell of safety margin against float rounding of the coordinate
  shift).  This buys a **single** ppermute halo exchange per step — the
  round-1 jnp path exchanged twice (positions, then fresh rho/p) and paid
  a second sort + pack;
* each step: migrate -> one halo exchange -> one local relayout -> density
  kernel (owned + ghosts as queries) -> force kernel -> pack owned back.
  Ghost rho recomputed locally equals the owner's value up to summation
  order (different window order, ~1 ulp) — within the framework's pair-sum
  tolerance everywhere else;
* identity: ids ride as int32 through pack + ppermute (exact at any N);
  inside the kernels' packed state they ride as float values in col 7
  (owned >= 0, ghosts = -2, pads = -1), so ownership survives the layout.

Boundary particles are static per slab: host-side init slices the global
boundary into per-device local-sorted arrays (padded to a common cap with
psi = 0 inert rows) shipped as sharded inputs.

Capacities (slab/halo/migration) are physical-area bounds as in round 1;
overflows are counted, never silent, including the window-cap overflow
from the local kernels.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SPHConfig
from ..state import BoundaryState, FluidState
from ..models.engine_v3 import WindowEngine
from ..ops.grid import GridContext
from .domain import (DomainState, _exchange_impl, _inert, _perm_lists,
                     _round_up, _take_first)

__all__ = ["WindowDomain"]

INERT_X = -1e6
GHOST_ID = -2


def _local_cfg(cfg: SPHConfig, local_cols: int) -> SPHConfig:
    """A config whose grid is (n_cell_rows, local_cols): same cell size and
    height, width chosen so the derived column count comes out exactly."""
    lc = cfg.replace(width=(local_cols - 0.5) * cfg.cell_length)
    assert lc.n_cell_cols == local_cols, (lc.n_cell_cols, local_cols)
    assert lc.n_cell_rows == cfg.n_cell_rows
    assert np.float32(lc.cell_length) == np.float32(cfg.cell_length)
    return lc


class WindowDomain:
    """Slab domain decomposition running the window-kernel pipeline."""

    HALO_CELLS = 3

    def __init__(
        self,
        cfg: SPHConfig,
        boundary: BoundaryState,
        boundary_grid: GridContext,
        n_global: int,
        mesh: Mesh,
        axis: str = "x",
        slab_cap: int | None = None,
        halo_cap: int | None = None,
        mig_cap: int | None = None,
        qb: int = 16,
        cap: int = 256,
        seg_q: int = 2,
        interpret: bool = False,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        d = self.n_devices = mesh.shape[axis]
        self.interpret = interpret
        m = cfg.n_cell_cols
        self.k_cols = -(-m // d)                     # owned columns per slab
        self.local_cols = self.k_cols + 2 * self.HALO_CELLS
        self.lcfg = _local_cfg(cfg, self.local_cols)
        cell = np.float32(cfg.cell_length)
        self.slab_w_cells = self.k_cols * float(cell)

        def area_cap(strip_w: float, slack: float = 1.35) -> int:
            return int(strip_w * cfg.height / (cfg.r * cfg.r) * slack) + 1

        self.slab_cap = slab_cap or _round_up(
            min(area_cap(self.slab_w_cells), n_global) + 64, 128)
        self.halo_cap = halo_cap or _round_up(
            min(area_cap(self.HALO_CELLS * float(cell)), n_global) + 64, 64)
        self.mig_cap = mig_cap or _round_up(
            min(area_cap(cfg.h), n_global) + 64, 64)
        n_local = self.slab_cap + 2 * self.halo_cap

        # ---- per-device static boundary slices (local-sorted) -------------
        bx = np.asarray(boundary.x)
        by = np.asarray(boundary.y)
        bpsi = np.asarray(boundary.m)
        gcol = np.clip((bx / cell).astype(np.int64), 0, m - 1)
        grow = np.clip((by / cell).astype(np.int64), 0, cfg.n_cell_rows - 1)
        nb_cap = 0
        slices = []
        for dev in range(d):
            lo, hi = dev * self.k_cols - self.HALO_CELLS, dev * self.k_cols + self.k_cols + self.HALO_CELLS
            sel = np.nonzero((gcol >= lo) & (gcol < hi))[0]
            lcol = gcol[sel] - lo
            lcell = grow[sel] * self.local_cols + lcol
            order = np.argsort(lcell, kind="stable")
            slices.append((sel[order], lcell[order]))
            nb_cap = max(nb_cap, len(sel))
        nb_cap = _round_up(max(nb_cap, 1), 8)
        self.nb_cap = nb_cap
        n_lcells = self.lcfg.n_cells
        # engine_v3 candidate layouts: force rows [x, y, 0, 0, psi, 0, 0,
        # a=1], slim density rows [x, y, psi, 0]; pad rows are inert
        # (psi = 0, far-off position)
        b_geo = np.zeros((d, nb_cap, 8), np.float32)
        b_geo[:, :, 7] = 1.0
        b_geo_d = np.zeros((d, nb_cap, 4), np.float32)
        b_csr = np.zeros((d, n_lcells + 1), np.int32)
        for dev, (sel, lcell) in enumerate(slices):
            shift = np.float32((dev * self.k_cols - self.HALO_CELLS)) * cell
            bxl = (bx[sel] - shift).astype(np.float32)
            b_geo[dev, : len(sel), 0] = bxl
            b_geo[dev, : len(sel), 1] = by[sel]
            b_geo[dev, : len(sel), 4] = bpsi[sel]
            b_geo_d[dev, : len(sel), 0] = bxl
            b_geo_d[dev, : len(sel), 1] = by[sel]
            b_geo_d[dev, : len(sel), 2] = bpsi[sel]
            b_geo[dev, len(sel):, 0] = INERT_X
            b_geo[dev, len(sel):, 1] = INERT_X
            b_geo_d[dev, len(sel):, 0] = INERT_X
            b_geo_d[dev, len(sel):, 1] = INERT_X
            counts = np.bincount(lcell, minlength=n_lcells)
            b_csr[dev, 1:] = np.cumsum(counts)
        sh = NamedSharding(mesh, P(axis))
        # multi-process meshes: a global device_put array cannot be CLOSED
        # OVER by the caller-jitted step functions (JAX forbids capturing
        # arrays that span non-addressable devices) — keep the static
        # boundary tables as host numpy instead; they enter the jit as
        # replicated constants and shard_map's in_specs slice them per
        # device (a few hundred KB at most, identical on every host).
        # Single-process keeps the device-resident fast path.
        self._multiprocess = jax.process_count() > 1
        _put = (lambda a: a) if self._multiprocess else \
            (lambda a: jax.device_put(a, sh))
        self.b_geo_sh = _put(b_geo.reshape(d * nb_cap, 8))
        self.b_geo_d_sh = _put(b_geo_d.reshape(d * nb_cap, 4))
        self.b_csr_sh = _put(b_csr.reshape(d * (n_lcells + 1)))

        # engine template: spec + methods; per-trace copies get the traced
        # per-device boundary arrays patched in (engine methods consume them
        # purely functionally)
        from ..ops.pallas.triple import triple_spec

        self.spec = triple_spec(self.lcfg, n_local, nb_cap, qb, cap, seg_q)
        eng = object.__new__(WindowEngine)
        eng.cfg = self.lcfg
        eng.n_real = n_local
        eng.spec = self.spec
        eng.interpret = interpret
        eng.inert_row = jnp.asarray(
            [[INERT_X, INERT_X, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]], jnp.float32)
        eng.inert_row_d = jnp.asarray(
            [[INERT_X, INERT_X, 0.0, 0.0]], jnp.float32)
        eng._zcol = jnp.zeros((self.spec.n_layout, 1), jnp.float32)
        self._eng_template = eng

    # ------------------------------------------------------------------
    def init(self, fluid: FluidState, au=None, av=None) -> DomainState:
        """Distribute a global FluidState into sharded slab arrays.

        ``au``/``av`` (original-id order, as produced by export()) carry
        the leapfrog acceleration term so a checkpoint resumes EXACTLY —
        including into a domain rebuilt with different capacities (the
        elastic-recovery revert path).  Without them the first half-kick
        sees zero acceleration, as at scene start."""
        d, cap = self.n_devices, self.slab_cap
        cell = np.float32(self.cfg.cell_length)
        x = np.asarray(fluid.x)
        gcol = np.clip((x / cell).astype(np.int64), 0, self.cfg.n_cell_cols - 1)
        dest = np.clip(gcol // self.k_cols, 0, d - 1)
        out = {f: np.zeros((d, cap), np.float32) for f in FluidState._fields}
        out["x"][:] = INERT_X
        out["y"][:] = INERT_X
        aus = np.zeros((d, cap), np.float32)
        avs = np.zeros((d, cap), np.float32)
        ids = np.full((d, cap), -1, np.int32)
        for dev in range(d):
            sel = np.nonzero(dest == dev)[0]
            if len(sel) > cap:
                raise ValueError(f"slab {dev} over capacity: {len(sel)} > {cap}")
            for f in FluidState._fields:
                out[f][dev, : len(sel)] = np.asarray(getattr(fluid, f))[sel]
            if au is not None:
                aus[dev, : len(sel)] = np.asarray(au)[sel]
                avs[dev, : len(sel)] = np.asarray(av)[sel]
            ids[dev, : len(sel)] = sel
        sharding = NamedSharding(self.mesh, P(self.axis))
        state = FluidState(**{
            f: jax.device_put(out[f].reshape(-1), sharding) for f in FluidState._fields
        })
        return DomainState(fluid=state,
                           ids=jax.device_put(ids.reshape(-1), sharding),
                           au=jax.device_put(aus.reshape(-1), sharding),
                           av=jax.device_put(avs.reshape(-1), sharding))

    # ------------------------------------------------------------------
    def _engine(self, b_csr, b_geo, b_geo_d):
        eng = copy.copy(self._eng_template)
        eng.b_cell_starts = b_csr
        eng.b_geo = b_geo
        eng.b_geo_d = b_geo_d
        return eng

    def _build_packed(self, eng, fields, ids_f, shift):
        """Slab+ghost field lists -> (spec.n_layout, 8) packed state in
        local (shifted) coordinates.  fields: [x, y, u, v, m, rho, p].
        Rows beyond the particle capacity are zero pads (m = 0 sorts them
        out with the inert key)."""
        cols = [fields[0] - jnp.where(fields[4] > 0, shift, 0.0)] + \
            list(fields[1:7]) + [ids_f]
        packed = jnp.stack(cols, axis=1)
        extra = self.spec.n_layout - packed.shape[0]
        return jnp.pad(packed, ((0, extra), (0, 0)),
                       constant_values=0.0).at[packed.shape[0]:, 7].set(-1.0)

    def make_step(self, damping: float = 1.0):
        cfg = self.cfg
        lcfg = self.lcfg
        spec = self.spec
        d = self.n_devices
        k = self.k_cols
        hc = self.HALO_CELLS
        cell = jnp.float32(cfg.cell_length)
        inv_cell = jnp.float32(1.0) / cell
        dt = jnp.float32(cfg.dt)
        half = jnp.float32(0.5) * dt
        damp = jnp.float32(damping)
        n_lcells1 = lcfg.n_cells + 1
        slab_cap, halo_cap = self.slab_cap, self.halo_cap

        def gcol_of(x):
            return jnp.clip((x * inv_cell).astype(jnp.int32), 0, cfg.n_cell_cols - 1)

        def local_step(fluid_flat, ids, au, av, b_csr, b_geo, b_geo_d, g):
            eng = self._engine(b_csr, b_geo, b_geo_d)
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

            # migration: move cell-column crossers to the neighbor slab
            dest = jnp.clip(gcol_of(fluid.x) // k, 0, d - 1)
            go_l = valid & (dest < my)
            go_r = valid & (dest > my)
            stay = valid & ~(go_l | go_r)
            payload = list(fluid) + [ids]
            from_left, from_right, ov_mig = _exchange_impl(
                self.axis, d, go_l, go_r, payload, self.mig_cap)
            fluid = _inert(fluid, stay)
            ids = jnp.where(stay, ids, -1)
            merged = [jnp.concatenate([f, a, b])
                      for f, a, b in zip(list(fluid) + [ids], from_left, from_right)]
            packed0, lane_valid, ov_cap = _take_first(merged[4] > 0, merged, slab_cap)
            fluid = _inert(FluidState(*packed0[:7]), lane_valid)
            ids = jnp.where(lane_valid, packed0[7], -1)
            valid = lane_valid

            shift = (my * k - hc).astype(jnp.float32) * cell

            def with_ghosts(fields7):
                """halo-exchange -> [slab + ghosts] field lists + id floats."""
                gcol = gcol_of(fields7[0])
                in_strip_l = valid & (gcol < my * k + hc)
                in_strip_r = valid & (gcol >= (my + 1) * k - hc)
                from_l, from_r, ov_h = _exchange_impl(
                    self.axis, d, in_strip_l, in_strip_r, fields7, halo_cap)
                cat = [jnp.concatenate([f, a, b])
                       for f, a, b in zip(fields7, from_l, from_r)]
                ids_f = jnp.concatenate([
                    jnp.where(valid, ids.astype(jnp.float32), -1.0),
                    jnp.full((2 * halo_cap,), float(GHOST_ID), jnp.float32),
                ])
                return cat, ids_f, ov_h

            # ---- one halo exchange, one layout, both kernels --------------
            cat, ids_f, ov_h1 = with_ghosts(list(fluid))
            packed = self._build_packed(eng, cat, ids_f, shift)
            pk, ctx, ov_w1 = eng._relayout(packed)
            # ghost densities are locally complete for every candidate an
            # owned query can reach (see module docstring), so the force
            # pass needs no second exchange.  _pair_core returns the
            # FINISHED state (trailing half-kick + damp fused in the
            # forces kernel epilogue, round 4): cols 2/3 are u2/v2 and
            # cols 5/6 the fresh rho/p.
            pk2, acc = eng._pair_core(pk, ctx, g,
                                      0.5 * float(cfg.dt), float(damping))
            owner = pk2[:, 7] >= 0.0
            arrays = [pk2[:, j] for j in range(8)] + [acc[:, 0], acc[:, 1]]
            packed2, lv2, _ = _take_first(owner & (pk2[:, 4] > 0), arrays,
                                          slab_cap)
            au = jnp.where(lv2, packed2[8], 0.0)
            av = jnp.where(lv2, packed2[9], 0.0)
            fluid = _inert(FluidState(
                x=packed2[0] + jnp.where(lv2, shift, 0.0), y=packed2[1],
                u=packed2[2], v=packed2[3],
                m=packed2[4], rho=packed2[5], p=packed2[6]), lv2)
            ids = jnp.where(lv2, packed2[7].astype(jnp.int32), -1)
            valid = lv2

            overflow = (ov_mig + ov_cap + ov_h1 + ov_w1).astype(jnp.int32)
            rho0 = jnp.float32(cfg.rho_0)
            sp2 = fluid.u**2 + fluid.v**2
            rho_err = jnp.max(jnp.where(valid, fluid.rho - rho0, -rho0))
            speed2 = jnp.max(jnp.where(valid, sp2, 0.0))
            # non-finite rows scream x1e6: a max reduction need not
            # propagate NaN, so a NaN'd slab could report healthy max stats
            probe = fluid.x + sp2 + fluid.rho
            bad = jnp.sum((valid & ~jnp.isfinite(probe)).astype(jnp.int32))
            overflow = overflow + jnp.minimum(bad, 1000) * jnp.int32(1_000_000)
            # per-capacity attribution in simulation.OVERFLOW_CATEGORIES
            # order [window, halo, mig, slab]: recovery grows exactly the
            # starved buffer (host_loop targeted rebuild)
            ov_by = jnp.stack([
                ov_w1.astype(jnp.int32), ov_h1.astype(jnp.int32),
                ov_mig.astype(jnp.int32), ov_cap.astype(jnp.int32)])
            stats = (
                jax.lax.pmax(jnp.maximum(rho_err, 0.0) / rho0 * 100.0, self.axis),
                jnp.sqrt(jax.lax.pmax(speed2, self.axis)),
                jax.lax.psum(overflow, self.axis),
                jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), self.axis),
                jax.lax.psum(ov_by, self.axis),
            )
            return tuple(fluid), ids, au, av, stats

        spec_p = P(self.axis)
        sharded = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(tuple([spec_p] * 7), spec_p, spec_p, spec_p,
                      spec_p, spec_p, spec_p, P()),
            out_specs=(tuple([spec_p] * 7), spec_p, spec_p, spec_p,
                       (P(), P(), P(), P(), P())),
            # pallas_call outputs carry no varying-mesh-axes annotation
            check_vma=False,
        )

        def step(state: DomainState, g):
            fluid_t, ids, au, av, stats = sharded(
                tuple(state.fluid), state.ids, state.au, state.av,
                self.b_csr_sh, self.b_geo_sh, self.b_geo_d_sh,
                jnp.asarray(g, jnp.float32),
            )
            new = DomainState(fluid=FluidState(*fluid_t), ids=ids, au=au, av=av)
            return new, {
                "max_rho_error_pct": stats[0],
                "max_speed": stats[1],
                "overflow": stats[2],
                "n_valid": stats[3],
                "overflow_by": stats[4],
            }

        return step

    def make_multi_step(self, resort_every: int = 1, damping: float = 1.0):
        """K steps per dispatch via lax.scan.

        ``resort_every`` > 1 enables *sticky groups*: migration, halo
        selection, sort and window build run on the first tick of each
        group; the following ticks stay in layout space and exchange only
        the halo members' live values (one small ppermute per tick) — the
        3-cell halo strips already carry the drift margin (particles move
        <= H/10 per tick under the C/10 design bound), and ghost densities
        stay locally computable.  Same staleness bound as the single-chip
        engine's sticky layout (and the same runtime guard: the carried
        ticks count drift past the 0.3*H fringe margin into stats
        ``stale``).

        ``damping`` < 1 scales velocities each tick (the settle pre-roll,
        matching engine_v3's damped multi-step)."""
        if resort_every <= 1:
            step = self.make_step(damping)

            def multi(state: DomainState, g_trace):
                return jax.lax.scan(step, state, jnp.asarray(g_trace, jnp.float32))

            return multi

        group = self._make_group(resort_every, damping)

        def multi(state: DomainState, g_trace):
            g_trace = jnp.asarray(g_trace, jnp.float32)
            kk = g_trace.shape[0]
            assert kk % resort_every == 0, \
                f"trace length {kk} not a multiple of resort_every={resort_every}"
            groups = g_trace.reshape(kk // resort_every, resort_every, 2)
            state, stats = jax.lax.scan(group, state, groups)
            flat = jax.tree_util.tree_map(
                lambda a: a.reshape(kk, *a.shape[2:]), stats)
            return state, flat

        return multi

    def _make_group(self, resort_every: int, damping: float = 1.0):
        """One sticky group: full step machinery on tick 0, value-only halo
        refresh + kernels on ticks 1..resort_every-1."""
        cfg = self.cfg
        spec = self.spec
        d = self.n_devices
        k = self.k_cols
        hc = self.HALO_CELLS
        cell = jnp.float32(cfg.cell_length)
        inv_cell = jnp.float32(1.0) / cell
        dt = jnp.float32(cfg.dt)
        half = jnp.float32(0.5) * dt
        half_f = 0.5 * float(cfg.dt)    # static kernel param, same bits
        damp_f = float(damping)
        slab_cap, halo_cap = self.slab_cap, self.halo_cap
        n_input = slab_cap + 2 * halo_cap
        OOB = jnp.int32(spec.n_layout + 7)  # dropped by scatter/gather modes

        def gcol_of(x):
            return jnp.clip((x * inv_cell).astype(jnp.int32), 0, cfg.n_cell_cols - 1)

        def select(mask, cap):
            order = jnp.argsort(~mask, stable=True).astype(jnp.int32)
            if cap > order.shape[0]:
                # pad to the static cap, never clamp (same fix as
                # domain._take_first): halo_cap can exceed slab_cap after
                # an elastic-recovery growth
                pad = jnp.zeros((cap - order.shape[0],), jnp.int32)
                return (jnp.concatenate([order, pad]),
                        jnp.concatenate([mask[order],
                                         jnp.zeros(pad.shape, bool)]))
            idx = order[:cap]
            return idx, mask[idx]

        def local_group(fluid_flat, ids, au, av, b_csr, b_geo, b_geo_d,
                        g_group):
            eng = self._engine(b_csr, b_geo, b_geo_d)
            fluid = FluidState(*fluid_flat)
            my = jax.lax.axis_index(self.axis)
            valid = fluid.m > 0

            # ---- tick-0 prologue: kick-drift + migration ------------------
            u = fluid.u + half * au
            v = fluid.v + half * av
            fluid = fluid._replace(
                x=jnp.where(valid, fluid.x + dt * u, fluid.x),
                y=jnp.where(valid, fluid.y + dt * v, fluid.y),
                u=jnp.where(valid, u, 0.0), v=jnp.where(valid, v, 0.0),
            )
            dest = jnp.clip(gcol_of(fluid.x) // k, 0, d - 1)
            go_l = valid & (dest < my)
            go_r = valid & (dest > my)
            stay = valid & ~(go_l | go_r)
            payload = list(fluid) + [ids]
            from_left, from_right, ov_mig = _exchange_impl(
                self.axis, d, go_l, go_r, payload, self.mig_cap)
            fluid = _inert(fluid, stay)
            ids = jnp.where(stay, ids, -1)
            merged = [jnp.concatenate([f, a, b])
                      for f, a, b in zip(list(fluid) + [ids], from_left, from_right)]
            packed0, lane_valid, ov_cap = _take_first(merged[4] > 0, merged, slab_cap)
            fluid = _inert(FluidState(*packed0[:7]), lane_valid)
            ids = jnp.where(lane_valid, packed0[7], -1)
            valid = lane_valid
            shift = (my * k - hc).astype(jnp.float32) * cell

            # ---- halo selection with carried indices ----------------------
            gcol = gcol_of(fluid.x)
            in_l = valid & (gcol < my * k + hc)
            in_r = valid & (gcol >= (my + 1) * k - hc)
            idx_l, lv_l = select(in_l, halo_cap)
            idx_r, lv_r = select(in_r, halo_cap)
            ov_h = (jnp.maximum(jnp.sum(in_l) - halo_cap, 0)
                    + jnp.maximum(jnp.sum(in_r) - halo_cap, 0))
            F = jnp.stack(list(fluid), axis=1)              # (slab_cap, 7)
            pack_l = jnp.where(lv_l[:, None], F[idx_l], 0.0)
            pack_r = jnp.where(lv_r[:, None], F[idx_r], 0.0)
            from_right7 = jax.lax.ppermute(pack_l, self.axis, _perm_lists(d, -1))
            from_left7 = jax.lax.ppermute(pack_r, self.axis, _perm_lists(d, +1))
            cat = [jnp.concatenate([F[:, j], from_left7[:, j], from_right7[:, j]])
                   for j in range(7)]
            ids_f = jnp.concatenate([
                jnp.where(valid, ids.astype(jnp.float32), -1.0),
                jnp.full((2 * halo_cap,), float(GHOST_ID), jnp.float32),
            ])

            # ---- relayout; packed col 5 carries the input-row index so the
            # input -> layout-slot map (inv) can be recovered (cols 5-6 are
            # dead during the group: kernels read rho/p from the density
            # output, and the group-end pack takes them from the kernel's
            # finished state)
            packed = self._build_packed(eng, cat, ids_f, shift)
            rowidx_col = jnp.concatenate([
                jnp.arange(n_input, dtype=jnp.float32),
                jnp.full((spec.n_layout - n_input,), -1.0, jnp.float32)])
            # one concat, not a column .at-set
            packed = jnp.concatenate(
                [packed[:, :5], rowidx_col[:, None], packed[:, 6:]], axis=1)
            pk, ctx, ov_w = eng._relayout(packed)
            # staleness-guard datum: layout-time positions + liveness (same
            # 0.3*H fringe margin as the single-chip engine — see
            # StepStats.stale; ghosts count too, since candidate drift can
            # miss pairs exactly like query drift)
            x0, y0, live = pk[:, 0], pk[:, 1], pk[:, 4] > 0
            margin2 = jnp.float32((0.3 * cfg.h) ** 2)
            rowidx = pk[:, 5].astype(jnp.int32)
            slot_of_input = jnp.full((n_input,), OOB, jnp.int32).at[
                jnp.where(pk[:, 4] > 0, rowidx, n_input)
            ].set(jnp.arange(spec.n_layout, dtype=jnp.int32), mode="drop")
            # carried-tick exchange plumbing (all fixed within the group):
            send_l = jnp.where(lv_l, slot_of_input[idx_l], OOB)
            send_r = jnp.where(lv_r, slot_of_input[idx_r], OOB)
            ghost_l = slot_of_input[slab_cap + jnp.arange(halo_cap)]
            ghost_r = slot_of_input[slab_cap + halo_cap + jnp.arange(halo_cap)]

            def pair_passes(pk, g):
                # returns the FINISHED state (trailing half-kick + damp
                # fused in the forces kernel epilogue; ghost rows get the
                # locally-computed — wrong — kick exactly as the old XLA
                # finish() applied, then the next refresh overwrites them
                # with the owner's values)
                return eng._pair_core(pk, ctx, g, half_f, damp_f)

            def tick_stats(pk, rho_col, ovf, ov_by=None, stale=None,
                           rho_hi=None, sp2_hi=None):
                # rho_hi/sp2_hi: group-wide per-particle running maxima
                # (pads zeroed) — the sampled final tick reports the GROUP
                # max so interior-tick transients stay visible;
                # the non-finite probe always reads the current state
                rho0 = jnp.float32(cfg.rho_0)
                q_valid = pk[:, 4] > 0
                sp2 = pk[:, 2] ** 2 + pk[:, 3] ** 2
                rho_err = (jnp.max(jnp.where(q_valid, rho_col[:, 0] - rho0,
                                             -rho0))
                           if rho_hi is None else jnp.max(rho_hi) - rho0)
                speed2 = (jnp.max(jnp.where(q_valid, sp2, 0.0))
                          if sp2_hi is None else jnp.max(sp2_hi))
                # non-finite rows scream x1e6 (see the per-step stats block
                # above)
                probe = pk[:, 0] + sp2 + rho_col[:, 0]
                bad = jnp.sum((q_valid & ~jnp.isfinite(probe)).astype(jnp.int32))
                ovf = ovf.astype(jnp.int32) + \
                    jnp.minimum(bad, 1000) * jnp.int32(1_000_000)
                if ov_by is None:   # carried ticks: no capacity crossings
                    ov_by = jnp.zeros((4,), jnp.int32)
                if stale is None:   # tick 0 computes at layout positions
                    stale = jnp.asarray(0, jnp.int32)
                return (
                    jax.lax.pmax(jnp.maximum(rho_err, 0.0) / rho0 * 100.0, self.axis),
                    jnp.sqrt(jax.lax.pmax(speed2, self.axis)),
                    jax.lax.psum(ovf.astype(jnp.int32), self.axis),
                    jax.lax.psum(jnp.sum(q_valid & (pk[:, 7] >= 0)).astype(jnp.int32),
                                 self.axis),
                    jax.lax.psum(ov_by, self.axis),
                    jax.lax.psum(stale, self.axis),
                )

            # ---- tick 0 ---------------------------------------------------
            pk, acc = pair_passes(pk, g_group[0])
            ov0 = ov_mig + ov_cap + ov_h + ov_w
            ov_by0 = jnp.stack([
                ov_w.astype(jnp.int32), ov_h.astype(jnp.int32),
                ov_mig.astype(jnp.int32), ov_cap.astype(jnp.int32)])
            st0 = tick_stats(pk, pk[:, 5:6], ov0, ov_by0)

            # carried-tick ghost refresh plumbing: whole-row gathers and ONE
            # whole-row scatter.  Row 4:8 values (m, stale rho/p, the
            # GHOST_ID ownership marker in col 7) are taken from the ghost
            # rows themselves so ownership survives.
            ghost_all = jnp.concatenate([ghost_l, ghost_r])
            x_shift = jnp.concatenate([
                jnp.full((halo_cap,), -(float(self.k_cols)), jnp.float32),
                jnp.full((halo_cap,), float(self.k_cols), jnp.float32),
            ]) * cell

            # group-wide running maxima (elementwise, no reduction, no
            # collective — folded into the sampled final tick)
            rho_hi0 = jnp.where(pk[:, 4] > 0, pk[:, 5], 0.0)
            sp2_hi0 = pk[:, 2] ** 2 + pk[:, 3] ** 2   # pads carry u = v = 0

            def carried(carry, g_j):
                pk, acc, rho_hi, sp2_hi = carry
                # full kick-drift in layout space (ghost rows drift with
                # locally-computed — wrong — acc, then get overwritten by
                # the owner's values below)
                u2 = pk[:, 2] + half * acc[:, 0]
                v2 = pk[:, 3] + half * acc[:, 1]
                x2 = pk[:, 0] + dt * u2
                y2 = pk[:, 1] + dt * v2
                pk = jnp.concatenate(
                    [x2[:, None], y2[:, None], u2[:, None], v2[:, None],
                     pk[:, 4:]], axis=1)
                # halo value refresh: full rows of the carried halo members
                vals_l = jnp.where((send_l < OOB)[:, None],
                                   pk[jnp.minimum(send_l, spec.n_layout - 1)], 0.0)
                vals_r = jnp.where((send_r < OOB)[:, None],
                                   pk[jnp.minimum(send_r, spec.n_layout - 1)], 0.0)
                rec_r = jax.lax.ppermute(vals_l, self.axis, _perm_lists(d, -1))
                rec_l = jax.lax.ppermute(vals_r, self.axis, _perm_lists(d, +1))
                rec = jnp.concatenate([rec_l, rec_r])
                ghost_rows = pk[jnp.minimum(ghost_all, spec.n_layout - 1)]
                # senders' local frames differ by one slab width (col 0);
                # cols 4:8 keep the ghost's own values (column rebuild by
                # concat)
                new_rows = jnp.concatenate(
                    [(rec[:, 0] + x_shift)[:, None], rec[:, 1:4],
                     ghost_rows[:, 4:8]], axis=1)
                pk = pk.at[ghost_all].set(new_rows, mode="drop")
                dx = pk[:, 0] - x0
                dy = pk[:, 1] - y0
                stale = jnp.sum(
                    (live & (dx * dx + dy * dy > margin2)).astype(jnp.int32))
                pk, acc = pair_passes(pk, g_j)
                rho_hi = jnp.maximum(rho_hi, jnp.where(live, pk[:, 5], 0.0))
                sp2_hi = jnp.maximum(sp2_hi,
                                     pk[:, 2] ** 2 + pk[:, 3] ** 2)
                return (pk, acc, rho_hi, sp2_hi), stale

            # Carried ticks return only the LOCAL stale count — stats are
            # SAMPLED (round 4, mirroring engine_v3.make_multi_step): the
            # max/probe reductions and ALL cross-chip collectives (6 per
            # carried tick before) run once post-scan on the group's final
            # state.  Exactness: window overflow only arises at the fresh
            # tick's relayout, ownership (and thus the n_valid conservation
            # count, whose LAST row is the one host_loop consumes) cannot
            # change within a group, the stale guard still runs every tick
            # (one batched vector psum), and a non-finite state persists so
            # the scream is delayed at most k-1 ticks.
            (pk, acc, rho_hi, sp2_hi), stales_local = jax.lax.scan(
                carried, (pk, acc, rho_hi0, sp2_hi0), g_group[1:])
            stales = jax.lax.psum(stales_local, self.axis)
            # the fused kernel wrote the last tick's rho into pk col 5, so
            # tick_stats needs no carried density output — a (n, 1) rho
            # column suffices; the group-wide running maxima ride in as
            # rho_hi/sp2_hi so the sampled tick reports the group max
            st_last = tick_stats(pk, pk[:, 5:6], jnp.asarray(0, jnp.int32),
                                 rho_hi=rho_hi, sp2_hi=sp2_hi)
            k1 = g_group.shape[0] - 1
            zf = jnp.zeros((k1,), jnp.float32)
            zi = jnp.zeros((k1,), jnp.int32)
            st_rest = (
                zf.at[-1].set(st_last[0]),
                zf.at[-1].set(st_last[1]),
                zi.at[-1].set(st_last[2]),
                zi.at[-1].set(st_last[3]),
                jnp.zeros((k1, 4), jnp.int32).at[-1].set(st_last[4]),
                stales,
            )
            stats = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a[None], b]), st0, st_rest)

            # ---- group end: pack owned back to slab arrays ----------------
            owner = pk[:, 7] >= 0.0
            arrays = [pk[:, j] for j in range(8)] + [acc[:, 0], acc[:, 1]]
            packed2, lv2, _ = _take_first(owner & (pk[:, 4] > 0), arrays, slab_cap)
            au_o = jnp.where(lv2, packed2[8], 0.0)
            av_o = jnp.where(lv2, packed2[9], 0.0)
            fluid = _inert(FluidState(
                x=packed2[0] + jnp.where(lv2, shift, 0.0), y=packed2[1],
                u=packed2[2], v=packed2[3],
                m=packed2[4], rho=packed2[5], p=packed2[6]), lv2)
            ids = jnp.where(lv2, packed2[7].astype(jnp.int32), -1)
            return tuple(fluid), ids, au_o, av_o, stats

        spec_p = P(self.axis)
        sharded = jax.shard_map(
            local_group,
            mesh=self.mesh,
            in_specs=(tuple([spec_p] * 7), spec_p, spec_p, spec_p,
                      spec_p, spec_p, spec_p, P()),
            out_specs=(tuple([spec_p] * 7), spec_p, spec_p, spec_p,
                       (P(), P(), P(), P(), P(), P())),
            check_vma=False,
        )

        def group(state: DomainState, g_group):
            fluid_t, ids, au, av, stats = sharded(
                tuple(state.fluid), state.ids, state.au, state.av,
                self.b_csr_sh, self.b_geo_sh, self.b_geo_d_sh,
                jnp.asarray(g_group, jnp.float32),
            )
            new = DomainState(fluid=FluidState(*fluid_t), ids=ids, au=au, av=av)
            return new, {
                "max_rho_error_pct": stats[0],
                "max_speed": stats[1],
                "overflow": stats[2],
                "n_valid": stats[3],
                "overflow_by": stats[4],
                "stale": stats[5],
            }

        return group

    # ------------------------------------------------------------------
    def make_render(self, rows: int = 64, cols: int = 128, qb: int = 8,
                    seg_q: int = 2):
        """Per-slab metaball renderer with no host gather.

        Each device owns the pixels whose grid column falls in its slab
        (the same ``gcol // k`` rule particle migration uses), rendered in
        LOCAL coordinates with the window field pass over a local relayout
        of slab + halo particles — a pixel's 2H support spans at most one
        cell beyond the owned columns, well inside the 3-cell halo strips.
        One [x, y, m] halo ppermute per frame; the composed global field is
        a tiny (d * n_layout_px) cross-device gather, then threshold +
        bit-pack as usual (`pi_sph_fluid.c:380-411`).

        Returns ``render(state, frame_ctx=None) -> (framebuffer,
        overflow)`` — jit-able, so SimRunner fuses it into the per-dispatch
        executable exactly like the single-chip path."""
        from ..ops.grid import cell_ids
        from ..ops.pallas.triple import build_frame, triple_spec
        from ..render.metaballs_window import (INERT_PX, field_pass,
                                               field_scale_of, pixel_layout,
                                               pixel_window_cap,
                                               pixel_windows)
        from ..render.metaballs import pack_framebuffer
        from ..models.scene import pixel_centers

        cfg, lcfg, d = self.cfg, self.lcfg, self.n_devices
        k, hc = self.k_cols, self.HALO_CELLS
        cell = np.float32(cfg.cell_length)
        slab_cap, halo_cap = self.slab_cap, self.halo_cap

        # ---- static per-device pixel layouts (local coordinates) ----------
        px, py = pixel_centers(cfg, rows, cols)
        gcol_px = np.clip((px / cell).astype(np.int64), 0, cfg.n_cell_cols - 1)
        dest = np.clip(gcol_px // k, 0, d - 1)
        lays = []
        for dev in range(d):
            sel = np.nonzero(dest == dev)[0]
            shift = np.float32(dev * k - hc) * cell
            lays.append((sel, pixel_layout(
                lcfg, (px[sel] - shift).astype(np.float32),
                py[sel].astype(np.float32), qb)))
        n_layout = max(lay["n_layout"] for _, lay in lays)
        nqb_tot = n_layout // qb
        q_all = np.zeros((d, n_layout, 8), np.float32)
        q_all[:, :, 0] = INERT_PX
        q_all[:, :, 1] = INERT_PX
        cf_all = np.full((d, nqb_tot), lcfg.n_cells, np.int32)
        cl_all = np.full((d, nqb_tot), lcfg.n_cells, np.int32)
        hq_all = np.zeros((d, nqb_tot), bool)
        unsort = np.zeros(rows * cols, np.int64)
        for dev, (sel, lay) in enumerate(lays):
            nl, nb = lay["n_layout"], lay["n_layout"] // qb
            q_all[dev, :nl] = lay["q"]
            cf_all[dev, :nb] = lay["c_first"]
            cl_all[dev, :nb] = lay["c_last"]
            hq_all[dev, :nb] = lay["has_q"]
            unsort[sel] = dev * n_layout + lay["slots"]
        # same closure rule as the boundary tables: host numpy constants on
        # multi-process meshes, device-resident otherwise
        sh = NamedSharding(self.mesh, P(self.axis))
        _put = (lambda a: a) if self._multiprocess else \
            (lambda a: jax.device_put(a, sh))
        q_sh = _put(q_all.reshape(d * n_layout, 8))
        cf_sh = _put(cf_all.reshape(-1))
        cl_sh = _put(cl_all.reshape(-1))
        hq_sh = _put(hq_all.reshape(-1))
        unsort_j = (unsort.astype(np.int32) if self._multiprocess
                    else jnp.asarray(unsort.astype(np.int32)))

        # candidate spec over the local fluid rows (slab + both halos)
        n_input = slab_cap + 2 * halo_cap
        cap = pixel_window_cap(cfg, cols, qb, seg_q)
        fspec = triple_spec(lcfg, n_input, 0, qb, cap, seg_q)
        scale = jnp.float32(field_scale_of(cfg))
        cellj = jnp.float32(cfg.cell_length)
        inv_cell = jnp.float32(1.0) / cellj

        def gcol_of(x):
            return jnp.clip((x * inv_cell).astype(jnp.int32), 0,
                            cfg.n_cell_cols - 1)

        def local_render(fluid_flat, q_pk, c_first, c_last, has_q):
            fluid = FluidState(*fluid_flat)
            my = jax.lax.axis_index(self.axis)
            valid = fluid.m > 0
            gcol = gcol_of(fluid.x)
            in_l = valid & (gcol < my * k + hc)
            in_r = valid & (gcol >= (my + 1) * k - hc)
            from_l, from_r, ov_h = _exchange_impl(
                self.axis, d, in_l, in_r,
                [fluid.x, fluid.y, fluid.m], halo_cap)
            shift = (my * k - hc).astype(jnp.float32) * cellj
            x = jnp.concatenate([fluid.x, from_l[0], from_r[0]])
            y = jnp.concatenate([fluid.y, from_l[1], from_r[1]])
            m_ = jnp.concatenate([fluid.m, from_l[2], from_r[2]])
            xl = x - jnp.where(m_ > 0, shift, 0.0)

            # local renderer relayout (the WindowRenderer.field recipe on
            # the local grid): sort + frame + slim-row gather
            keys = jnp.where(m_ > 0, cell_ids(xl, y, lcfg), lcfg.n_cells)
            order = jnp.argsort(keys, stable=True).astype(jnp.int32)
            counts = jnp.zeros(lcfg.n_cells + 2, jnp.int32).at[keys + 1].add(1)
            cell_starts = jnp.cumsum(counts, dtype=jnp.int32)
            bcsr0 = jnp.zeros(lcfg.n_cells + 1, jnp.int32)
            layout_src, trip_src, T = build_frame(fspec, lcfg, cell_starts,
                                                  bcsr0)
            slim = jnp.stack([xl, y, m_], axis=1)[order]
            slim = jnp.pad(slim, ((0, fspec.n_layout - n_input), (0, 0)))
            inert = jnp.asarray([[INERT_PX, INERT_PX, 0.0]], jnp.float32)
            pk_r = jnp.concatenate([slim, inert], axis=0)[layout_src]
            cand = jnp.concatenate([pk_r, inert], axis=0)[trip_src].T

            w_start, w_len, ov = pixel_windows(T, c_first, c_last, has_q,
                                               cap, lcfg.n_cells)
            out = field_pass(lcfg, q_pk, cand, w_start, w_len, qb, cap)
            ov_all = jax.lax.psum((ov + ov_h).astype(jnp.int32), self.axis)
            return out, ov_all

        spec_p = P(self.axis)
        sharded = jax.shard_map(
            local_render,
            mesh=self.mesh,
            in_specs=(tuple([spec_p] * 7), spec_p, spec_p, spec_p, spec_p),
            out_specs=(spec_p, P()),
            check_vma=False,
        )

        def render(state: DomainState, frame_ctx=None):
            fields, overflow = sharded(tuple(state.fluid), q_sh, cf_sh,
                                       cl_sh, hq_sh)
            field = fields[unsort_j] * scale
            lit = (field >= 1.0).reshape(rows, cols)
            return pack_framebuffer(lit, rows, cols), overflow

        return render

    # ------------------------------------------------------------------
    def gather(self, state: DomainState) -> FluidState:
        """Collect the global fluid state in original id order (host-side).
        Multi-process meshes all-gather the slab arrays over the network first
        (parallel.launch.to_host), so the same call works on a cluster."""
        from .launch import to_host

        ids = to_host(state.ids)
        sel = ids >= 0
        order = np.argsort(ids[sel])
        return FluidState(*(
            jnp.asarray(to_host(f)[sel][order]) for f in state.fluid
        ))

    def export(self, state: DomainState):
        """(fluid, au, av) in original id order — a LOSSLESS host-side
        checkpoint including the leapfrog acceleration carry.  Feed back
        through ``init(fluid, au, av)`` (of this domain or a rebuilt one
        with different capacities) to resume bit-exactly.  Multi-process
        meshes all-gather over the network (every process returns the full
        checkpoint — the revert path needs it on every host)."""
        from .launch import to_host

        ids = to_host(state.ids)
        sel = ids >= 0
        order = np.argsort(ids[sel])
        fl = FluidState(*(
            jnp.asarray(to_host(f)[sel][order]) for f in state.fluid
        ))
        au = to_host(state.au)[sel][order]
        av = to_host(state.av)[sel][order]
        return fl, au, av
