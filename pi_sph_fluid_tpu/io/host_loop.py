"""The host run loop: K device steps per dispatch, async I/O at the edges.

This replaces the reference's `main` loop (`pi_sph_fluid.c:610-703`) — the
omp-single integration, 60 Hz draw timer, stats block and REALTIME spin-wait
— with the accelerator-shaped equivalent: the device advances K steps per
dispatch (one `lax.scan`), gravity is sampled per batch (a (K, 2) trace),
at most one frame is rendered per dispatch and pushed to a non-blocking
sink, and pacing sleeps instead of spinning.

The device never waits on the host mid-batch; the host never blocks on
display I/O (io/display.AsyncSink).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.simulation import make_multi_step, prime
from ..models.engine_v3 import WindowEngine
from ..render.metaballs import make_renderer
from ..utils.stats import StatsReporter


def _ladder_up(x: int, q: int) -> int:
    """One step of the capacity-escalation ladder: 1.5x rounded up to the
    q-quantum (the single arithmetic behind every elastic-recovery growth —
    window lanes use q=128, halo/mig exchange rows q=64, slabs q=128)."""
    return -(-(x * 3 // 2) // q) * q

__all__ = ["SimRunner"]


@dataclass
class RunResult:
    sim: object
    reporter: StatsReporter
    wall_s: float
    steps: int

    @property
    def particle_steps_per_s(self) -> float:
        return self.n_fluid * self.steps / self.wall_s if self.wall_s else 0.0

    n_fluid: int = 0
    recoveries: int = 0   # elastic-capacity reverts taken (pallas/pallas-dd)


class SimRunner:
    """Owns the compiled step/render functions for one scene.

    backend: "reference" (jnp oracle), "pallas" (window kernels, one
    device), or "pallas-dd" (multi-device slab domain decomposition;
    ``engine_opts['slabs']`` bounds the device count).  The kernels run
    compiled unless ``engine_opts['interpret']`` asks for Pallas interpret
    mode (CPU tests and dry runs).
    """

    def __init__(
        self,
        cfg: SPHConfig,
        fluid,
        boundary_raw,
        backend: str = "pallas",
        engine_opts: dict | None = None,
        render: bool = True,
        render_shape: tuple[int, int] = (64, 128),
        resort_every: int = 1,
        auto_cap: bool = True,
        max_cap: int = 1024,
        max_resort: int | None = None,
        raise_after: int = 2,
    ):
        if resort_every < 1:
            raise ValueError(f"resort_every must be >= 1, got {resort_every}")
        self.cfg = cfg
        self.n_fluid = fluid.n
        self.backend = backend
        boundary, bgrid = prepare_boundary(boundary_raw, cfg)
        self.boundary = boundary
        self._render = render
        self._render_shape = render_shape
        self._resort = resort_every
        # elastic capacity recovery (pallas + pallas-dd): on window
        # overflow, revert to the last clean report checkpoint, rebuild
        # the engine with a bigger cap and re-run the interval (see
        # run(); the dd rebuild also grows halo/migration/slab).  Window
        # overflow is never silent, but at fine resolutions it is also not
        # benign: a sparse free-surface block spanning many grid columns
        # can exceed any fixed cap, and the truncated window loses pairs
        # asymmetrically — measured to cascade into NaN within a few
        # thousand steps on the 100k dam scene.
        self.auto_cap = auto_cap and backend in ("pallas", "pallas-dd")
        self.max_cap = max_cap
        # upward resort ladder: the drift guard counts particles that
        # drift past the fringe margin within a sticky group, so after
        # ``raise_after`` consecutive clean report intervals the runner
        # DOUBLES resort_every up to ``max_resort``, amortizing the
        # relayout further.  The existing trip downgrade still halves it, and
        # a trip lowers the ceiling below the period that tripped so the
        # ladder cannot ping-pong.  Off when max_resort is None.
        self._max_resort = (max_resort
                            if backend in ("pallas", "pallas-dd") else None)
        self._raise_after = max(1, int(raise_after))
        self._resort_ceiling = max_resort or 0

        self._bgrid = bgrid
        self._fluid_init = fluid

        if backend == "pallas":
            self._pallas_opts = dict(engine_opts or {})
            self._build_pallas()
            return
        if backend == "pallas-dd":
            self._dd_opts = dict(engine_opts or {})
            self._build_dd()
            return
        if backend == "reference":
            self.engine = None
            self._prime = lambda g: prime(fluid, boundary, bgrid, g, cfg)
            multi = make_multi_step(cfg, boundary, bgrid)
            self._settle_multi = jax.jit(make_multi_step(cfg, boundary, bgrid, damping=0.995))
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self._resort_every = resort_every if backend.startswith("pallas") else 1
        self._wire(multi)

    # ------------------------------------------------------------------
    def _next_cap(self, old: int) -> int:
        """Escalation ladder: 1.5x rounded up to the 128-lane quantum,
        bounded by max_cap.  Gentler than doubling so a recovered run
        lands near the smallest sufficient cap — cap bounds the lanes each
        query block reads — at the price of at most one extra recompile
        per factor of 2."""
        return min(_ladder_up(old, 128), self.max_cap)

    def _build_pallas(self, cap: int | None = None):
        """(Re)build the single-chip window-engine pipeline.  Called at
        construction and again by run()'s elastic-capacity recovery with a
        larger ``cap`` — n_layout is cap-independent (triple.triple_spec),
        so a checkpointed PackedSim steps unchanged under the new engine."""
        opts = dict(self._pallas_opts)
        if cap is not None:
            opts["cap"] = cap
            # persist: a later rebuild for an unrelated reason (e.g. a
            # staleness downgrade) must not silently revert the grown cap
            self._pallas_opts["cap"] = cap
        self.engine = WindowEngine(self.cfg, self.boundary, self._bgrid,
                                   self.n_fluid, **opts)
        self._prime = lambda g: self.engine.prime(self._fluid_init, g)
        # with a renderer, the multi-step also returns the last relayout
        # frame so the renderer reuses the engine's candidate structure
        # instead of re-sorting the fluid per frame
        multi = self.engine.make_multi_step(resort_every=self._resort,
                                            return_frame=self._render)
        self._settle_multi = jax.jit(self.engine.make_multi_step(damping=0.995))
        self._resort_every = self._resort
        self._wire(multi)

    def _dd_growth(self, cats: set) -> dict:
        """Proposed capacity growth for the starved categories (the
        OVERFLOW_CATEGORIES names), each on its own 1.5x ladder (window
        rounds to the 128-lane quantum via _next_cap; halo/mig to 64,
        slab to 128).  Every ladder has a ceiling — window at ``max_cap``,
        slab at the whole-fluid bound, halo/mig at the slab cap (halo
        strips and departures are subsets of a slab's occupants, so
        growth past slab_cap is provably useless) — and categories
        already at theirs are omitted, so repeated recovery terminates:
        once grow comes back empty the run continues with counted losses
        instead of replaying forever (the scream-only NaN fallback grows
        everything and relies on exactly this exit)."""
        d = self.domain
        grow = {}
        if "window" in cats:
            nc = self._next_cap(d.spec.cap)
            if nc > d.spec.cap:
                grow["cap"] = nc
        edge_bound = -(-d.slab_cap // 64) * 64   # slab_cap, 64-aligned
        if "halo" in cats:
            nh = min(_ladder_up(d.halo_cap, 64), edge_bound)
            if nh > d.halo_cap:
                grow["halo_cap"] = nh
        if "mig" in cats:
            nm = min(_ladder_up(d.mig_cap, 64), edge_bound)
            if nm > d.mig_cap:
                grow["mig_cap"] = nm
        if "slab" in cats:
            ns = min(_ladder_up(d.slab_cap, 128),
                     -(-(self.n_fluid + 64) // 128) * 128)
            if ns > d.slab_cap:
                grow["slab_cap"] = ns
        return grow

    def _build_dd(self, grow: dict | None = None):
        """(Re)build the multi-device slab pipeline (SURVEY §5): the window
        kernels per device inside shard_map, ppermute migration + halo
        exchange.  Rendering is per-slab and in-jit: each device
        rasters its own pixel columns from a local relayout
        (WindowDomain.make_render) — no host gather, so the dd display
        rides the same async pending-frame pipeline as the single-chip
        path.

        ``grow`` (the elastic-recovery rebuild) overrides capacity options
        with the values _dd_growth proposed for the starved categories —
        the per-capacity overflow attribution (StepStats.overflow_by)
        names which buffer starved, so recovery grows exactly that one.
        State shapes change with slab/halo caps — revert goes through
        domain.export()/init() (see run())."""
        import numpy as _np
        from jax.sharding import Mesh

        from ..parallel.domain_window import WindowDomain

        opts = dict(self._dd_opts)
        opts.pop("slabs", None)
        if grow:
            opts.update(grow)
            self._dd_opts.update(grow)
        devs = jax.devices()
        n_slabs = self._dd_opts.get("slabs") or len(devs)
        mesh = Mesh(_np.asarray(devs[:n_slabs]), ("x",))
        self.engine = None
        self.domain = WindowDomain(self.cfg, self.boundary, self._bgrid,
                                   self.n_fluid, mesh, **opts)
        fluid_init = self._fluid_init
        self._prime = lambda g: self.domain.init(fluid_init)
        multi = self._wrap_dd(self.domain.make_multi_step(
            resort_every=self._resort))
        # damped settle pre-roll, same constant as the other backends
        self._settle_multi = jax.jit(self._wrap_dd(
            self.domain.make_multi_step(damping=0.995)))
        self._resort_every = self._resort
        self._wire(multi)

    def _wrap_dd(self, dmulti):
        """Adapt a WindowDomain multi-step's stats dict to StepStats; a
        lost particle must scream (weight conservation breaks) — x1e6 into
        the overflow stat like capacity losses."""
        n_fluid = self.n_fluid

        def multi(state, g_trace):
            from ..models.simulation import StepStats

            state, st = dmulti(state, g_trace)
            lost = jnp.maximum(n_fluid - st["n_valid"][-1], 0)
            return state, StepStats(
                max_rho_error_pct=st["max_rho_error_pct"],
                max_speed=st["max_speed"],
                neighbor_overflow=st["overflow"]
                + lost * jnp.int32(1_000_000),
                overflow_by=st["overflow_by"],
                stale=st.get("stale"))

        return multi

    def _wire(self, multi):
        """Build the renderer and the fused per-dispatch executable."""
        backend, render = self.backend, self._render
        # renderers are normalized to take the whole sim state: the window
        # renderer re-lays-out the packed state itself (exact for any state,
        # including sticky-layout mid-group states), the jnp one takes a
        # FluidState view
        # renderer callables return (framebuffer, overflow): the window
        # renderer counts its own window-cap losses, which are folded into
        # the dispatch stats below (frame corruption must never be silent).
        # On the pallas backend the renderer consumes the engine's relayout
        # frame (render_from_frame); the jnp renderer takes only the state.
        if not render:
            self._renderer = None
        elif backend == "pallas":
            from ..render.metaballs_window import WindowRenderer

            wrend = WindowRenderer(self.engine, *self._render_shape)
            self._renderer = wrend.render_from_frame
        elif backend == "pallas-dd":
            # per-slab window renderer inside the dispatch jit: each device
            # rasters its own pixel columns from a local relayout (one
            # [x,y,m] halo ppermute per frame, no host gather) — the dd
            # display rides the same async pending-frame pipeline as the
            # single-chip path (domain_window.make_render)
            self._renderer = self.domain.make_render(*self._render_shape)
        else:
            jnp_render = make_renderer(self.cfg, *self._render_shape)
            self._renderer = lambda sim, frame: (jnp_render(sim.fluid),
                                                 jnp.asarray(0, jnp.int32))

        # per-dispatch stats reduce to 3 scalars INSIDE the jit: returning
        # (k,)-stat arrays and reducing them host-side spawned several tiny
        # executables per dispatch, and per-executable latency dominates the
        # small-scene loop
        def _reduce(st):
            import jax.numpy as _jnp

            # saturating sum: a catastrophic state can push per-tick
            # overflow counts to 1e9-scale; int32 summing across a long
            # scan would wrap negative and hide the scream
            ov = _jnp.sum(st.neighbor_overflow.astype(_jnp.float32))
            ovb = st.overflow_by
            if ovb is not None:   # (k, 4) -> (4,), same saturation
                ovb = _jnp.minimum(
                    _jnp.sum(ovb.astype(_jnp.float32), axis=0), 1e9
                ).astype(_jnp.int32)
            stale = getattr(st, "stale", None)
            if stale is not None:  # staleness-guard trips, same saturation
                stale = _jnp.minimum(
                    _jnp.sum(stale.astype(_jnp.float32)), 1e9
                ).astype(_jnp.int32)
            return type(st)(
                max_rho_error_pct=_jnp.max(st.max_rho_error_pct),
                max_speed=_jnp.max(st.max_speed),
                neighbor_overflow=_jnp.minimum(ov, 1e9).astype(_jnp.int32),
                overflow_by=ovb,
                stale=stale,
            )

        if self._renderer is None:
            @jax.jit
            def dispatch(sim, g_trace):
                sim, st = multi(sim, g_trace)
                return sim, _reduce(st)

            self._dispatch = dispatch
        else:
            renderer = self._renderer
            with_frame = backend == "pallas"

            @jax.jit
            def dispatch(sim, g_trace):
                if with_frame:
                    sim, st, frame_ctx = multi(sim, g_trace)
                else:
                    sim, st = multi(sim, g_trace)
                    frame_ctx = None
                fb, render_overflow = renderer(sim, frame_ctx)
                st = _reduce(st)
                st = st._replace(neighbor_overflow=st.neighbor_overflow
                                 + render_overflow)
                return sim, st, fb

            self._dispatch = dispatch

    # ------------------------------------------------------------------
    def run(
        self,
        gravity_source,
        sink=None,
        sim_seconds: float = 1.0,
        realtime: bool = False,
        steps_per_dispatch: int | None = None,
        report_stream=None,
        settle_seconds: float = 0.0,
        resume=None,
        report_every: float = 0.1,
    ) -> RunResult:
        """Run ``sim_seconds`` of simulation.  ``resume`` continues from a
        previous RunResult.sim instead of re-priming the scene (warm starts
        skip the step-0 pass and its compile)."""
        cfg = self.cfg
        dt = cfg.dt
        # default batch: one 60 Hz display frame worth of steps
        # (`pi_sph_fluid.c:648`), like the reference's draw cadence; headless
        # runs batch a whole report interval (0.1 sim-s) — dispatch
        # round-trip latency is the real-time limiter on high-latency
        # device attachments, so raise steps_per_dispatch further there
        if steps_per_dispatch:
            k = steps_per_dispatch
        elif self._renderer is not None:
            k = max(1, int(round(1.0 / (60.0 * dt))))
        else:
            k = max(1, int(round(0.1 / dt)))
        k = -(-k // self._resort_every) * self._resort_every
        n_dispatch = max(1, int(round(sim_seconds / (k * dt))))

        if settle_seconds > 0.0 and self._settle_multi is None:
            raise ValueError(
                f"settle_seconds is not supported on backend={self.backend!r}")
        g_init = gravity_source.current()

        def _start():
            """Prime (+ settle); returns (sim, settle_overflow) — settle
            overflow must not evade the recovery path below."""
            sim = resume if resume is not None else self._prime(g_init)
            pending_ov = []
            if settle_seconds > 0.0:
                # damped pre-roll: bleeds off the non-equilibrium startup
                # transient before the measured/displayed run.  Dispatched in
                # k-step chunks (a single multi-second XLA program can trip
                # device watchdogs); settle time rounds UP to whole k-step
                # dispatches (the scan length is the compiled shape).
                n_settle = int(round(settle_seconds / dt))
                g0 = jnp.broadcast_to(
                    jnp.asarray(g_init, jnp.float32), (k, 2))
                for _ in range(-(-n_settle // k)):
                    sim, st = self._settle_multi(sim, g0)
                    pending_ov.append(st.neighbor_overflow)  # drained once
                    # below — a per-chunk host sync would serialize
            ov = sum(int(np.sum(np.asarray(o, np.int64))) for o in pending_ov)
            return sim, ov

        use_ac = self.auto_cap
        recoveries = 0

        def _start_recovered():
            """_start() with settle-overflow recovery: grow capacities on
            their ladders and redo prime+settle until the pre-roll is clean
            (or the ceilings are hit).  Used at run start AND on a mid-run
            revert-to-start."""
            nonlocal use_ac, recoveries
            sim, settle_ov = _start()
            while use_ac and settle_ov > 0:
                if self.backend == "pallas":
                    old_cap = self.engine.spec.cap
                    new_cap = self._next_cap(old_cap)
                    if new_cap <= old_cap:
                        use_ac = False
                        if report_stream is not None:
                            print(f"WINDOW OVERFLOW during settle at "
                                  f"cap={old_cap} (max-cap reached): "
                                  f"continuing with lost pairs",
                                  file=report_stream, flush=True)
                        break
                    if report_stream is not None:
                        print(f"WINDOW OVERFLOW during settle: cap "
                              f"{old_cap} -> {new_cap}, restarting settle",
                              file=report_stream, flush=True)
                    self._build_pallas(cap=new_cap)
                else:
                    # dd: the settle path has no per-category attribution
                    # (it drains only the aggregate), so grow everything
                    from ..models.simulation import OVERFLOW_CATEGORIES

                    grow = self._dd_growth(set(OVERFLOW_CATEGORIES))
                    if not grow:
                        use_ac = False
                        if report_stream is not None:
                            print("OVERFLOW during settle with every "
                                  "capacity at its ceiling: continuing "
                                  "with losses", file=report_stream,
                                  flush=True)
                        break
                    if report_stream is not None:
                        gtxt = ", ".join(f"{k} -> {v}"
                                         for k, v in sorted(grow.items()))
                        print(f"OVERFLOW during settle: growing {gtxt}, "
                              f"restarting settle", file=report_stream,
                              flush=True)
                    self._build_dd(grow=grow)
                recoveries += 1
                sim, settle_ov = _start()
            return sim

        sim = _start_recovered()
        reporter = StatsReporter(dt=dt, stream=report_stream,
                                 report_every_sim_s=report_every)
        # constant sources: build the device trace once instead of a
        # host->device transfer per dispatch (each round trip adds latency)
        g_const = None
        if getattr(gravity_source, "is_constant", False):
            g_const = jnp.asarray(gravity_source.trace(k, dt))
        # elastic-capacity recovery state: checkpoint = (state, position,
        # reporter aggregates) at the last clean report boundary.  Gravity
        # sources are stateful, so every trace issued since the checkpoint
        # is logged for exact replay after a revert.
        ck_sim, ck_i, ck_t = sim, 0, 0.0
        ck_rep = reporter.snapshot()
        ck_is_start = resume is None   # the step-0 prime (and settle) ran
        # under the old cap too — revert-to-start must redo them
        g_log: list = []
        replay_pos = 0
        clean_streak = 0   # consecutive clean report intervals (resort ladder)
        t0 = time.perf_counter()
        t_mono0 = time.monotonic()
        sim_t = 0.0
        pending_frame = None   # displayed one dispatch late: device_get of
        # frame i-1 overlaps dispatch i's execution, so
        # the device never idles waiting on the host fetch — the
        # reference's tearing-tolerant display contract makes the one-
        # dispatch staleness free
        i = 0
        while i < n_dispatch:
            if g_const is not None:
                g_trace = g_const
            elif replay_pos < len(g_log):
                g_trace = g_log[replay_pos]
                replay_pos += 1
            else:
                g_trace = jnp.asarray(gravity_source.trace(k, dt))
                g_log.append(g_trace)
                replay_pos = len(g_log)
            if self._renderer is None:
                sim, st = self._dispatch(sim, g_trace)
            else:
                sim, st, frame = self._dispatch(sim, g_trace)
                if sink is not None:
                    if pending_frame is not None:
                        sink.push(jax.device_get(pending_frame))
                    pending_frame = frame
            line = reporter.update(k, st)
            sim_t += k * dt
            i += 1
            if use_ac and (line is not None or i == n_dispatch):
                # the overflow check rides the report cadence (plus end of
                # run) — the lazy reporter pays its host drain exactly here,
                # so recovery adds no per-dispatch syncs
                if reporter.total_overflow > 0:
                    if self.backend == "pallas":
                        old_cap = self.engine.spec.cap
                        new_cap = self._next_cap(old_cap)
                        if new_cap <= old_cap:
                            use_ac = False
                            if report_stream is not None:
                                print(f"WINDOW OVERFLOW at cap={old_cap} "
                                      f"(max-cap reached): continuing with "
                                      f"lost pairs", file=report_stream,
                                      flush=True)
                            continue
                        if report_stream is not None:
                            print(f"WINDOW OVERFLOW: cap {old_cap} -> "
                                  f"{new_cap}, reverting to t={ck_t:.2f}s "
                                  f"and replaying", file=report_stream,
                                  flush=True)
                        self._build_pallas(cap=new_cap)
                        if ck_is_start:
                            ck_sim = _start_recovered()
                    else:
                        # dd: grow exactly the starved capacities, named by
                        # the per-category attribution counters
                        from ..models.simulation import OVERFLOW_CATEGORIES

                        by = reporter.total_overflow_by
                        names = OVERFLOW_CATEGORIES
                        if by is None or int(by.sum()) == 0:
                            # scream-only overflow (non-finite rows, lost
                            # particles) with no counted capacity crossing:
                            # nothing to blame, grow everything (the
                            # pre-attribution fallback)
                            cats = set(names)
                        else:
                            cats = {n for n, c in zip(names, by)
                                    if int(c) > 0}
                        grow = self._dd_growth(cats)
                        if not grow:
                            use_ac = False
                            if report_stream is not None:
                                print(f"OVERFLOW in {sorted(cats)} with "
                                      f"every starved capacity at its "
                                      f"ceiling: continuing with losses",
                                      file=report_stream, flush=True)
                            continue
                        if report_stream is not None:
                            gtxt = ", ".join(f"{k} -> {v}"
                                             for k, v in sorted(grow.items()))
                            print(f"OVERFLOW in {sorted(cats)}: growing "
                                  f"{gtxt}, reverting to t={ck_t:.2f}s "
                                  f"and replaying", file=report_stream,
                                  flush=True)
                        if ck_is_start:
                            self._build_dd(grow=grow)
                            ck_sim = _start_recovered()
                        else:
                            # buffer shapes change with the grown caps, so
                            # the mid-run checkpoint rides the lossless host
                            # export/import (leapfrog carry included)
                            ck_export = self.domain.export(ck_sim)
                            self._build_dd(grow=grow)
                            ck_sim = self.domain.init(*ck_export)
                    sim, i, sim_t = ck_sim, ck_i, ck_t
                    reporter.restore(ck_rep)
                    replay_pos = 0
                    pending_frame = None
                    recoveries += 1
                    clean_streak = 0
                    t_mono0 = time.monotonic() - sim_t
                    continue
                if reporter.total_stale > 0 and self._resort > 1:
                    # staleness downgrade: particles drifted past the 0.3H
                    # fringe margin within a sticky group, so pairs may have
                    # been missed beyond the certified k<=4 envelope (see
                    # StepStats.stale).  The cure is a fresher layout, not a
                    # bigger cap: halve resort_every, revert, replay.
                    # Terminates at resort=1 (exact mode has no carried
                    # ticks, so the guard cannot trip).
                    new_resort = self._resort // 2
                    if report_stream is not None:
                        print(f"STALE DRIFT: {reporter.total_stale} "
                              f"particle-ticks past the fringe margin; "
                              f"resort_every {self._resort} -> {new_resort}, "
                              f"reverting to t={ck_t:.2f}s and replaying",
                              file=report_stream, flush=True)
                    self._resort = new_resort
                    # a period that tripped must never be re-entered by the
                    # upward ladder: pin its ceiling one rung below
                    self._resort_ceiling = min(self._resort_ceiling,
                                               new_resort)
                    clean_streak = 0
                    if self.backend == "pallas":
                        self._build_pallas()
                    else:
                        self._build_dd()
                    if ck_is_start:
                        ck_sim = _start_recovered()
                    sim, i, sim_t = ck_sim, ck_i, ck_t
                    reporter.restore(ck_rep)
                    replay_pos = 0
                    pending_frame = None
                    recoveries += 1
                    t_mono0 = time.monotonic() - sim_t
                    continue
                if line is not None:
                    ck_sim, ck_i, ck_t = sim, i, sim_t
                    ck_rep = reporter.snapshot()
                    ck_is_start = False
                    # keep any not-yet-replayed suffix: the gravity source's
                    # internal clock already consumed those steps, so they
                    # must come from the log, not a fresh trace() call
                    g_log = g_log[replay_pos:]
                    replay_pos = 0
                    clean_streak += 1
                    # upward resort ladder: the guard read 0 for
                    # raise_after consecutive intervals, so a longer sticky
                    # period is certified-until-tripped.  Raising recompiles
                    # (so not under realtime pacing) and needs the dispatch
                    # length to stay a whole number of groups.
                    if (self._max_resort and not realtime
                            and self._resort > 1
                            and clean_streak >= self._raise_after
                            and i < n_dispatch):
                        new_r = self._resort * 2
                        if new_r <= self._resort_ceiling and k % new_r == 0:
                            if report_stream is not None:
                                print(f"RESORT LADDER: {clean_streak} clean "
                                      f"intervals; resort_every "
                                      f"{self._resort} -> {new_r}",
                                      file=report_stream, flush=True)
                            self._resort = new_r
                            clean_streak = 0
                            if self.backend == "pallas":
                                self._build_pallas()
                            else:
                                self._build_dd()
            if realtime:
                # precise pacing to the sim-time deadline (the reference's
                # REALTIME spin-wait, `pi_sph_fluid.c:694-701`, as a
                # sleep+spin hybrid — native when csrc is built)
                from .native import pace_until

                pace_until(t_mono0 + sim_t)
        if pending_frame is not None and sink is not None:
            sink.push(jax.device_get(pending_frame))
        jax.block_until_ready(sim.fluid.x)
        wall = time.perf_counter() - t0
        return RunResult(sim=sim, reporter=reporter, wall_s=wall,
                         steps=k * n_dispatch, n_fluid=self.n_fluid,
                         recoveries=recoveries)
