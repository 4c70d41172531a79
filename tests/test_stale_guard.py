"""Sticky-layout staleness guard (StepStats.stale).

The sticky-group modes reuse a layout for ``resort_every`` ticks; the
fringe analysis certifies no physically-relevant pair loss only while
per-particle drift since the layout stays under 0.3*H (the k<=4 envelope
at the C/10 design bound, `pi_sph_fluid.c:16`).  Round 4 makes that
condition a *measured runtime invariant*: every carried tick counts the
particles past the margin (counted, never silent), and SimRunner's
elastic recovery responds by halving resort_every and replaying.

These tests pin: the guard is quiet on slow flow at resort=8, a synthetic
fast particle trips it (single-chip AND dd backends), and the runner
downgrade ladder lands on the highest resort_every the flow supports.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.io.host_loop import SimRunner
from pi_sph_fluid_tpu.io.gravity import ConstantGravity
from pi_sph_fluid_tpu.models.boundary import prepare_boundary
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine
from pi_sph_fluid_tpu.models.scene import build_drop_scene
from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain

G = (0.0, -9.81)
KW = dict(qb=8, cap=256, seg_q=2, interpret=True)


@pytest.fixture(scope="module")
def scene():
    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg)
    boundary, bgrid = prepare_boundary(braw, cfg)
    return cfg, fluid, boundary, bgrid


def _with_fast_particle(fluid, speed):
    """One particle moving at ``speed`` (m/s) in +x: the synthetic
    staleness driver.  C/10 = 40 m/s is the design bound; the guard
    margin allows 0.3*C/(k-1) per particle at resort_every = k."""
    u = np.asarray(fluid.u).copy()
    u[0] = np.float32(speed)
    return fluid._replace(u=jnp.asarray(u))


def test_guard_quiet_on_slow_flow(scene):
    cfg, fluid, boundary, bgrid = scene
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **KW)
    sim = eng.prime(fluid, G)
    multi = jax.jit(eng.make_multi_step(resort_every=8))
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (16, 2))
    sim, st = multi(sim, g)
    # a from-rest drop reaches ~0.04 m/s in 16 ticks — far under the
    # ~17 m/s the 0.3*H margin allows over 7 carried ticks
    assert st.stale is not None
    assert int(jnp.sum(st.stale)) == 0
    assert int(jnp.max(st.neighbor_overflow)) == 0


def test_fast_particle_trips_guard(scene):
    cfg, fluid, boundary, bgrid = scene
    # 60 m/s = 1.5x the design bound: drift is 0.15*H per tick, so the
    # 0.3*H margin is crossed from the 3rd carried tick of every group
    fast = _with_fast_particle(fluid, 60.0)
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **KW)
    sim = eng.prime(fast, G)
    multi = jax.jit(eng.make_multi_step(resort_every=8))
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (8, 2))
    sim, st = multi(sim, g)
    stale = np.asarray(st.stale)
    assert stale[0] == 0          # tick 0 computes at layout positions
    assert stale[1] == 0          # one tick of drift: 0.15*H < 0.3*H
    assert int(stale.sum()) > 0   # later carried ticks must scream
    # the same trace at resort_every=4 stays within the margin at this
    # speed only through tick 2 (0.30*H is the strict boundary) — but
    # resort_every=2 is provably quiet: one carried tick = 0.15*H
    multi2 = jax.jit(eng.make_multi_step(resort_every=2))
    sim2, st2 = multi2(eng.prime(fast, G), g)
    assert int(np.asarray(st2.stale).sum()) == 0


def test_exact_mode_has_no_guard(scene):
    cfg, fluid, boundary, bgrid = scene
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **KW)
    sim = eng.prime(fluid, G)
    multi = jax.jit(eng.make_multi_step(resort_every=1))
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (4, 2))
    sim, st = multi(sim, g)
    assert st.stale is None   # per-step relayout: nothing can go stale


def test_dd_sticky_guard_trips(scene):
    cfg, fluid, boundary, bgrid = scene
    fast = _with_fast_particle(fluid, 60.0)
    devs = jax.devices()
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n,
                      Mesh(np.asarray(devs[:2]), ("x",)), **KW)
    state = dd.init(fast)
    multi = jax.jit(dd.make_multi_step(resort_every=8))
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (8, 2))
    state, st = multi(state, g)
    stale = np.asarray(st["stale"])
    assert stale[0] == 0
    assert int(stale.sum()) > 0
    assert int(st["n_valid"][-1]) == fluid.n


def test_runner_raises_resort_when_clean(scene):
    """Upward resort ladder (round 5): on a quiet flow the runner doubles
    resort_every after ``raise_after`` consecutive clean report intervals,
    up to max_resort, and the final run must still show stale == 0."""
    cfg, fluid, boundary, bgrid = scene
    stream = io.StringIO()
    _, braw = build_drop_scene(cfg)
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(KW), render=False, resort_every=2,
                       max_resort=8, raise_after=1)
    # k = 16 steps/dispatch divides every rung (2 -> 4 -> 8); 8 report
    # intervals give the ladder room to climb to the ceiling
    result = runner.run(ConstantGravity(cfg), sim_seconds=0.032,
                        steps_per_dispatch=16,
                        report_stream=stream, report_every=0.004)
    out = stream.getvalue()
    assert "RESORT LADDER" in out
    assert runner._resort == 8          # climbed 2 -> 4 -> 8, capped
    assert result.reporter.total_stale == 0
    assert result.recoveries == 0       # raises are not recoveries


def test_ladder_ceiling_pinned_below_tripped_period(scene):
    """A stale trip must pin the upward ceiling below the tripped period —
    the ladder may not climb back into a period the guard rejected."""
    cfg, fluid, boundary, bgrid = scene
    fast = _with_fast_particle(fluid, 60.0)
    stream = io.StringIO()
    _, braw = build_drop_scene(cfg)
    runner = SimRunner(cfg, fast, braw, backend="pallas",
                       engine_opts=dict(KW), render=False, resort_every=8,
                       max_resort=16, raise_after=1)
    result = runner.run(ConstantGravity(cfg), sim_seconds=0.04,
                        steps_per_dispatch=16,
                        report_stream=stream, report_every=0.004)
    out = stream.getvalue()
    assert "STALE DRIFT" in out
    # 60 m/s trips 8 and 4; 2 is quiet (one carried tick = 0.15*H).  The
    # ceiling after the 8- and 4-trips is 2, so no raise may re-enter 4+.
    assert runner._resort == 2
    assert runner._resort_ceiling == 2
    assert result.reporter.total_stale == 0


def test_runner_downgrades_resort_on_stale(scene):
    cfg, fluid, boundary, bgrid = scene
    fast = _with_fast_particle(fluid, 60.0)
    stream = io.StringIO()
    _, braw = build_drop_scene(cfg)   # SimRunner prepares its own boundary
    runner = SimRunner(cfg, fast, braw, backend="pallas",
                       engine_opts=dict(KW), render=False, resort_every=8)
    result = runner.run(ConstantGravity(cfg), sim_seconds=0.02,
                        report_stream=stream, report_every=0.005)
    out = stream.getvalue()
    # at 60 m/s: resort=8 trips (drift 0.45*H by tick 3), resort=4 trips
    # (same margin crossing at its 3rd carried tick), resort=2 is quiet
    # (one carried tick = 0.15*H) — the ladder must land on 2
    assert "STALE DRIFT" in out
    assert runner._resort == 2
    assert result.recoveries >= 2
    assert result.reporter.total_stale == 0
