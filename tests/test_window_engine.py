"""Window engine (round-2 production path) vs the jnp oracle.

Interpreter-mode kernels on CPU, whole pipeline checked against
models/simulation.py.  The compiled kernels are checked on the GPU by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.models.boundary import prepare_boundary
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine
from pi_sph_fluid_tpu.models.scene import build_dam_break_scene, build_drop_scene
from pi_sph_fluid_tpu.models.simulation import make_step, prime

G = (0.0, -9.81)
ENGINE_KW = dict(qb=8, cap=256, seg_q=2, interpret=True)


def _by_id_oracle(sim):
    inv = np.argsort(np.asarray(sim.ids))
    return {f: np.asarray(getattr(sim.fluid, f))[inv] for f in sim.fluid._fields}


def _by_id_engine(eng, sim):
    fl = eng.unpad(sim)
    return {f: np.asarray(getattr(fl, f)) for f in fl._fields}


@pytest.fixture(scope="module")
def scene():
    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    boundary, bgrid = prepare_boundary(braw, cfg)
    return cfg, fluid, boundary, bgrid


@pytest.fixture(scope="module")
def engine(scene):
    cfg, fluid, boundary, bgrid = scene
    return WindowEngine(cfg, boundary, bgrid, fluid.n, **ENGINE_KW)


@pytest.fixture(scope="module")
def primed(scene, engine):
    cfg, fluid, boundary, bgrid = scene
    return engine.prime(fluid, G), prime(fluid, boundary, bgrid, G, cfg)


def test_prime_matches_oracle(scene, engine, primed):
    cfg, fluid, boundary, bgrid = scene
    psim, osim = primed
    p = _by_id_engine(engine, psim)
    o = _by_id_oracle(osim)
    assert np.isfinite(np.asarray(psim.au)).all()
    np.testing.assert_allclose(p["rho"], o["rho"], rtol=1e-6)
    np.testing.assert_allclose(p["p"], o["p"], rtol=1e-4, atol=0.05)


def test_prime_accelerations_match(scene, engine, primed):
    cfg, fluid, boundary, bgrid = scene
    psim, osim = primed
    real = np.asarray(psim.ids) >= 0
    pinv = np.argsort(np.asarray(psim.ids)[real])
    oinv = np.argsort(np.asarray(osim.ids))
    np.testing.assert_allclose(np.asarray(psim.au)[real][pinv],
                               np.asarray(osim.au)[oinv], rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(psim.av)[real][pinv],
                               np.asarray(osim.av)[oinv], rtol=2e-5, atol=2e-4)


def test_trajectory_matches_oracle(scene, engine, primed):
    cfg, fluid, boundary, bgrid = scene
    psim, osim = primed
    pstep = jax.jit(engine.make_step())
    ostep = jax.jit(make_step(cfg, boundary, bgrid))
    g = jnp.asarray(G, jnp.float32)
    overflow = 0
    for _ in range(30):
        psim, st = pstep(psim, g)
        osim, _ = ostep(osim, g)
        overflow = max(overflow, int(st.neighbor_overflow))
    p = _by_id_engine(engine, psim)
    o = _by_id_oracle(osim)
    np.testing.assert_allclose(p["x"], o["x"], atol=2e-6)
    np.testing.assert_allclose(p["y"], o["y"], atol=2e-6)
    np.testing.assert_allclose(p["u"], o["u"], atol=2e-4)
    np.testing.assert_allclose(p["v"], o["v"], atol=2e-4)
    assert overflow == 0


def test_multi_step_sticky_layout(scene, engine, primed):
    """resort_every=3 carried windows vs per-step relayout: same physics."""
    cfg, fluid, boundary, bgrid = scene
    psim, _ = primed
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (6, 2))
    m1 = jax.jit(engine.make_multi_step(resort_every=1))
    m3 = jax.jit(engine.make_multi_step(resort_every=3))
    s1, st1 = m1(psim, g)
    s3, st3 = m3(psim, g)
    f1 = engine.unpad(s1)
    f3 = engine.unpad(s3)
    np.testing.assert_allclose(np.asarray(f1.x), np.asarray(f3.x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(f1.u), np.asarray(f3.u), atol=1e-5)
    assert st3.max_speed.shape == (6,)
    assert int(jnp.max(st3.neighbor_overflow)) == 0


def test_ids_preserved_and_pads_inert(scene, engine, primed):
    psim, _ = primed
    ids = np.asarray(psim.ids)
    real = ids >= 0
    assert sorted(ids[real]) == list(range(engine.n_real))
    pads = ~real
    pk = np.asarray(psim.packed)
    assert np.all(pk[pads, 4] == 0.0)       # zero mass
    assert np.all(pk[pads, 2] == 0.0)       # at rest
    assert np.all(np.asarray(psim.au)[pads] == 0.0)


def test_window_overflow_reported_not_silent(scene):
    """Tiny cap must report window truncation through the stats channel."""
    cfg, fluid, boundary, bgrid = scene
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, qb=16, cap=128,
                       seg_q=2, interpret=True)
    packed = eng._initial_packed(fluid)
    _, _, overflow = jax.jit(eng._relayout)(packed)
    assert int(overflow) > 0


def test_drop_scene_empty_rows(scene):
    """The drop scene has empty grid rows between fluid and floor — the
    run-table/cummax construction must handle zero-length rows and runs
    (the round-2 denormal-id bug was only visible on this scene)."""
    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg)
    boundary, bgrid = prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **ENGINE_KW)
    psim = eng.prime(fluid, G)
    osim = prime(fluid, boundary, bgrid, G, cfg)
    p = _by_id_engine(eng, psim)
    o = _by_id_oracle(osim)
    np.testing.assert_allclose(p["rho"], o["rho"], rtol=1e-6)
    # one step keeps the id <-> particle mapping intact
    pstep = jax.jit(eng.make_step())
    psim2, st = pstep(psim, jnp.asarray(G, jnp.float32))
    ids = np.asarray(psim2.ids)
    assert sorted(ids[ids >= 0]) == list(range(fluid.n))
    assert int(st.neighbor_overflow) == 0


def test_tiny_clustered_scene(scene):
    """Degenerate sizes: 3 particles sharing one cell (single-block windows,
    mostly-empty grid) survive priming and stepping with exact id tracking."""
    cfg, _, boundary, bgrid = scene
    from pi_sph_fluid_tpu.state import FluidState

    z = jnp.zeros(3, jnp.float32)
    fl = FluidState(x=jnp.asarray([2.0, 2.01, 2.0]),
                    y=jnp.asarray([1.0, 1.0, 1.01]), u=z, v=z,
                    m=z + cfg.particle_mass, rho=z + cfg.rho_0, p=z)
    eng = WindowEngine(cfg, boundary, bgrid, 3, **ENGINE_KW)
    sim = eng.prime(fl, G)
    step = jax.jit(eng.make_step())
    for _ in range(3):
        sim, st = step(sim, jnp.asarray(G, jnp.float32))
    ids = np.asarray(sim.ids)
    assert sorted(ids[ids >= 0]) == [0, 1, 2]
    assert int(st.neighbor_overflow) == 0
    rho = np.asarray(eng.unpad(sim).rho)
    assert np.isfinite(rho).all() and (rho > 0).all()


def test_single_particle_at_corner(scene):
    """One particle in the top-left corner cell: edge-row/edge-column window
    clamps and boundary-wall candidates all on one block."""
    cfg, _, boundary, bgrid = scene
    from pi_sph_fluid_tpu.state import FluidState

    one = jnp.ones(1, jnp.float32)
    fl = FluidState(x=0.05 * one, y=1.99 * one, u=0 * one, v=0 * one,
                    m=cfg.particle_mass * one, rho=cfg.rho_0 * one, p=0 * one)
    eng = WindowEngine(cfg, boundary, bgrid, 1, **ENGINE_KW)
    sim = eng.prime(fl, G)
    fl2 = eng.unpad(sim)
    assert np.isfinite(float(fl2.rho[0])) and float(fl2.rho[0]) > 0
    assert np.isfinite(np.asarray(sim.au)).all()


def test_nonfinite_state_screams_in_stats(scene):
    """Engine-path twin of test_step.test_nonfinite_state_screams_in_stats:
    a NaN row in the packed state must fire the x1e6 overflow scream (a
    max reduction need not propagate NaN, which would hide it)."""
    cfg, fluid, boundary, bgrid = scene
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **ENGINE_KW)
    sim = eng.prime(fluid, G)
    assert int(eng.stats(sim).neighbor_overflow) == 0
    bad = sim._replace(packed=sim.packed.at[5, 2].set(jnp.nan))
    assert int(eng.stats(bad).neighbor_overflow) >= 1_000_000


def test_kernel_epilogue_contract(scene, engine, primed):
    """The fused epilogues of the pair passes.

    density_window_call returns (geo8, rp): geo8 must be the fluid
    force-candidate rows [x, y, u, v, m, cp, re, a=0.5] — cols 0:5 the
    query state verbatim, cp/re/a matching the EOS on the returned rho —
    and rp the [rho, p] pair.  forces_window_call(half_dt, damp) must
    return pk_next with u2 = (u + half_dt*au)*damp, rho/p in cols 5:7 and
    the id column preserved."""
    from pi_sph_fluid_tpu.ops.pallas.window_kernels import (
        _Consts, _eos, density_window_call, forces_window_call)

    cfg = engine.cfg
    psim, _ = primed
    pk, ctx, _ = jax.jit(engine._relayout)(psim.packed)
    zcol = jnp.zeros((pk.shape[0], 1), jnp.float32)
    geo_d_src = jnp.concatenate([
        jnp.concatenate([pk[:, 0:2], pk[:, 4:5], zcol], axis=1),
        engine.b_geo_d, engine.inert_row_d], axis=0)
    geo_d = geo_d_src[ctx.trip_src].T
    geo8, rp = density_window_call(pk, geo_d, ctx.w_start, ctx.w_len,
                                   cfg, engine.spec, interpret=True)
    geo8, rp = np.asarray(geo8), np.asarray(rp)
    # cols 0:5 and 7 (id col replaced by the constant a-weight)
    np.testing.assert_array_equal(geo8[:, 0:5], np.asarray(pk[:, 0:5]))
    np.testing.assert_array_equal(geo8[:, 7], np.full(pk.shape[0], 0.5))
    # EOS columns vs the jnp form (bitwise: same f32 op order)
    p, cp = (np.asarray(a) for a in _eos(_Consts(cfg), jnp.asarray(rp[:, 0])))
    np.testing.assert_array_equal(rp[:, 1], p)
    np.testing.assert_array_equal(geo8[:, 5], cp)
    np.testing.assert_array_equal(geo8[:, 6], np.float32(0.5) * rp[:, 0])

    # forces: fused trailing half-kick vs the explicit form
    geo_f_src = jnp.concatenate(
        [jnp.asarray(geo8), engine.b_geo, engine.inert_row], axis=0)
    geo_f = geo_f_src[ctx.trip_src].T
    half_dt, damp = 0.5 * float(cfg.dt), 0.97
    pk_next, acc = forces_window_call(
        pk, jnp.asarray(geo8), jnp.asarray(rp), geo_f, ctx.w_start,
        ctx.w_len, jnp.asarray(G, jnp.float32), cfg, engine.spec,
        half_dt=half_dt, damp=damp, interpret=True)
    pk_next, acc = np.asarray(pk_next), np.asarray(acc)
    pk_np = np.asarray(pk, np.float32)
    u2 = (pk_np[:, 2] + np.float32(half_dt) * acc[:, 0]) * np.float32(damp)
    v2 = (pk_np[:, 3] + np.float32(half_dt) * acc[:, 1]) * np.float32(damp)
    np.testing.assert_array_equal(pk_next[:, 0:2], pk_np[:, 0:2])  # x, y
    np.testing.assert_allclose(pk_next[:, 2], u2, rtol=0, atol=0)
    np.testing.assert_allclose(pk_next[:, 3], v2, rtol=0, atol=0)
    np.testing.assert_array_equal(pk_next[:, 4], pk_np[:, 4])      # m
    np.testing.assert_array_equal(pk_next[:, 5], rp[:, 0])         # rho
    np.testing.assert_array_equal(pk_next[:, 6], rp[:, 1])         # p
    np.testing.assert_array_equal(pk_next[:, 7], pk_np[:, 7])      # id


def test_sampled_stats_report_group_max(scene, engine, primed):
    """Sticky-group SAMPLED stats must report the GROUP max, not the final
    tick's value: carried ticks fold rho/speed into per-particle
    running maxima, so the sampled final tick equals the max over the
    group's per-tick exact stats."""
    psim, _ = primed
    k, n_groups = 3, 2
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (k * n_groups, 2))
    _, st1 = jax.jit(engine.make_multi_step(resort_every=1))(psim, g)
    _, stk = jax.jit(engine.make_multi_step(resort_every=k))(psim, g)
    sp1 = np.asarray(st1.max_speed)
    rho1 = np.asarray(st1.max_rho_error_pct)
    spk = np.asarray(stk.max_speed)
    rhok = np.asarray(stk.max_rho_error_pct)
    for i in range(n_groups):
        lo, hi = i * k, (i + 1) * k
        # fresh tick reports its own exact stats
        np.testing.assert_allclose(spk[lo], sp1[lo], rtol=1e-5)
        # sampled final tick reports the group-wide max
        np.testing.assert_allclose(spk[hi - 1], sp1[lo:hi].max(), rtol=1e-4)
        np.testing.assert_allclose(rhok[hi - 1], rho1[lo:hi].max(),
                                   rtol=1e-3, atol=1e-3)


def test_sampled_stats_see_interior_transient(scene):
    """An interior-tick speed spike must reach the reporter.  Ballistic
    particles thrown upward decelerate under gravity, so within a sticky
    group the max speed is at the FIRST carried tick — a final-tick-only
    sample would under-report it."""
    cfg, _, boundary, bgrid = scene
    from pi_sph_fluid_tpu.state import FluidState

    # 4 particles > 2H apart: self-density only (rho < rho_0 -> p clamps
    # to 0), so the dynamics are pure gravity and speed strictly decays
    xs = jnp.asarray([0.8, 1.6, 2.4, 3.2], jnp.float32)
    one = jnp.ones(4, jnp.float32)
    fl = FluidState(x=xs, y=1.0 * one, u=0.0 * one, v=2.0 * one,
                    m=cfg.particle_mass * one, rho=cfg.rho_0 * one,
                    p=0.0 * one)
    eng = WindowEngine(cfg, boundary, bgrid, 4, **ENGINE_KW)
    sim = eng.prime(fl, G)
    k = 4
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (k, 2))
    _, st1 = jax.jit(eng.make_multi_step(resort_every=1))(sim, g)
    _, stk = jax.jit(eng.make_multi_step(resort_every=k))(sim, g)
    sp1 = np.asarray(st1.max_speed)
    assert sp1[0] > sp1[k - 1] + 1e-3   # the transient is real
    # the sampled tick must carry the group max (tick 0's speed), not the
    # decayed final-tick speed
    np.testing.assert_allclose(np.asarray(stk.max_speed)[k - 1], sp1.max(),
                               rtol=1e-5)
