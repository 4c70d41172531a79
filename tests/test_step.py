"""Integration tests of the full leapfrog step: stability invariants the
reference monitors at runtime (`pi_sph_fluid.c:656-687`, SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.models.boundary import prepare_boundary
from pi_sph_fluid_tpu.models.scene import build_drop_scene
from pi_sph_fluid_tpu.models.simulation import make_multi_step, make_step, prime

CFG = SPHConfig()
G = (0.0, -9.81)


@pytest.fixture(scope="module")
def sim_setup():
    fluid, boundary_raw = build_drop_scene(CFG)
    boundary, bgrid = prepare_boundary(boundary_raw, CFG)
    sim = prime(fluid, boundary, bgrid, G, CFG)
    return sim, boundary, bgrid


def test_single_step_conserves_shapes_and_finiteness(sim_setup):
    sim, boundary, bgrid = sim_setup
    step = jax.jit(make_step(CFG, boundary, bgrid))
    new_sim, st = step(sim, jnp.asarray(G, jnp.float32))
    for f in new_sim.fluid:
        assert f.shape == (269,)
        assert np.isfinite(np.asarray(f)).all()
    assert np.isfinite(float(st.max_speed))
    assert int(st.neighbor_overflow) == 0


def test_drop_test_runs_stably(sim_setup):
    """Run 0.2 sim-seconds (~820 ticks) of the reference drop scene and check
    the invariants the reference prints: density error small, speed bounded
    by the C/10 = 40 m/s design bound (`pi_sph_fluid.c:16`)."""
    sim, boundary, bgrid = sim_setup
    multi = jax.jit(make_multi_step(CFG, boundary, bgrid))
    k = 820
    g_trace = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (k, 2))
    sim, st = multi(sim, g_trace)
    assert np.isfinite(np.asarray(sim.fluid.x)).all()
    assert float(jnp.max(st.max_speed)) < 40.0
    assert float(jnp.max(st.max_rho_error_pct)) < 10.0
    assert int(jnp.sum(st.neighbor_overflow)) == 0
    # particles stay in (a hair around) the box
    assert float(jnp.min(sim.fluid.x)) > -0.1 and float(jnp.max(sim.fluid.x)) < CFG.width + 0.1
    assert float(jnp.min(sim.fluid.y)) > -0.1 and float(jnp.max(sim.fluid.y)) < CFG.height + 0.1
    # the drop actually fell: fluid reached the lower half
    assert float(jnp.min(sim.fluid.y)) < 0.35


def test_multi_step_equals_repeated_single_steps(sim_setup):
    sim, boundary, bgrid = sim_setup
    step = jax.jit(make_step(CFG, boundary, bgrid))
    multi = jax.jit(make_multi_step(CFG, boundary, bgrid))
    g = jnp.asarray(G, jnp.float32)

    s1 = sim
    for _ in range(5):
        s1, _ = step(s1, g)
    s2, _ = multi(sim, jnp.broadcast_to(g, (5, 2)))
    np.testing.assert_allclose(np.asarray(s1.fluid.x), np.asarray(s2.fluid.x), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(s1.fluid.u), np.asarray(s2.fluid.u), rtol=0, atol=0)


def test_gravity_trace_drives_motion(sim_setup):
    sim, boundary, bgrid = sim_setup
    multi = jax.jit(make_multi_step(CFG, boundary, bgrid))
    k = 50
    # sideways gravity should produce net +x momentum
    g_trace = jnp.broadcast_to(jnp.asarray((9.81, 0.0), jnp.float32), (k, 2))
    out, _ = multi(sim, g_trace)
    assert float(jnp.mean(out.fluid.u)) > 0.05


def test_ids_track_identity(sim_setup):
    sim, boundary, bgrid = sim_setup
    step = jax.jit(make_step(CFG, boundary, bgrid))
    out, _ = step(sim, jnp.asarray(G, jnp.float32))
    ids = np.asarray(out.ids)
    assert sorted(ids) == list(range(out.fluid.n))


def test_nonfinite_state_screams_in_stats(sim_setup):
    """A max reduction need not propagate NaN operands, so a NaN'd state
    could print healthy max stats; the overflow counter must scream instead
    (x1e6 per non-finite row, like capacity-lost rows)."""
    from pi_sph_fluid_tpu.models.simulation import stats

    sim, _, _ = sim_setup
    assert int(stats(sim, CFG).neighbor_overflow) == 0
    bad = sim._replace(fluid=sim.fluid._replace(
        u=sim.fluid.u.at[3].set(jnp.nan)))
    assert int(stats(bad, CFG).neighbor_overflow) >= 1_000_000
