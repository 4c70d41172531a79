"""Elastic-recovery termination: every capacity ladder has a ceiling.

A scream-only overflow (non-finite rows / lost particles with no counted
capacity crossing) blames nothing, so the dd fallback grows *every*
capacity — which must still terminate: window is bounded by max_cap, slab
by the whole-fluid bound, and halo/mig by the slab cap (halo strips and
departures are subsets of a slab's occupants, so growth past slab_cap is
provably useless).  Once every ladder is at its ceiling `_dd_growth`
returns empty and the run continues with counted losses instead of
replaying forever.
"""

import numpy as np
import pytest

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.models.scene import build_dam_break_scene
from pi_sph_fluid_tpu.models.simulation import OVERFLOW_CATEGORIES


@pytest.fixture(scope="module")
def scene():
    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    return cfg, fluid, braw


@pytest.fixture(scope="module")
def runner(scene):
    from pi_sph_fluid_tpu.io.host_loop import SimRunner

    cfg, fluid, braw = scene
    return SimRunner(cfg, fluid, braw, backend="pallas-dd",
                     engine_opts=dict(slabs=4, interpret=True,
                                      qb=8, cap=128, seg_q=2),
                     render=False, resort_every=2, max_cap=256)


def test_growth_ladders_reach_a_ceiling(runner):
    """Iterating grow-everything from the initial capacities must reach the
    empty proposal (= the 'continuing with losses' exit) in finitely many
    rounds; afterwards halo/mig sit at the slab bound, never beyond."""
    cats = set(OVERFLOW_CATEGORIES)
    caps = dict(cap=runner.domain.spec.cap, halo_cap=runner.domain.halo_cap,
                mig_cap=runner.domain.mig_cap, slab_cap=runner.domain.slab_cap)

    class FakeDomain:  # _dd_growth reads only these four attributes
        class spec:
            cap = None
        halo_cap = mig_cap = slab_cap = None

    d = FakeDomain()
    rounds = 0
    while True:
        d.spec.cap = caps["cap"]
        d.halo_cap, d.mig_cap, d.slab_cap = (
            caps["halo_cap"], caps["mig_cap"], caps["slab_cap"])
        real_domain = runner.domain
        runner.domain = d
        try:
            grow = runner._dd_growth(cats)
        finally:
            runner.domain = real_domain
        if not grow:
            break
        for k, v in grow.items():
            assert v > caps[k], f"{k} proposal {v} did not grow past {caps[k]}"
        caps.update(grow)
        rounds += 1
        assert rounds < 64, f"growth never terminated: {caps}"

    slab_bound = -(-caps["slab_cap"] // 64) * 64
    assert caps["cap"] <= 256                     # max_cap ceiling
    assert caps["halo_cap"] <= slab_bound
    assert caps["mig_cap"] <= slab_bound
    assert caps["slab_cap"] <= -(-(runner.n_fluid + 64) // 128) * 128
    assert rounds >= 1                            # the ladders did move


def test_attribution_order_is_single_sourced():
    """The stacked counter order in domain_window must match the shared
    constant (window, halo, mig, slab) — a reorder would silently grow the
    wrong buffer."""
    import inspect

    from pi_sph_fluid_tpu.parallel import domain_window

    src = inspect.getsource(domain_window)
    # both stats stacks stack [ov_w*, ov_h*, ov_mig, ov_cap] in that order
    assert OVERFLOW_CATEGORIES == ("window", "halo", "mig", "slab")
    assert src.count("ov_w1.astype(jnp.int32), ov_h1.astype(jnp.int32)") == 1
    assert src.count("ov_w.astype(jnp.int32), ov_h.astype(jnp.int32)") == 1


def test_scream_only_overflow_stops_recovering_at_the_ceilings(scene):
    """End-to-end: poison the state so every report screams non-finite rows
    (overflow_by stays zero) — the runner must replay only until the
    ladders exhaust, then print the terminal message and finish."""
    import io as _io

    import jax.numpy as jnp

    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner

    cfg, fluid, braw = scene
    # NaN one particle's velocity: propagates non-finite rows forever, with
    # no capacity crossing to blame
    fluid = fluid._replace(u=fluid.u.at[0].set(jnp.float32("nan")))
    log = _io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                       engine_opts=dict(slabs=4, interpret=True,
                                        qb=8, cap=128, seg_q=2),
                       render=False, resort_every=2, max_cap=256)
    res = runner.run(ConstantGravity(cfg), None, sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, report_stream=log)
    out = log.getvalue()
    assert "continuing with losses" in out
    assert res.recoveries < 64                 # bounded, not forever
    assert res.reporter.total_overflow >= 1_000_000   # the scream persists
    assert np.isfinite(res.wall_s)
