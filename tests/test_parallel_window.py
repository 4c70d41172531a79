"""Window-kernel domain decomposition on the virtual CPU mesh.

Validates the production multi-chip path (parallel/domain_window.py):
slab decomposition + single halo exchange + local window kernels against
the single-device WindowEngine, plus conservation and the overflow
counters under forced-tiny capacities (the 'counted, never silent'
invariant for the DD buffers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.models.boundary import prepare_boundary
from pi_sph_fluid_tpu.models.engine_v3 import PackedSim
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine
from pi_sph_fluid_tpu.models.scene import build_dam_break_scene
from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain

G = (0.0, -9.81)
KW = dict(qb=8, cap=256, seg_q=2, interpret=True)


@pytest.fixture(scope="module")
def scene():
    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    boundary, bgrid = prepare_boundary(braw, cfg)
    return cfg, fluid, boundary, bgrid


def _mesh(n):
    devs = jax.devices()
    assert len(devs) >= n, f"need {n} virtual devices"
    return Mesh(np.asarray(devs[:n]), ("x",))


def test_four_slabs_match_single_device(scene):
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(4), **KW)
    state = dd.init(fluid)
    step = jax.jit(dd.make_step())

    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **KW)
    sim = eng.prime(fluid, G)
    sim = PackedSim(packed=sim.packed, ids=sim.ids,
                    au=sim.au * 0, av=sim.av * 0)  # DD starts from zero acc
    estep = jax.jit(eng.make_step())
    g = jnp.asarray(G, jnp.float32)
    for _ in range(15):
        state, st = step(state, g)
        sim, _ = estep(sim, g)
    assert int(st["n_valid"]) == fluid.n
    assert int(st["overflow"]) == 0
    fd = dd.gather(state)
    fe = eng.unpad(sim)
    np.testing.assert_allclose(np.asarray(fd.x), np.asarray(fe.x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fd.y), np.asarray(fe.y), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fd.u), np.asarray(fe.u), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fd.rho), np.asarray(fe.rho),
                               rtol=1e-5, atol=1e-2)


def test_multi_step_scan(scene):
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(2), **KW)
    state = dd.init(fluid)
    multi = jax.jit(dd.make_multi_step())
    gt = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (5, 2))
    state2, st = multi(state, gt)
    assert int(st["n_valid"][-1]) == fluid.n
    assert int(np.max(np.asarray(st["overflow"]))) == 0
    # per-capacity attribution [window, halo, mig, slab] rides along
    assert st["overflow_by"].shape == (5, 4)
    assert int(np.max(np.asarray(st["overflow_by"]))) == 0
    assert np.isfinite(np.asarray(state2.fluid.x)).all()


def test_sticky_groups_match_exact(scene):
    """resort_every=4 (layout + halo membership carried, values re-exchanged
    per tick) vs per-step relayout: same physics within pair-sum tolerance,
    and both match the single-device engine."""
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(4), **KW)
    state = dd.init(fluid)
    g12 = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (12, 2))
    s1, _ = jax.jit(dd.make_multi_step(resort_every=1))(state, g12)
    s4, st4 = jax.jit(dd.make_multi_step(resort_every=4))(state, g12)
    f1 = dd.gather(s1)
    f4 = dd.gather(s4)
    np.testing.assert_allclose(np.asarray(f1.x), np.asarray(f4.x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(f1.u), np.asarray(f4.u), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f1.rho), np.asarray(f4.rho),
                               rtol=1e-5, atol=1e-2)
    assert int(np.asarray(st4["n_valid"])[-1]) == fluid.n
    assert int(np.max(np.asarray(st4["overflow"]))) == 0


def test_500_step_collapse_8_slabs_sticky(scene):
    """Long-horizon stress of the PRODUCTION DD path (the 500-step
    collapse test once exercised only the round-1 jnp DD).
    A full dam-break collapse across 8 slabs with resort_every=4 sticky
    groups: sustained migration + halo traffic across ~125 relayout epochs
    with exact particle conservation, id integrity, zero overflow, and a
    trajectory checkpoint against the single-device engine in the same
    sticky mode."""
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(8), **KW)
    state = dd.init(fluid)
    multi4 = jax.jit(dd.make_multi_step(resort_every=4))

    # checkpoint at step 24: must match the single-device engine running
    # the same sticky mode (summation-order growth only)
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, **KW)
    sim = eng.prime(fluid, G)
    sim = PackedSim(packed=sim.packed, ids=sim.ids,
                    au=sim.au * 0, av=sim.av * 0)  # DD starts from zero acc
    g24 = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (24, 2))
    state, st = multi4(state, g24)
    sim, _ = jax.jit(eng.make_multi_step(resort_every=4))(sim, g24)
    fd = dd.gather(state)
    fe = eng.unpad(sim)
    np.testing.assert_allclose(np.asarray(fd.x), np.asarray(fe.x), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fd.y), np.asarray(fe.y), atol=1e-5)
    np.testing.assert_allclose(np.asarray(fd.u), np.asarray(fe.u), atol=1e-4)

    # run out to 500 steps in 100-step dispatches
    g100 = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (100, 2))
    worst_ov = int(np.max(np.asarray(st["overflow"])))
    max_speed = 0.0
    for _ in range(5):
        state, st = multi4(state, g100)
        worst_ov = max(worst_ov, int(np.max(np.asarray(st["overflow"]))))
        assert int(np.asarray(st["n_valid"])[-1]) == fluid.n
        max_speed = max(max_speed, float(np.max(np.asarray(st["max_speed"]))))
    assert worst_ov == 0
    assert max_speed > 1.0          # the collapse actually happened
    f = dd.gather(state)
    assert np.isfinite(np.asarray(f.x)).all()
    # id integrity: every original particle present exactly once
    ids = np.sort(np.asarray(state.ids)[np.asarray(state.ids) >= 0])
    assert (ids == np.arange(fluid.n)).all()


def test_simrunner_pallas_dd_backend(scene):
    """The CLI-reachable multi-chip path: SimRunner(backend='pallas-dd')
    runs sticky-group slab DD headless with conservation folded into the
    overflow stat."""
    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg, fluid, _, _ = scene
    _, braw = build_dam_break_scene(cfg)
    runner = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                       engine_opts=dict(slabs=4, interpret=True,
                                        qb=8, cap=256, seg_q=2),
                       render=False, resort_every=4)
    res = runner.run(ConstantGravity(cfg), None,
                     sim_seconds=8 * cfg.dt, steps_per_dispatch=8)
    assert res.steps == 8
    assert res.reporter.total_overflow == 0
    assert np.isfinite(np.asarray(res.sim.fluid.x)).all()
    fl = runner.domain.gather(res.sim)
    assert fl.x.shape[0] == fluid.n


def test_halo_overflow_counted_not_silent(scene):
    """Forcing a tiny halo capacity must surface in the overflow counter,
    not silently drop ghosts."""
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(4),
                      halo_cap=8, **KW)
    state = dd.init(fluid)
    step = jax.jit(dd.make_step())
    g = jnp.asarray(G, jnp.float32)
    ov = 0
    by = np.zeros(4, np.int64)
    for _ in range(3):
        state, st = step(state, g)
        ov = max(ov, int(st["overflow"]))
        by = np.maximum(by, np.asarray(st["overflow_by"], np.int64))
        assert int(st["n_valid"]) == fluid.n  # ghosts dropped, owners kept
    assert ov > 0
    # attribution blames the halo column and nothing else
    assert by[1] > 0 and by[0] == 0 and by[2] == 0 and by[3] == 0


def test_window_overflow_counted_in_dd(scene):
    """A too-small kernel window cap must also flow into the DD stats."""
    cfg, fluid, boundary, bgrid = scene
    kw = dict(KW)
    kw["cap"] = 128
    kw["qb"] = 16
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(2), **kw)
    state = dd.init(fluid)
    step = jax.jit(dd.make_step())
    state, st = step(state, jnp.asarray(G, jnp.float32))
    assert int(st["overflow"]) > 0
    by = np.asarray(st["overflow_by"], np.int64)
    assert by[0] > 0 and by[1] == 0    # blamed on the window cap


def test_simrunner_pallas_dd_renders(scene, tmp_path):
    """Multi-chip rendering (round-4 per-slab window renderer, no host
    gather): a dd run with a FileSink must produce one non-empty frame per
    dispatch, pixel-identical to the jnp renderer applied to the gathered
    state.  (The round-3 demo path fed make_renderer id-ordered fluid —
    silently corrupt frames; make_renderer now sorts internally and this
    comparison is no longer circular.)"""
    from pi_sph_fluid_tpu.io.display import FileSink
    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene
    from pi_sph_fluid_tpu.render.metaballs import make_renderer

    cfg, fluid, _, _ = scene
    _, braw = build_dam_break_scene(cfg)
    runner = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                       engine_opts=dict(slabs=4, interpret=True,
                                        qb=8, cap=256, seg_q=2),
                       render=True, resort_every=2)
    path = tmp_path / "dd_frames.bin"
    sink = FileSink(str(path))
    res = runner.run(ConstantGravity(cfg), sink,
                     sim_seconds=4 * cfg.dt, steps_per_dispatch=2)
    sink.close()
    frames = np.fromfile(path, np.uint8).reshape(-1, 1024)
    assert frames.shape[0] == 2                 # one frame per dispatch
    assert frames[-1].any()                     # something was drawn
    ref = np.asarray(make_renderer(cfg)(runner.domain.gather(res.sim)))
    assert (frames[-1] == ref).all()            # matches the jnp renderer


def test_take_first_pads_when_cap_exceeds_source():
    """Regression: _take_first(order[:cap]) silently clamped to the source
    length when cap > len(mask), breaking every downstream static shape —
    hit in practice whenever a grown halo_cap exceeds slab_cap."""
    import jax.numpy as jnp

    from pi_sph_fluid_tpu.parallel.domain import _take_first

    mask = jnp.asarray([True, False, True, False])
    vals = jnp.asarray([1.0, 2.0, 3.0, 4.0])
    packed, lane_valid, ov = _take_first(mask, [vals], cap=6)
    assert packed[0].shape == (6,)
    assert lane_valid.shape == (6,)
    np.testing.assert_array_equal(np.asarray(packed[0]), [1, 3, 0, 0, 0, 0])
    assert int(ov) == 0


def test_export_init_roundtrip_resumes_exactly(scene):
    """domain.export() -> init(fluid, au, av) must resume the trajectory:
    the leapfrog acceleration carry survives the round trip (init without
    it would zero the first half-kick)."""
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(4), **KW)
    step = jax.jit(dd.make_step())
    state = dd.init(fluid)
    for _ in range(3):
        state, _ = step(state, (0.0, -9.81))
    fl, au, av = dd.export(state)
    re_state = dd.init(fl, au, av)
    a, _ = step(state, (0.0, -9.81))
    b, _ = step(re_state, (0.0, -9.81))
    ga, gb = dd.gather(a), dd.gather(b)
    for f in ga._fields:
        np.testing.assert_allclose(np.asarray(getattr(ga, f)),
                                   np.asarray(getattr(gb, f)),
                                   atol=1e-6, rtol=1e-6)


def test_simrunner_dd_autocap_recovery(scene):
    """Elastic capacity recovery on the multi-chip backend: window cap 128
    overflows the dam scene; the attribution counters name the window as
    the starved capacity, so the runner grows ONLY the window cap (halo/
    migration/slab stay put), reverts through export/init (shape-changing
    rebuild) and replays — final run reports zero overflow and tracks a
    clean fixed-cap run."""
    import io as _io

    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg, fluid, _, _ = scene
    _, braw = build_dam_break_scene(cfg)
    log = _io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                       engine_opts=dict(slabs=4, interpret=True,
                                        qb=16, cap=128, seg_q=2),
                       render=False, resort_every=2, max_cap=512)
    caps0 = (runner.domain.halo_cap, runner.domain.mig_cap,
             runner.domain.slab_cap)
    res = runner.run(ConstantGravity(cfg), None, sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries >= 1
    assert runner.domain.spec.cap > 128
    assert res.reporter.total_overflow == 0
    assert "OVERFLOW in ['window']" in log.getvalue()
    # targeted growth: only the starved capacity moved
    assert (runner.domain.halo_cap, runner.domain.mig_cap,
            runner.domain.slab_cap) == caps0

    clean = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                      engine_opts=dict(slabs=4, interpret=True,
                                       qb=16, seg_q=2,
                                       cap=runner.domain.spec.cap),
                      render=False, resort_every=2, auto_cap=False)
    res2 = clean.run(ConstantGravity(cfg), None, sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4)
    assert res2.reporter.total_overflow == 0
    a = runner.domain.gather(res.sim)
    b = clean.domain.gather(res2.sim)
    np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.rho), np.asarray(b.rho),
                               atol=1e-3, rtol=1e-6)


def test_dd_recovery_targets_the_starved_halo(scene):
    """Per-capacity attribution: a deliberately tiny halo_cap (8) starves
    the halo exchange while the window cap is adequate — recovery must
    name 'halo' in the log, grow halo_cap on its ladder, and leave the
    window/migration/slab capacities untouched."""
    import io as _io

    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg, fluid, _, _ = scene
    _, braw = build_dam_break_scene(cfg)
    log = _io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                       engine_opts=dict(slabs=4, interpret=True,
                                        qb=8, cap=256, seg_q=2, halo_cap=8),
                       render=False, resort_every=2, max_cap=512)
    mig0, slab0 = runner.domain.mig_cap, runner.domain.slab_cap
    res = runner.run(ConstantGravity(cfg), None, sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries >= 1
    assert res.reporter.total_overflow == 0
    assert "'halo'" in log.getvalue()
    assert runner.domain.halo_cap > 8
    assert runner.domain.spec.cap == 256          # window untouched
    assert (runner.domain.mig_cap, runner.domain.slab_cap) == (mig0, slab0)


def test_dd_settle_damps_the_startup_transient(scene):
    """Round 4: the dd backend supports the damped settle pre-roll
    (WindowDomain.make_multi_step(damping=...)).

    Two parts: (a) the damping factor is actually applied each tick —
    the same trajectory run with damping=0.9 for 30 ticks ends far
    slower than undamped (0.9^30 ~ 0.04, so a 2x margin is generous);
    (b) SimRunner(settle_seconds=...) runs end-to-end on pallas-dd (the
    round-3 code raised ValueError) and produces finite state."""
    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg, fluid, boundary, bgrid = scene

    # (a) mechanism: damped vs undamped multi-step from the same state
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(2), **KW)
    state = dd.init(fluid)
    gt = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (30, 2))

    def end_speed(damping):
        multi = jax.jit(dd.make_multi_step(resort_every=2, damping=damping))
        st2, _ = multi(state, gt)
        f = dd.gather(st2)
        return float(np.max(np.hypot(np.asarray(f.u), np.asarray(f.v))))

    assert end_speed(0.9) < 0.5 * end_speed(1.0)

    # (b) the runner's settle path on pallas-dd
    _, braw = build_dam_break_scene(cfg)
    opts = dict(slabs=2, interpret=True, qb=8, cap=256, seg_q=2)
    runner = SimRunner(cfg, fluid, braw, backend="pallas-dd",
                       engine_opts=dict(opts), render=False,
                       resort_every=2)
    res = runner.run(ConstantGravity(cfg), None,
                     sim_seconds=4 * cfg.dt, steps_per_dispatch=4,
                     settle_seconds=8 * cfg.dt)
    f = runner.domain.gather(res.sim)
    assert np.isfinite(np.asarray(f.x)).all()
    assert np.isfinite(np.asarray(f.u)).all()


def test_dd_sampled_stats_report_group_max(scene):
    """DD twin of test_window_engine.test_sampled_stats_report_group_max:
    the sticky group's sampled final tick must report the
    group-wide max of rho error / speed (carried ticks fold per-particle
    running maxima; one pmax collective on the sampled tick only)."""
    cfg, fluid, boundary, bgrid = scene
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, _mesh(4), **KW)
    state = dd.init(fluid)
    k, n_groups = 4, 2
    g = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (k * n_groups, 2))
    _, st1 = jax.jit(dd.make_multi_step(resort_every=1))(state, g)
    _, stk = jax.jit(dd.make_multi_step(resort_every=k))(state, g)
    sp1 = np.asarray(st1["max_speed"])
    rho1 = np.asarray(st1["max_rho_error_pct"])
    spk = np.asarray(stk["max_speed"])
    rhok = np.asarray(stk["max_rho_error_pct"])
    for i in range(n_groups):
        lo, hi = i * k, (i + 1) * k
        np.testing.assert_allclose(spk[lo], sp1[lo], rtol=1e-5)
        np.testing.assert_allclose(spk[hi - 1], sp1[lo:hi].max(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(rhok[hi - 1], rho1[lo:hi].max(),
                                   rtol=1e-3, atol=1e-3)
