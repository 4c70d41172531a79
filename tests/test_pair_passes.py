"""Pair passes: the Triton kernels (interpret mode here) against the plain
jax.numpy passes over the same candidate windows, across layout shapes.

Covers query-block sizes, a window cap that is not a power of two (384:
the kernels walk it in power-of-two chunks), one-row segments, and blocks
whose window is shorter than one chunk.  The compiled kernels are checked
on the GPU by the ``gpu``-marked test below and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.models.boundary import prepare_boundary
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine
from pi_sph_fluid_tpu.models.scene import build_dam_break_scene
from pi_sph_fluid_tpu.ops.pallas import window_kernels as wk

G = (0.0, -9.81)


@pytest.fixture(scope="module")
def scene():
    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    boundary, bgrid = prepare_boundary(braw, cfg)
    return cfg, fluid, boundary, bgrid


def _passes(eng, pk, ctx, density, forces, **kw):
    cfg, spec = eng.cfg, eng.spec
    zcol = jnp.zeros((pk.shape[0], 1), jnp.float32)
    src_d = jnp.concatenate([
        jnp.concatenate([pk[:, 0:2], pk[:, 4:5], zcol], axis=1),
        eng.b_geo_d, eng.inert_row_d], axis=0)
    geo8, rp = density(pk, src_d[ctx.trip_src].T, ctx.w_start, ctx.w_len,
                       cfg, spec, **kw)
    src_f = jnp.concatenate([geo8, eng.b_geo, eng.inert_row], axis=0)
    pk2, acc = forces(pk, geo8, rp, src_f[ctx.trip_src].T, ctx.w_start,
                      ctx.w_len, jnp.asarray(G, jnp.float32), cfg, spec,
                      half_dt=0.5 * float(cfg.dt), damp=0.99, **kw)
    return [np.asarray(a) for a in (geo8, rp, pk2, acc)]


def _frame(scene, qb, cap, seg_q):
    cfg, fluid, boundary, bgrid = scene
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, qb=qb, cap=cap,
                       seg_q=seg_q, interpret=True)
    sim = eng.prime(fluid, G)
    pk, ctx, ov = jax.jit(eng._relayout)(sim.packed)
    assert int(ov) == 0
    return eng, pk, ctx


def _compare(eng, pk, got, want):
    real = np.asarray(pk[:, 4]) > 0
    (g8, grp, gpk, gacc), (w8, wrp, wpk, wacc) = got, want
    np.testing.assert_allclose(grp[real], wrp[real], rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(g8[real], w8[real], rtol=1e-5, atol=1e-12)
    scale = np.max(np.abs(wacc[real]))
    np.testing.assert_allclose(gacc, wacc, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(gpk[:, 2:4], wpk[:, 2:4], rtol=0,
                               atol=1e-5 * scale * float(eng.cfg.dt))
    # pads stay inert and at rest
    assert np.all(gacc[~real] == 0.0)


@pytest.mark.parametrize("qb,cap,seg_q", [
    (8, 256, 2),     # the test-suite default
    (16, 256, 2),    # the engine default
    (16, 384, 2),    # cap not a power of two
    (8, 128, 1),     # one-row segments
    (32, 512, 3),    # wide blocks, three-row segments
])
def test_kernels_match_plain_passes(scene, qb, cap, seg_q):
    eng, pk, ctx = _frame(scene, qb, cap, seg_q)
    # windows end mid-chunk: the kernels read past them into
    # support-killed lanes
    assert np.any(np.asarray(ctx.w_len) % wk.CHUNK != 0)
    got = _passes(eng, pk, ctx, wk.density_window_call,
                  wk.forces_window_call, interpret=True)
    want = _passes(eng, pk, ctx, wk.density_plain, wk.forces_plain)
    _compare(eng, pk, got, want)


def test_kernels_match_plain_on_sub_chunk_windows(scene):
    """Three particles in one cell: every window is a fraction of a chunk,
    most blocks are empty (zero trip count)."""
    cfg, _, boundary, bgrid = scene
    from pi_sph_fluid_tpu.state import FluidState

    z = jnp.zeros(3, jnp.float32)
    fl = FluidState(x=jnp.asarray([2.0, 2.01, 2.0]),
                    y=jnp.asarray([1.0, 1.0, 1.01]), u=z, v=z,
                    m=z + cfg.particle_mass, rho=z + cfg.rho_0, p=z)
    eng = WindowEngine(cfg, boundary, bgrid, 3, qb=8, cap=256, seg_q=2,
                       interpret=True)
    pk, ctx, _ = jax.jit(eng._relayout)(eng._initial_packed(fl))
    w_len = np.asarray(ctx.w_len)
    assert w_len.max() < wk.CHUNK and np.any(w_len == 0)
    got = _passes(eng, pk, ctx, wk.density_window_call,
                  wk.forces_window_call, interpret=True)
    want = _passes(eng, pk, ctx, wk.density_plain, wk.forces_plain)
    _compare(eng, pk, got, want)


@pytest.mark.gpu
def test_compiled_kernels_match_plain_passes(gpu, scene):
    """The kernels compiled for the card, against the plain passes."""
    cfg, fluid, boundary, bgrid = scene
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n)
    pk, ctx, _ = jax.jit(eng._relayout)(eng.prime(fluid, G).packed)
    got = _passes(eng, pk, ctx, wk.density_window_call,
                  wk.forces_window_call)
    want = _passes(eng, pk, ctx, wk.density_plain, wk.forces_plain)
    _compare(eng, pk, got, want)
