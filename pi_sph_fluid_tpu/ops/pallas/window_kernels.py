"""The two per-tick pair passes over the row-triple candidate layout.

Every query block (``spec.qb`` consecutive layout slots, never straddling a
grid row) owns one contiguous candidate window ``[w_start, w_start + w_len)``
in the ``(k, L)`` candidate arrays built by ops/pallas/triple.py.  The
passes reduce the ``qb x window`` pair tile of each block in place:

  density + Tait EOS           `pi_sph_fluid.c:263-301`
  symmetric pressure + Macklin artificial pressure + Monaghan viscosity
                               `pi_sph_fluid.c:303-373`

Two implementations share one signature:

* ``density_window_call`` / ``forces_window_call``: Pallas kernels on the
  Triton route, one program per query block.  A program loads its queries,
  walks its window in ``CHUNK``-lane power-of-two pieces (a dynamic trip
  count bounded by the block's true window length, capped at ``cap``),
  keeps the ``(qb, CHUNK)`` partial sums in registers, and fuses the EOS,
  the force-candidate row assembly and the trailing half-kick into its
  epilogue.  Nothing of size ``qb x cap`` ever reaches device memory.
* ``density_plain`` / ``forces_plain``: the same arithmetic in plain
  ``jax.numpy`` over a ``(n_blocks, qb, cap)`` pair tensor — the reference
  the kernels are tested against (tests, chip_smoke.py), not a production
  path: on the H100 it measured 2-3x slower end to end (PERF.md).

Lanes of a chunk past the window end need no mask: they are real particles
at least one whole cell (= the 2H support) away, or inert segment pads, so
the q < 2 support test kills them.  Self-pairs need no exclusion either: the
density self-term IS the reference's explicit m*W(0)
(`pi_sph_fluid.c:274-275`) and force self-terms vanish at dx = dy = 0.  The
only mask guards the end of the candidate array itself.

The boundary asymmetries (fluid-only pressure, fluid-rho viscosity
denominator, `pi_sph_fluid.c:350,362`) are folded into per-candidate rows
c_press_j (p/rho^2 fluid, 0 boundary), re_j (rho/2 fluid, 0 boundary) and
a_j (0.5 fluid, 1.0 boundary), computed once per particle: the viscosity
denominator is one fma, denom = a_j*rho_i + re_j, and the two viscosity
divides fuse into one, mu/denom = h*xy_uv / ((r^2 + eps*h^2) * denom).
Pad queries (m = 0, rho = 0) may produce 0/0 on their own lanes; every such
value is discarded by the final q_valid select.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import SPHConfig
from ...core.pair_terms import artificial_pressure_ref_w
from .triple import INERT_X, TripleSpec

X, Y, U, V, M = range(5)
CP, RE, A = 5, 6, 7      # force-candidate rows: c_press, rho_eff, denom weight
DX, DY, DM = 0, 1, 2     # slim density-array rows
NFIELDS = 8
CHUNK = 16               # candidate lanes per kernel loop iteration
NUM_WARPS = 1

__all__ = ["density_window_call", "forces_window_call",
           "density_plain", "forces_plain"]


def _unnorm_wref(cfg: SPHConfig) -> float:
    """W(0.2H)/norm — the artificial-pressure reference, unnormalized (the
    normalisations cancel in the W/W_ref ratio)."""
    return float(artificial_pressure_ref_w(cfg)) / float(cfg.kernel_norm)


class _Consts:
    """f32 constants of both passes, built from the config once per trace."""

    def __init__(self, cfg: SPHConfig):
        h = jnp.float32(cfg.h)
        self.norm = jnp.float32(cfg.kernel_norm)
        self.half_inv_h = jnp.float32(0.5) / h
        self.two_inv_h = jnp.float32(2.0) / h
        self.inv_rho0 = jnp.float32(1.0 / cfg.rho_0)
        self.tait_b = jnp.float32(cfg.tait_b)
        self.eps_h2 = jnp.float32(cfg.eps_visc) * h * h
        # -alpha*C*h, with the h of mu folded in (`pi_sph_fluid.c:328-334`)
        self.nach = jnp.float32(-cfg.alpha_visc) * jnp.float32(cfg.c) * h
        inv_wref4 = (jnp.float32(1.0) / jnp.float32(_unnorm_wref(cfg))) ** 4
        self.k_ap4 = jnp.float32(cfg.k_artificial_pressure) * inv_wref4
        # a = g - sum coef*grad_W; grad coefficient = norm*(-5)*t1^3/h^2
        # factored out of the lane sum: a = g + (5*norm/h^2) * sum_raw
        self.gfac = jnp.float32(5.0) * self.norm / (h * h)


def _density_terms(k: _Consts, qx, qy, cx, cy, cm):
    """Unnormalized density summands m_j * W_un(r_ij) (broadcasting)."""
    dx = qx - cx
    dy = qy - cy
    r = jnp.sqrt(dx * dx + dy * dy)
    t1 = jnp.maximum(1.0 - k.half_inv_h * r, 0.0)     # support == q < 2
    t1sq = t1 * t1
    return (cm * (t1sq * t1sq)) * (1.0 + k.two_inv_h * r)


def _eos(k: _Consts, rho):
    """Tait EOS and the per-particle force inputs p/rho^2, rho/2
    (`pi_sph_fluid.c:294-301`) on reduced density sums."""
    ratio = rho * k.inv_rho0
    rr2 = ratio * ratio
    rr4 = rr2 * rr2
    p = jnp.maximum(k.tait_b * (rr4 * rr2 * ratio - 1.0), 0.0)
    cpress = jnp.where(rho > 0.0, p / (rho * rho), 0.0)
    return p, cpress


def _force_terms(k: _Consts, q, c):
    """(coef*dx, coef*dy) pair summands.  q: query columns (x, y, u, v,
    rho, c_press); c: candidate rows (x, y, u, v, m, cp, re, a)."""
    qx, qy, qu, qv, q_rho, q_press = q
    cx, cy, cu, cv, cm, ccp, cre, ca = c
    dx = qx - cx
    dy = qy - cy
    du = qu - cu
    dv = qv - cv
    r2 = dx * dx + dy * dy
    r = jnp.sqrt(r2)
    t1 = jnp.maximum(1.0 - k.half_inv_h * r, 0.0)
    t1sq = t1 * t1
    t13 = t1sq * t1
    w_un = (t1sq * t1sq) * (1.0 + k.two_inv_h * r)
    # symmetric pressure (`pi_sph_fluid.c:321`); c_press is 0 on boundary
    # lanes -> fluid-only term (`pi_sph_fluid.c:350`)
    press = q_press + ccp
    # Macklin artificial pressure (`pi_sph_fluid.c:325`)
    w2 = w_un * w_un
    artif = k.k_ap4 * (w2 * w2)
    # Monaghan viscosity; min() gates approaching pairs (xy_uv < 0) exactly
    # like the reference's compare+select: others give 0/den = 0
    xy_uv = dx * du + dy * dv
    den = (r2 + k.eps_h2) * (ca * q_rho + cre)
    visc = (k.nach * jnp.minimum(xy_uv, 0.0)) / den
    coef = cm * (press + artif + visc) * t13
    return coef * dx, coef * dy


def _kick(k: _Consts, g, qm, sx, sy, qu, qv, half_dt, damp):
    """Accelerations from the reduced sums and the trailing half-kick."""
    q_valid = qm > 0.0
    au = jnp.where(q_valid, g[0] + k.gfac * sx, 0.0)
    av = jnp.where(q_valid, g[1] + k.gfac * sy, 0.0)
    half_f = jnp.float32(half_dt)
    damp_f = jnp.float32(damp)
    return au, av, (qu + half_f * au) * damp_f, (qv + half_f * av) * damp_f


def _with_cols(tile, cols: dict):
    """Replace columns of a (rows, k) register tile: one store per tile."""
    col = jax.lax.broadcasted_iota(jnp.int32, tile.shape, 1)
    for j, v in cols.items():
        tile = jnp.where(col == j, v[:, None], tile)
    return tile


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------


def _n_chunks(w_len, cap):
    return (jnp.minimum(w_len, cap) + (CHUNK - 1)) // CHUNK


def _load_row(ref, row, start, length, fill):
    """CHUNK lanes of candidate row ``row`` from ``start`` (any offset)."""
    ok = start + jnp.arange(CHUNK, dtype=jnp.int32) < length
    return plgpu.load(ref.at[row, pl.ds(start, CHUNK)], mask=ok, other=fill)


def _density_kernel(ws_ref, wl_ref, q_ref, geo_ref, geo8_ref, rp_ref, *,
                    cfg: SPHConfig, cap: int, length: int):
    k = _Consts(cfg)
    b = pl.program_id(0)
    start = ws_ref[b]
    qx = q_ref[:, X][:, None]
    qy = q_ref[:, Y][:, None]

    def body(c, acc):
        s = start + c * CHUNK
        cx = _load_row(geo_ref, DX, s, length, INERT_X)
        cy = _load_row(geo_ref, DY, s, length, INERT_X)
        cm = _load_row(geo_ref, DM, s, length, 0.0)
        return acc + _density_terms(k, qx, qy, cx[None, :], cy[None, :],
                                    cm[None, :])

    acc = jax.lax.fori_loop(0, _n_chunks(wl_ref[b], cap), body,
                            jnp.zeros(qx.shape[:1] + (CHUNK,), jnp.float32))
    rho = k.norm * jnp.sum(acc, axis=1)
    p, cpress = _eos(k, rho)
    # geo8 = the fluid force-candidate rows [x, y, u, v, m, cp, re, a=0.5]
    geo8_ref[...] = _with_cols(q_ref[...], {
        CP: cpress, RE: 0.5 * rho, A: jnp.full_like(rho, 0.5)})
    rp_ref[...] = _with_cols(jnp.zeros(rp_ref.shape, jnp.float32),
                             {0: rho, 1: p})


def density_window_call(q_packed, geo_d, w_start, w_len, cfg: SPHConfig,
                        spec: TripleSpec, interpret: bool = False):
    """Returns (geo8, rp): the (n_layout, 8) fluid force-candidate rows
    [x, y, u, v, m, cp, re, a=0.5] ready for the force gather, and the
    (n_layout, 2) [rho, p] state-update columns."""
    qb = spec.qb
    n_blocks = spec.n_layout // qb
    kernel = functools.partial(_density_kernel, cfg=cfg, cap=spec.cap,
                               length=geo_d.shape[1])
    whole = pl.no_block_spec
    return pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((spec.n_layout, NFIELDS), jnp.float32),
            jax.ShapeDtypeStruct((spec.n_layout, 2), jnp.float32),
        ],
        grid=(n_blocks,),
        in_specs=[whole, whole,
                  pl.BlockSpec((qb, NFIELDS), lambda i: (i, 0)),
                  whole],
        out_specs=[pl.BlockSpec((qb, NFIELDS), lambda i: (i, 0)),
                   pl.BlockSpec((qb, 2), lambda i: (i, 0))],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="sph_density",
    )(w_start, w_len, q_packed, geo_d)


def _forces_kernel(ws_ref, wl_ref, g_ref, q_ref, d_ref, rp_ref, geo_ref,
                   pk_ref, out_ref, *, cfg: SPHConfig, cap: int, length: int,
                   half_dt: float, damp: float):
    k = _Consts(cfg)
    b = pl.program_id(0)
    start = ws_ref[b]
    qcol = lambda j: q_ref[:, j][:, None]
    # per-query rho/cp from the density pass's geo8 rows: rho = 2*re is
    # exact (an f32 halving and doubling of a non-denormal value)
    q = (qcol(X), qcol(Y), qcol(U), qcol(V),
         (2.0 * d_ref[:, RE])[:, None], d_ref[:, CP][:, None])
    fills = (INERT_X, INERT_X, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def body(c, acc):
        s = start + c * CHUNK
        cand = tuple(_load_row(geo_ref, j, s, length, fills[j])[None, :]
                     for j in range(NFIELDS))
        fx, fy = _force_terms(k, q, cand)
        return acc[0] + fx, acc[1] + fy

    zero = jnp.zeros((q_ref.shape[0], CHUNK), jnp.float32)
    ax, ay = jax.lax.fori_loop(0, _n_chunks(wl_ref[b], cap), body,
                               (zero, zero))
    g = (g_ref[0], g_ref[1])
    au, av, u2, v2 = _kick(k, g, q_ref[:, M], jnp.sum(ax, axis=1),
                           jnp.sum(ay, axis=1), q_ref[:, U], q_ref[:, V],
                           half_dt, damp)
    # the finished next state [x, y, u2, v2, m, rho, p, id]
    pk_ref[...] = _with_cols(q_ref[...], {
        U: u2, V: v2, 5: rp_ref[:, 0], 6: rp_ref[:, 1]})
    out_ref[...] = _with_cols(jnp.zeros(out_ref.shape, jnp.float32),
                              {0: au, 1: av})


def forces_window_call(q_packed, geo8, rp, geo_f, w_start, w_len, g,
                       cfg: SPHConfig, spec: TripleSpec,
                       half_dt: float = 0.0, damp: float = 1.0,
                       interpret: bool = False):
    """``geo8``/``rp`` are the density pass's outputs — the kernel reads
    per-query cp/re from geo8 and rho/p from rp.  Returns (pk_next, acc):
    the finished packed state after the trailing half-kick (u2 =
    (u + half_dt*au)*damp; the defaults reproduce the priming pass, u
    unchanged) and the accelerations for the next tick's leading kick."""
    qb = spec.qb
    n_blocks = spec.n_layout // qb
    kernel = functools.partial(_forces_kernel, cfg=cfg, cap=spec.cap,
                               length=geo_f.shape[1], half_dt=float(half_dt),
                               damp=float(damp))
    whole = pl.no_block_spec
    rows8 = pl.BlockSpec((qb, NFIELDS), lambda i: (i, 0))
    rows2 = pl.BlockSpec((qb, 2), lambda i: (i, 0))
    return pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((spec.n_layout, NFIELDS), jnp.float32),
            jax.ShapeDtypeStruct((spec.n_layout, 2), jnp.float32),
        ],
        grid=(n_blocks,),
        in_specs=[whole, whole, whole, rows8, rows8, rows2, whole],
        out_specs=[rows8, rows2],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="sph_forces",
    )(w_start, w_len, jnp.asarray(g, jnp.float32).reshape(2),
      q_packed, geo8, rp, geo_f)


# ---------------------------------------------------------------------------
# plain jax.numpy reference (same layout and arguments)
# ---------------------------------------------------------------------------


def _windows(cand, w_start, cap, fills):
    """(k, L) candidate rows -> k arrays (n_blocks, 1, cap): each block's
    window from its start, lanes past the array end replaced by ``fills``."""
    n_rows, length = cand.shape
    idx = w_start.reshape(-1, 1) + jnp.arange(cap, dtype=jnp.int32)
    ok = idx < length
    idx = jnp.minimum(idx, length - 1)
    return tuple(jnp.where(ok, cand[j][idx], fills[j])[:, None, :]
                 for j in range(n_rows))


def density_plain(q_packed, geo_d, w_start, w_len, cfg: SPHConfig,
                  spec: TripleSpec):
    """``density_window_call`` in plain jax.numpy (all ``cap`` lanes)."""
    del w_len
    k = _Consts(cfg)
    nb, qb = spec.n_layout // spec.qb, spec.qb
    cx, cy, cm, _ = _windows(geo_d, w_start, spec.cap,
                             (INERT_X, INERT_X, 0.0, 0.0))
    qx = q_packed[:, X].reshape(nb, qb, 1)
    qy = q_packed[:, Y].reshape(nb, qb, 1)
    rho = k.norm * jnp.sum(_density_terms(k, qx, qy, cx, cy, cm),
                           axis=2).reshape(-1)
    p, cpress = _eos(k, rho)
    geo8 = _with_cols(q_packed, {CP: cpress, RE: 0.5 * rho,
                                 A: jnp.full_like(rho, 0.5)})
    return geo8, jnp.stack([rho, p], axis=1)


def forces_plain(q_packed, geo8, rp, geo_f, w_start, w_len, g,
                 cfg: SPHConfig, spec: TripleSpec, half_dt: float = 0.0,
                 damp: float = 1.0):
    """``forces_window_call`` in plain jax.numpy (all ``cap`` lanes)."""
    del w_len
    k = _Consts(cfg)
    nb, qb = spec.n_layout // spec.qb, spec.qb
    fills = (INERT_X, INERT_X, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    cand = _windows(geo_f, w_start, spec.cap, fills)
    col = lambda a: a.reshape(nb, qb, 1)
    q = (col(q_packed[:, X]), col(q_packed[:, Y]), col(q_packed[:, U]),
         col(q_packed[:, V]), col(2.0 * geo8[:, RE]), col(geo8[:, CP]))
    fx, fy = _force_terms(k, q, cand)
    g = jnp.asarray(g, jnp.float32)
    au, av, u2, v2 = _kick(k, (g[0], g[1]), q_packed[:, M],
                           jnp.sum(fx, axis=2).reshape(-1),
                           jnp.sum(fy, axis=2).reshape(-1),
                           q_packed[:, U], q_packed[:, V], half_dt, damp)
    pk = _with_cols(q_packed, {U: u2, V: v2, 5: rp[:, 0], 6: rp[:, 1]})
    return pk, jnp.stack([au, av], axis=1)
