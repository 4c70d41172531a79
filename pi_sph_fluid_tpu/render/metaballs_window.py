"""Window metaball renderer — the production raster path.

Same math as render/metaballs.py (field = sum_j W_ij / W(px_width/2), lit
when >= 1, `pi_sph_fluid.c:380-411`) over the engine's candidate structures:
pixel centers are *static* queries (the reference's pixels-as-particles
trick, `pi_sph_fluid.c:570-577`), laid out once at build into qb-quantized
grid-row blocks; each pixel block reads one contiguous candidate window and
accumulates unweighted Wendland sums.  The field pass runs once per
displayed frame, so it is plain jax.numpy over a (blocks, qb, cap) tile.

Pixel blocks span far more grid columns than fluid blocks (pixels are
sparser than particles at fine resolutions), so the window cap is computed
from the physical bound: block pixel extent in cells x segment cover rows
x max cell occupancy.  Window overflow is counted and returned alongside
the frame — never silent.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import SPHConfig
from ..core.kernels import kernel_w_scalar
from ..models.scene import pixel_centers
from ..ops.grid import cell_ids
from ..ops.pallas.triple import (LANE, build_frame, triple_spec,
                                 window_overflow)
from .metaballs import pack_framebuffer

__all__ = ["WindowRenderer"]

INERT_PX = -1e6


def pixel_layout(cfg: SPHConfig, px, py, qb: int):
    """Static qb-quantized per-grid-row pixel layout (host-side numpy).

    Pixels are laid out once into blocks that never straddle grid rows, so
    each block's candidate window is one contiguous span of the per-cell
    table (the same property the particle layout has, triple.py).  Returns
    a dict: ``q`` (n_layout, 8) packed queries, ``slots`` (len(px),) the
    layout slot of input pixel i, ``c_first``/``c_last``/``has_q`` per
    block, ``n_layout``.  Factored out of WindowRenderer so the dd
    renderer can build per-slab layouts in local coordinates."""
    keys = np.asarray(cell_ids(jnp.asarray(px), jnp.asarray(py), cfg))
    order = np.argsort(keys, kind="stable")
    px_s, py_s, keys_s = px[order], py[order], keys[order]
    m = cfg.n_cell_cols
    grow = keys_s // m
    n_rows_g = cfg.n_cell_rows
    row_count = np.bincount(grow, minlength=n_rows_g)
    rowcap = -(-row_count // qb) * qb
    rstart = np.concatenate([[0], np.cumsum(rowcap)])
    n_layout = int(-(-max(rstart[-1], 1) // qb) * qb)
    q = np.full((n_layout, 8), 0.0, np.float32)
    q[:, 0] = INERT_PX
    q[:, 1] = INERT_PX
    cells_px = np.full(n_layout, cfg.n_cells, np.int32)
    slots = np.zeros(len(px), np.int32)
    row_seen = np.zeros(n_rows_g, np.int64)
    for j in range(len(px_s)):
        r = grow[j]
        slot = int(rstart[r] + row_seen[r])
        row_seen[r] += 1
        q[slot, 0] = px_s[j]
        q[slot, 1] = py_s[j]
        q[slot, 4] = 1.0
        cells_px[slot] = keys_s[j]
        slots[order[j]] = slot

    nqb_total = n_layout // qb
    cb = cells_px.reshape(nqb_total, qb)
    has_q = (cb < cfg.n_cells).any(axis=1)
    c_first = np.where(has_q, cb[:, 0], cfg.n_cells)
    c_last = np.where(has_q,
                      np.max(np.where(cb < cfg.n_cells, cb, -1), axis=1),
                      cfg.n_cells)
    return dict(q=q, slots=slots, c_first=c_first.astype(np.int32),
                c_last=c_last.astype(np.int32), has_q=has_q,
                n_layout=n_layout)


def pixel_window_cap(cfg: SPHConfig, cols: int, qb: int, seg_q: int) -> int:
    """Window lane capacity for pixel-block queries: block pixel extent in
    cells x segment cover rows x max cell occupancy (physical bound)."""
    px_pitch = cfg.width / cols
    cells_per_blk = qb * px_pitch / cfg.cell_length + 4
    per_cell = (cfg.cell_length / cfg.r) ** 2 * 1.5
    cap = int(cells_per_blk * (seg_q + 2) * per_cell) + 2 * LANE
    return -(-cap // LANE) * LANE


def pixel_windows(T, c_first, c_last, has_q, cap, n_cells):
    """Per-pixel-block candidate windows (w_start, w_len, overflow) from the
    per-cell table T, with counted overflow (window-cap truncation plus the
    L-budget guard build_frame stashes at T[n_cells, 2])."""
    T_lo = T[c_first]
    T_hi = T[c_last]
    w_start = jnp.where(has_q, T_lo[:, 0], 0).astype(jnp.int32)
    w_len = jnp.where(has_q, T_hi[:, 1] - T_lo[:, 0], 0).astype(jnp.int32)
    return w_start, w_len, window_overflow(T, w_len, cap, n_cells)


def field_pass(cfg: SPHConfig, q_packed, cand, w_start, w_len, qb: int,
               cap: int):
    """Unnormalized metaball field of every pixel slot: for each qb-pixel
    block, the sum of [m > 0] * W_un(r) over its window's first ``cap``
    lanes.  ``cand``: (3, L) candidate rows x, y, m.  Lanes past the window
    are masked: a pixel cap can exceed the gap between segments."""
    length = cand.shape[1]
    lane = jnp.arange(cap, dtype=jnp.int32)
    idx = jnp.minimum(w_start[:, None] + lane, length - 1)
    live = (lane < w_len[:, None]) & (cand[2][idx] > 0.0)
    cx = cand[0][idx][:, None, :]
    cy = cand[1][idx][:, None, :]
    qx = q_packed[:, 0].reshape(-1, qb, 1)
    qy = q_packed[:, 1].reshape(-1, qb, 1)
    dx = qx - cx
    dy = qy - cy
    r = jnp.sqrt(dx * dx + dy * dy)
    h = jnp.float32(cfg.h)
    t1 = jnp.maximum(1.0 - (jnp.float32(0.5) / h) * r, 0.0)
    t1sq = t1 * t1
    # unweighted sum: pixels count particles, not mass
    w = (t1sq * t1sq) * (1.0 + (jnp.float32(2.0) / h) * r)
    return jnp.sum(jnp.where(live[:, None, :], w, 0.0), axis=2).reshape(-1)


def field_scale_of(cfg: SPHConfig) -> float:
    """Normalisation 1/W(px_width/2) of the reference's 128-col raster
    (`pi_sph_fluid.c:399-401`); degenerates to 'any particle in support
    lights the pixel' at fine resolutions where W(px/2) = 0."""
    px_width = np.float32(cfg.width) / np.float32(128.0)
    w_ref = float(kernel_w_scalar(np.float32(px_width) / np.float32(2.0), cfg))
    if w_ref <= 0.0:
        w_ref = float(np.float32(1e-30))
    return float(np.float32(cfg.kernel_norm) / np.float32(w_ref))


class WindowRenderer:
    """render(sim: PackedSim) -> page-packed uint8 framebuffer, on device."""

    def __init__(self, engine, rows: int = 64, cols: int = 128,
                 qb: int = 8, seg_q: int = 2):
        cfg = engine.cfg
        self.cfg = cfg
        self.rows, self.cols = rows, cols
        self.qb = qb
        self.field_scale = field_scale_of(cfg)

        # ---- static pixel layout: qb-quantized per-grid-row blocks --------
        px, py = pixel_centers(cfg, rows, cols)
        lay = pixel_layout(cfg, px, py, qb)
        self.q_packed = jnp.asarray(lay["q"])
        self.unsort = jnp.asarray(lay["slots"])
        self.blk_c_first = jnp.asarray(lay["c_first"])
        self.blk_c_last = jnp.asarray(lay["c_last"])
        self.blk_has_q = jnp.asarray(lay["has_q"])

        # a private candidate spec over the fluid (no boundary): the
        # renderer re-lays-out the fluid itself in field(), so it is
        # independent of the engine's layout parameters and exact for any
        # state (no layout-staleness requirement)
        self.cap = pixel_window_cap(cfg, cols, qb, seg_q)
        self.fspec = triple_spec(cfg, engine.n_real, 0, qb, self.cap, seg_q)

        # frame-reuse mode (render_from_frame): pixel windows over the
        # ENGINE's candidate structure — window cap re-derived for the
        # engine's segment cover rows
        self.reuse_cap = pixel_window_cap(cfg, cols, qb, engine.spec.seg_q)
        self.n_boundary = int(engine.b_geo.shape[0])

    def _field(self, cand, T, cap):
        """Scaled row-major pixel field and overflow over candidate rows
        ``cand`` (x, y, m) windowed through the per-cell table ``T``."""
        w_start, w_len, overflow = pixel_windows(
            T, self.blk_c_first, self.blk_c_last, self.blk_has_q, cap,
            self.cfg.n_cells)
        out = field_pass(self.cfg, self.q_packed, cand, w_start, w_len,
                         self.qb, cap)
        return out[self.unsort] * jnp.float32(self.field_scale), overflow

    # ------------------------------------------------------------------
    def field(self, sim) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(row-major pixel field, window overflow count).

        Re-lays-out the fluid from live positions (sort + frame build +
        gather, ops/pallas/triple.py) — exact for any state."""
        cfg, fspec = self.cfg, self.fspec
        packed = sim.packed
        keys = jnp.where(packed[:, 4] > 0,
                         cell_ids(packed[:, 0], packed[:, 1], cfg), cfg.n_cells)
        order = jnp.argsort(keys, stable=True).astype(jnp.int32)
        counts = jnp.zeros(cfg.n_cells + 2, jnp.int32).at[keys + 1].add(1)
        cell_starts = jnp.cumsum(counts, dtype=jnp.int32)
        bcsr0 = jnp.zeros(cfg.n_cells + 1, jnp.int32)
        layout_src, trip_src, T = build_frame(fspec, cfg, cell_starts, bcsr0)

        # sorted slim rows [x, y, m], sized to the renderer's layout
        slim = jnp.concatenate([packed[:, 0:2], packed[:, 4:5]], axis=1)[order]
        n_have = slim.shape[0]
        if n_have >= fspec.n_layout:
            slim = slim[: fspec.n_layout]   # drops only inert tail pads
        else:
            slim = jnp.pad(slim, ((0, fspec.n_layout - n_have), (0, 0)))
        inert = jnp.asarray([[INERT_PX, INERT_PX, 0.0]], jnp.float32)
        pk_r = jnp.concatenate([slim, inert], axis=0)[layout_src]
        cand = jnp.concatenate([pk_r, inert], axis=0)[trip_src].T
        return self._field(cand, T, self.cap)

    # ------------------------------------------------------------------
    def field_from_frame(self, sim, frame) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(row-major pixel field, overflow) REUSING the engine's candidate
        frame (trip_src, T from make_multi_step(return_frame=True)) instead
        of re-sorting the fluid.

        Exact when the frame is layout-fresh (resort_every=1); for sticky
        states the frame is <= resort_every-1 ticks stale, which can only
        miss particles in the outer 0.2*(resort_every-1)*H fringe of a
        pixel's support — the same bound the physics runs under.  Boundary
        candidate lanes are excluded by giving their source rows m = 0."""
        trip_src, T = frame
        packed = sim.packed
        src = jnp.concatenate(
            [jnp.concatenate([packed[:, 0:2], packed[:, 4:5]], axis=1),
             jnp.zeros((self.n_boundary + 1, 3), jnp.float32)], axis=0)
        return self._field(src[trip_src].T, T, self.reuse_cap)

    def render(self, sim) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(page-packed framebuffer, window overflow count).

        The overflow count rides along so callers can fold it into their
        stats (SimRunner adds it to neighbor_overflow) — window-cap
        truncation must never corrupt frames invisibly."""
        field, overflow = self.field(sim)
        lit = (field >= 1.0).reshape(self.rows, self.cols)
        return pack_framebuffer(lit, self.rows, self.cols), overflow

    def render_from_frame(self, sim, frame) -> tuple[jnp.ndarray, jnp.ndarray]:
        """render() over the engine's reused candidate frame (see
        field_from_frame for the exactness bound)."""
        field, overflow = self.field_from_frame(sim, frame)
        lit = (field >= 1.0).reshape(self.rows, self.cols)
        return pack_framebuffer(lit, self.rows, self.cols), overflow
