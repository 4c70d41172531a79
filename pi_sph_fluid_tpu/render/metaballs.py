"""On-device Blinn metaball renderer -> SSD1306 page-packed framebuffer.

Implements `draw_metaballs` (`pi_sph_fluid.c:380-411`) on device while
keeping the reference's one clever abstraction: **pixels are particles**
(`pi_sph_fluid.c:567-577`) — pixel centers query the same counting-sort grid
as the physics, so one neighbor engine serves both (SURVEY.md §3.3).

Per pixel: field = sum_j W(pixel, fluid_j) / W(px_width/2), lit when >= 1.
The C early-exit at >= 1 (`pi_sph_fluid.c:403`) is a serial optimisation
only — W is non-negative inside the support, so the full masked sum crosses
1 iff any prefix does; the lit decision is identical.

Output layout matches the SSD1306 page format exactly
(`pi_sph_fluid.c:407-408`): byte (i/8)*cols + j holds bit i%8, 1024 bytes
at 64x128.  The packed buffer is produced on device; the host only fetches
bytes to blit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import SPHConfig
from ..core.kernels import kernel_w, kernel_w_scalar
from ..models.scene import pixel_centers
from ..ops.grid import build_grid
from ..ops.neighbors import gather_candidates

__all__ = ["make_renderer", "metaball_field", "pack_framebuffer", "unpack_framebuffer"]


def metaball_field(px, py, fx, fy, grid, cfg: SPHConfig, cap: int | None = None):
    """Raw metaball field per pixel (>= 1 means lit)."""
    # max possible distance from a pixel center that still counts as "inside"
    px_width = np.float32(cfg.width) / np.float32(128.0)
    w_ref = kernel_w_scalar(np.float32(px_width) / np.float32(2.0), cfg)
    cand = gather_candidates(px, py, grid, cfg, cap=cap)
    dx = px[:, None] - fx[cand.idx]
    dy = py[:, None] - fy[cand.idx]
    w = kernel_w(dx, dy, cfg)
    return jnp.sum(jnp.where(cand.valid, w, 0.0), axis=1) / w_ref


def pack_framebuffer(lit, rows: int, cols: int):
    """(rows, cols) bool -> page-packed uint8 buffer of rows/8*cols bytes."""
    pages = rows // 8
    bits = lit.reshape(pages, 8, cols).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(8, dtype=jnp.uint32))[None, :, None]
    packed = jnp.sum(bits * weights, axis=1).astype(jnp.uint8)
    return packed.reshape(pages * cols)


def unpack_framebuffer(buf, rows: int = 64, cols: int = 128) -> np.ndarray:
    """Packed buffer -> (rows, cols) bool image (host-side, for tests/sinks)."""
    b = np.asarray(buf, np.uint8).reshape(rows // 8, cols)
    # row i lives in page i//8, bit i%8 (`pi_sph_fluid.c:407`)
    out = np.zeros((rows, cols), bool)
    for i in range(rows):
        out[i] = (b[i // 8] >> (i % 8)) & 1
    return out


def make_renderer(cfg: SPHConfig, rows: int = 64, cols: int = 128, cap: int | None = None):
    """Build ``render(fluid) -> (rows/8*cols,) uint8`` on-device.

    Accepts fluid in ANY order: the grid's candidate indices refer to
    grid-sorted positions, so positions are permuted by ``grid.order``
    before the field gather.  (For already-sorted input that permutation
    is the identity.)  Round 4 regression note: this function used to
    require pre-sorted input, and the dd host-gather display fed it
    id-ordered state — silently corrupt frames; the order is now handled
    here so no caller can repeat that."""
    px_np, py_np = pixel_centers(cfg, rows, cols)
    px = jnp.asarray(px_np)
    py = jnp.asarray(py_np)

    def render(fluid):
        grid = build_grid(fluid.x, fluid.y, cfg)
        fx = fluid.x[grid.order]
        fy = fluid.y[grid.order]
        field = metaball_field(px, py, fx, fy, grid, cfg, cap=cap)
        lit = (field >= 1.0).reshape(rows, cols)
        return pack_framebuffer(lit, rows, cols)

    return render
