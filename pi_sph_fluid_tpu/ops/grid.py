"""Counting-sort uniform hash grid — the accelerator-native neighbor engine.

The reference builds cell linked-lists every step (`pi_sph_fluid.c:104-124`):
a serial O(N) pass threading unsigned-short next-pointers through the particle
array.  A linked list is inherently sequential and un-vectorisable, so the
accelerator design replaces it with a **counting sort** (SURVEY.md §2 #4):

1. compute each particle's cell id (row-major over the 2H x 2H grid),
2. stable-sort particle indices by cell id (XLA radix sort),
3. CSR cell offsets via histogram + cumsum.

The payoff of row-major cell ordering: a query's 3x3 cell stencil
(`pi_sph_fluid.c:136-141`) becomes **three contiguous spans** of the sorted
particle array (one per cell row).  Contiguous spans are what both vectorised
gathers and Pallas DMA want — no per-cell pointer chasing anywhere.

Everything is shape-static: spans are gathered at a fixed capacity with
validity masks, the grid shape is a compile-time constant from the config.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import SPHConfig

__all__ = ["GridContext", "cell_coords", "cell_ids", "build_grid", "row_spans"]


class GridContext(NamedTuple):
    """Sorted-grid view of one particle set.

    order:        (N,)  original index of each sorted slot (apply to state
                  arrays to put them in grid order)
    sorted_cells: (N,)  cell id per sorted slot (non-decreasing)
    cell_starts:  (n_cells+1,) CSR offsets; particles of cell c occupy sorted
                  slots [cell_starts[c], cell_starts[c+1])
    """

    order: jnp.ndarray
    sorted_cells: jnp.ndarray
    cell_starts: jnp.ndarray


def cell_coords(x, y, cfg: SPHConfig):
    """(row, col) integer cell coordinates, clamped into the grid.

    The reference truncates without clamping (`pi_sph_fluid.c:111-112`) and
    relies on particles staying in-domain; clamping keeps out-of-domain
    particles (transiently possible at high velocity) in the edge cells
    instead of out-of-bounds.
    """
    inv = jnp.float32(1.0) / jnp.float32(cfg.cell_length)
    ci = jnp.floor(y * inv).astype(jnp.int32)
    cj = jnp.floor(x * inv).astype(jnp.int32)
    ci = jnp.clip(ci, 0, cfg.n_cell_rows - 1)
    cj = jnp.clip(cj, 0, cfg.n_cell_cols - 1)
    return ci, cj


def cell_ids(x, y, cfg: SPHConfig):
    """Row-major cell id, `ij_cell = i_cell * m_cells + j_cell`
    (`pi_sph_fluid.c:113`)."""
    ci, cj = cell_coords(x, y, cfg)
    return ci * cfg.n_cell_cols + cj


def build_grid(x, y, cfg: SPHConfig) -> GridContext:
    """Counting-sort the particle set by cell id.

    Replaces `update_neighbors_context` (`pi_sph_fluid.c:104-124`).  The sort
    is stable, so equal-cell particles keep their relative order and the
    whole pipeline is deterministic.
    """
    ids = cell_ids(x, y, cfg)
    order = jnp.argsort(ids, stable=True).astype(jnp.int32)
    sorted_cells = ids[order]
    counts = jnp.zeros(cfg.n_cells + 1, jnp.int32).at[ids + 1].add(1)
    cell_starts = jnp.cumsum(counts, dtype=jnp.int32)
    return GridContext(order=order, sorted_cells=sorted_cells, cell_starts=cell_starts)


def row_spans(qx, qy, grid: GridContext, cfg: SPHConfig):
    """For each query point, the 3 contiguous sorted-array spans holding all
    candidate neighbors (the 3x3 stencil of `pi_sph_fluid.c:136-141`, one span
    per cell row).

    Returns (starts, ends), each (Nq, 3) int32 into the *sorted* target
    arrays.  Invalid rows (off the grid) produce empty spans (start == end).
    """
    ci, cj = cell_coords(qx, qy, cfg)
    m = cfg.n_cell_cols
    col_lo = jnp.maximum(cj - 1, 0)
    col_hi = jnp.minimum(cj + 1, m - 1)

    rows = ci[:, None] + jnp.asarray([-1, 0, 1], jnp.int32)[None, :]   # (Nq, 3)
    row_ok = (rows >= 0) & (rows < cfg.n_cell_rows)
    rows_c = jnp.clip(rows, 0, cfg.n_cell_rows - 1)

    first_cell = rows_c * m + col_lo[:, None]
    last_cell = rows_c * m + col_hi[:, None]
    starts = grid.cell_starts[first_cell]
    ends = grid.cell_starts[last_cell + 1]
    starts = jnp.where(row_ok, starts, 0)
    ends = jnp.where(row_ok, ends, 0)
    return starts, ends
