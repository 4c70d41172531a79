"""Row-triple merged candidate layout — the pair passes' data structure.

**Why.**  A candidate window shared by many queries of different cells
computes far more pair lanes than the true 3x3-cell stencil
(`pi_sph_fluid.c:136-141`) needs.  Per-query-block windows fix that, but
with the plain row layout a block's candidates are 3 disjoint spans (rows
r-1, r, r+1).

**The structure.**  Grid rows are grouped SEG_Q at a time; for each group a
*segment* holds every candidate its queries can see — all particles (fluid
AND boundary, merged) of rows [SEG_Q*s - 1, SEG_Q*(s+1)] — ordered
**column-major**: segment s = concat over columns c of [cover-row 0 fluid,
cover-row 0 boundary, cover-row 1 fluid, ...].  Consequences:

* a block of QB consecutive queries (cells [c0, c1] of one row) has exactly
  **one** contiguous candidate window: its segment's columns [c0-1, c1+1],
  read from its exact start;
* grouping SEG_Q query rows per segment trades a few distance-killed lanes
  (cover rows 2 away from a query's row) for a (SEG_Q+2)/(3*SEG_Q)x smaller
  candidate array, which is re-gathered every tick;
* the array holds only real particles (no layout pads), so window length
  tracks true candidate count;
* **no per-lane masks**: a lane outside the window but inside a fetched
  chunk is a real particle >= 1 whole cell away (column direction) or >= 2
  rows away, or an inert segment pad, so the q < 2 support test kills it;
  self-pairs need no exclusion (the density self-term IS the reference's
  explicit m*W(0), `pi_sph_fluid.c:274-275`; force self-terms vanish);
* segments are separated by >= CAP + 128 inert pad lanes, so a read that
  overruns a window by up to a chunk can never reach the next segment's
  duplicate copies.

**The query layout** is row-padded with *per-row* capacity quantized to QB:
row r occupies layout slots [rstart[r], rstart[r] + roundup(row_count[r],
QB)).  This keeps every QB-query block inside one row while wasting < QB
slots per row.  Row capacities can never drop particles (they round *up*
per row), so no particle can be lost by the layout.

All index structures are built from row gathers + arithmetic + one
scatter-max + cummax.

Candidate arrays seen by the pair passes:
  geo (8, L): rows 0-4 = x, y, u, v, m~ (mass | pseudo-mass); rows 5-7 =
              c_press (p_j/rho_j^2, 0 on boundary), rho_eff (rho_j/2 fluid,
              0 boundary), a_j (0.5 fluid, 1.0 boundary)
so the pair-mean viscosity denominator (q_rho+c_rho)/2 (`pi_sph_fluid.c:333`)
and the boundary's fluid-only denominator (`pi_sph_fluid.c:362`) unify as
a_j*q_rho + rho_eff_j.

Overflows are counted, never silent: window lanes beyond the block cap are
summed into ``overflow`` (must read 0 in a healthy run).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...config import SPHConfig

__all__ = ["TripleSpec", "TripleCtx", "triple_spec", "build_frame",
           "block_windows", "window_overflow", "INERT_X"]

LANE = 128  # segment-stride quantum and cap granularity (lanes)
INERT_X = -1e6  # inert slots sit far outside the domain -> q >= 2 kills them


def _round_up(x, m):
    return -(-x // m) * m


class TripleSpec(NamedTuple):
    """Static shape parameters (host-side ints)."""

    qb: int          # queries per window block (row capacities quantize to qb)
    cap: int         # candidate lanes read per block window
    seg_q: int       # query rows per candidate segment
    n_layout: int    # static query-layout length (multiple of qb)
    L: int           # static candidate-array length
    n_src: int       # gather-source rows: n_layout + nb + 1 (inert)
    n_runs: int      # static run-table length


class TripleCtx(NamedTuple):
    """Per-resort traced context.

    layout_src: (n_layout,) int32 — row of the *sorted+inert-extended* source
                feeding each layout slot (inert row for pads)
    trip_src:   (L,) int32 — gather-source row feeding each candidate slot
    w_start:    (n_layout // qb,) int32 — per-block window starts
    w_len:      (n_layout // qb,) int32 — true window lengths
    T:          (n_cells+1, 8) int32 — the per-cell window table [wlo, whi]
                (renderer frame reuse maps pixel blocks through it)
    overflow:   () int32 — window lanes beyond cap (must be 0)
    """

    layout_src: jnp.ndarray
    trip_src: jnp.ndarray
    w_start: jnp.ndarray
    w_len: jnp.ndarray
    T: jnp.ndarray
    overflow: jnp.ndarray


def triple_spec(cfg: SPHConfig, n_real: int, nb: int, qb: int = 16,
                cap: int = 256, seg_q: int = 3) -> TripleSpec:
    assert cap % LANE == 0
    n_rows = cfg.n_cell_rows
    n_seg = -(-n_rows // seg_q)
    n_layout = _round_up(n_real + qb * n_rows, qb)
    # a row r is covered by segments s with s*seg_q-1 <= r <= s*seg_q+seg_q,
    # i.e. at most 2 segments for seg_q >= 2 (3 for seg_q = 1), so the real
    # candidate total is <= copies*(n+nb); plus per-segment guard strides.
    # Each segment's stride is LANE-rounded (build_frame), adding up to
    # LANE-1 lanes per segment beyond seg_len + cap + 2*LANE — budget a
    # full LANE per segment for it (3*LANE, not 2*LANE), else an unlucky
    # row distribution overruns L and late windows index garbage.
    copies = 3 if seg_q == 1 else 2
    L = _round_up(copies * (n_real + nb) + n_seg * (cap + 3 * LANE) + 2 * LANE, LANE)
    n_runs = n_seg * (cfg.n_cell_cols * (seg_q + 2) * 2 + 1)
    n_src = n_layout + nb + 1
    return TripleSpec(qb=qb, cap=cap, seg_q=seg_q, n_layout=n_layout,
                      L=L, n_src=n_src, n_runs=n_runs)


def build_frame(
    spec: TripleSpec,
    cfg: SPHConfig,
    cell_starts: jnp.ndarray,     # (n_cells+2,) fluid CSR over *sorted* slots
    b_cell_starts: jnp.ndarray,   # (n_cells+1,) boundary CSR (static)
) -> tuple:
    """Everything derivable from the CSRs alone: the per-row query layout
    and the candidate-array construction (trip_src).  Returns
    (layout_src, trip_src, T) where T is the (n_cells+1, 8) per-cell
    window table [wlo, whi, ...]."""
    m = cfg.n_cell_cols
    n_rows = cfg.n_cell_rows
    n_cells = cfg.n_cells
    qb, cap, seg_q = spec.qb, spec.cap, spec.seg_q
    n_seg = -(-n_rows // seg_q)
    cover = seg_q + 2

    # ---- per-cell count grids --------------------------------------------
    fcnt = (cell_starts[1:n_cells + 1] - cell_starts[:n_cells]).reshape(n_rows, m)
    bcnt = (b_cell_starts[1:n_cells + 1] - b_cell_starts[:n_cells]).reshape(n_rows, m)
    cnt_all = fcnt + bcnt
    row_count = jnp.sum(fcnt, axis=1)                       # (n_rows,)
    row_start_sorted = cell_starts[jnp.arange(n_rows) * m]  # (n_rows,)

    # ---- query layout: per-row capacity quantized to qb -------------------
    rowcap = _round_up(row_count, qb)
    rstart = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(rowcap, dtype=jnp.int32)])
    t_layout = jnp.arange(spec.n_layout, dtype=jnp.int32)
    # out-of-range starts (trailing empty rows at rstart == n_layout) must
    # be DROPPED, not clamped: a clamped write would claim the last slot
    seed = jnp.zeros((spec.n_layout,), jnp.int32).at[rstart[:n_rows]].max(
        jnp.arange(n_rows, dtype=jnp.int32), mode="drop")
    row_of = jax.lax.cummax(seed)                           # (n_layout,)
    R = jnp.stack([row_start_sorted, rstart[:n_rows], row_count,
                   jnp.arange(n_rows, dtype=jnp.int32)], axis=1)
    R = jnp.pad(R, ((0, 1), (0, 4)))                        # (n_rows+1, 8)
    Rr = R[row_of]
    k_row = t_layout - Rr[:, 1]
    layout_valid = k_row < Rr[:, 2]
    # invalid slots gather the inert row appended at sorted index n_layout
    layout_src = jnp.where(layout_valid,
                           jnp.minimum(Rr[:, 0] + k_row, spec.n_layout - 1),
                           spec.n_layout)

    # ---- candidate segments ----------------------------------------------
    # cumulative rows: P[r] = sum_{r'<r} cnt_all[r']  (per column)
    P = jnp.concatenate([jnp.zeros((1, m), jnp.int32),
                         jnp.cumsum(cnt_all, axis=0, dtype=jnp.int32)])
    s_ids = jnp.arange(n_seg, dtype=jnp.int32)
    lo_row = jnp.maximum(s_ids * seg_q - 1, 0)              # first covered row
    hi_row = jnp.minimum((s_ids + 1) * seg_q, n_rows - 1)   # last covered row
    segcnt = P[hi_row + 1] - P[lo_row]                      # (n_seg, m)
    seg_len = jnp.sum(segcnt, axis=1)
    seg_stride = ((seg_len + cap + 2 * LANE - 1) // LANE) * LANE
    seg_start = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                 jnp.cumsum(seg_stride, dtype=jnp.int32)[:-1]])
    tcol_start = seg_start[:, None] + (jnp.cumsum(segcnt, axis=1, dtype=jnp.int32) - segcnt)

    # ---- per-cell window table T -----------------------------------------
    # column +-1 shifts are pure slices: every lookup here is a whole-row
    # gather or a slice
    seg_of_row = jnp.arange(n_rows, dtype=jnp.int32) // seg_q
    tcs_r = tcol_start[seg_of_row]                          # (n_rows, m)
    tce_r = tcs_r + segcnt[seg_of_row]
    wlo = jnp.concatenate([tcs_r[:, :1], tcs_r[:, :-1]], axis=1)
    whi = jnp.concatenate([tce_r[:, 1:], tce_r[:, -1:]], axis=1)
    T = jnp.stack([wlo, whi], axis=-1).reshape(n_cells, 2)
    T = jnp.concatenate([T, jnp.zeros((n_cells, 6), jnp.int32)], axis=1)
    # runtime guard against the static L budget (belt to triple_spec's
    # braces): total candidate length must fit in L.  The excess rides in
    # the spare column 2 of T's trailing row (whose cols 0-1 are the
    # empty-block window lookup) and is folded into the overflow counter
    # by block_windows — a budget overrun is counted, never silent.
    total_len = seg_start[-1] + seg_stride[-1]
    excess = jnp.maximum(total_len - spec.L, 0)
    guard_row = jnp.zeros((1, 8), jnp.int32).at[0, 2].set(excess)
    T = jnp.concatenate([T, guard_row], axis=0)

    # ---- run table: trip_src via scatter-max + cummax + one row gather ----
    # runs per segment: m columns x cover rows x {fluid, boundary}, then one
    # pad run; construction order == slot order.  All per-run quantities are
    # built as (n_seg, cover*2, m) whole-row gathers of (n_rows, m) grids,
    # then transposed — never per-element gathers.
    j_ids = jnp.arange(cover * 2)
    rt2 = lo_row[:, None] + (j_ids // 2)[None, :]              # (n_seg, cover*2)
    rt2_ok = rt2 <= hi_row[:, None]
    rt2_c = jnp.minimum(rt2, n_rows - 1)
    is_b2 = ((j_ids % 2) == 1)[None, :]
    cs_grid = cell_starts[:n_cells].reshape(n_rows, m)
    bcs_grid = b_cell_starts[:n_cells].reshape(n_rows, m)
    F = fcnt[rt2_c]                                            # (n_seg, cover*2, m)
    Bc = bcnt[rt2_c]
    CS = cs_grid[rt2_c]
    BCS = bcs_grid[rt2_c]
    lens3 = jnp.where(rt2_ok[:, :, None], jnp.where(is_b2[:, :, None], Bc, F), 0)
    src0_f3 = (rstart[:n_rows][rt2_c] - row_start_sorted[rt2_c])[:, :, None] + CS
    src0_b3 = spec.n_layout + BCS
    src03 = jnp.where(is_b2[:, :, None], src0_b3, src0_f3)
    lens = jnp.swapaxes(lens3, 1, 2)                           # (n_seg, m, cover*2)
    src0 = jnp.swapaxes(src03, 1, 2)
    # slot0: tripcol base + exclusive prefix of lens within the tripcol
    pref = jnp.cumsum(lens, axis=2, dtype=jnp.int32) - lens
    slot0 = tcol_start[:, :, None] + pref
    delta = jnp.where(lens > 0, src0 - slot0, (1 << 29))       # empty: inert via clamp
    # pad run per segment (covers guard lanes to the next segment start)
    pad_slot0 = (seg_start + seg_len)[:, None]
    pad_delta = jnp.full((n_seg, 1), 1 << 29, jnp.int32)
    slot0 = jnp.concatenate([slot0.reshape(n_seg, -1), pad_slot0], axis=1).reshape(-1)
    delta = jnp.concatenate([delta.reshape(n_seg, -1), pad_delta], axis=1).reshape(-1)

    run_ids = jnp.arange(spec.n_runs, dtype=jnp.int32)
    seed_r = jnp.zeros((spec.L,), jnp.int32).at[slot0].max(run_ids, mode="drop")
    run_of = jax.lax.cummax(seed_r)
    D = jnp.stack([delta] + [jnp.zeros_like(delta)] * 7, axis=1)  # (n_runs, 8)
    t_trip = jnp.arange(spec.L, dtype=jnp.int32)
    trip_src = jnp.minimum(t_trip + D[run_of][:, 0], spec.n_src - 1)

    return layout_src, trip_src, T


def block_windows(spec: TripleSpec, cfg: SPHConfig, cells: jnp.ndarray,
                  T: jnp.ndarray):
    """Per-block candidate windows from layout-order cell ids.

    Blocks never straddle rows (row capacities are qb-quantized), and cells
    are non-decreasing within a row, so a block's query cells are
    [cells[first], max over valid slots].  Returns (w_start, w_len,
    overflow); each window is read from its exact start.
    """
    n_cells = cfg.n_cells
    cells_b = cells.reshape(-1, spec.qb)
    valid_b = cells_b < n_cells
    c_first = cells_b[:, 0]
    c_last = jnp.max(jnp.where(valid_b, cells_b, -1), axis=1)
    has_q = c_last >= 0
    T_lo = T[jnp.where(has_q, c_first, n_cells)]
    T_hi = T[jnp.where(has_q, c_last, n_cells)]
    w_start = jnp.where(has_q, T_lo[:, 0], 0).astype(jnp.int32)
    w_len = jnp.where(has_q, T_hi[:, 1] - T_lo[:, 0], 0).astype(jnp.int32)
    return w_start, w_len, window_overflow(T, w_len, spec.cap, n_cells)


def window_overflow(T, w_len, cap: int, n_cells: int):
    """Window lanes beyond ``cap`` plus the L-budget guard build_frame
    stashes at T[n_cells, 2] (weighted x1e6, like row-capacity losses, so a
    budget overrun is unmistakable in stats).

    Saturating sum: under a catastrophic state (NaN positions -> garbage
    cells -> huge window diffs) a plain int32 sum wraps NEGATIVE and the
    stat becomes unreadable; accumulate in f32 and clamp so the counter
    stays a large positive scream."""
    raw = jnp.sum(jnp.maximum(w_len - cap, 0).astype(jnp.float32))
    overflow = jnp.minimum(raw, 1e8).astype(jnp.int32)
    return overflow + jnp.minimum(T[n_cells, 2], 1000) * jnp.int32(1_000_000)
