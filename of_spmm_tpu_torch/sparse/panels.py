"""Panel-engine SpMM plan: dense adjacency-mask groups over a staged window.

The port of the JAX package's sparse/panels.py. ``build_panels_plan``
gives, on the same CSR, plan arrays equal to the JAX package's (the
tests hold them array for array), so the Hopper kernel
(ops/cuda/panels.py, csrc/panels.cu) runs the same plan as the TPU
kernel.

The plan cuts the output into 128-row tiles. For each tile it lays out a
window of X rows in three regions:

- hot rows: the most-referenced columns, shared by every tile;
- the current range: RC contiguous X rows, kept across tiles while it
  still covers most of a tile's columns;
- the tile's scattered rows: its remaining columns, in a shuffled order
  (staged from a linear take table, ``stage_take``), then any direct rows.

Each tile's edges become groups, one per 128-row window block it touches;
a group's (4, 128) int32 bitmask has bit (w % 32) of word (w // 32) in
column r set iff window row w of the block adds into tile row r. A step
of the control stream (``ctrl``) computes G group slots of one tile and
stages the rows of later tiles and ranges.

The control stream says where rows are copied, not where a compute step's
window rows came from. ``attach_windows`` replays it once on the host and
records that provenance as port-only arrays (``PanelWindows``) beside the
plan, so the Hopper kernel resolves each window row to its X row itself
and needs no take table. The plan's own arrays stay as the JAX package
builds them.

Values must factor rank-1 (vals[e] = r[row[e]] * c[col[e]]): X is scaled
by ``col_scale`` and Y by ``row_scale``. ``per_edge=True`` is the general
mode: every edge gets its own scattered row, scaled by its value
(``stage_scale``).

Reference semantics: gather x segment-sum
(oneflow/user/ops/gather_op.cpp:51-82,
oneflow/user/kernels/unsorted_segment_sum_kernel_util.cu:52-151).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.fused import (
    _L, _BIG_T_NNZ, DEFAULT_T, choose_hot, coalesce_duplicates,
    factor_rank1)
from of_spmm_tpu_torch.sparse.ranges import _best_window, RMAX_CAP

DEFAULT_R = 128
DEFAULT_RANGE_CAP = 24576   # rows per range window
DEFAULT_S_CAP = 8192        # scattered rows per tile piece (per parity)
DEFAULT_SEG_STEPS = 16384
DEFAULT_RQ = 1024           # rows per range-copy chunk
DEFAULT_HOT_BUDGET = None   # adaptive (see below); pass an int to force
DEFAULT_HOT_MIN_RUN = 4     # keep hot blocks while lanes/tile/blk >= this
_HOT_BIG = 16384            # hot rows for graphs with many tiles
_HOT_SMALL = 4096           # and for few-tile graphs
_HOT_TILES = 8192           # tile-count threshold between the two
DEFAULT_MIN_BLOCK = 24      # demote range blocks with fewer edges per
#                             tile to the scattered path
SCQ = 1024                  # big scattered-copy chunk (rows)
TQ = 128                    # tail chunk + table/window alignment (rows)
BMAX = 4                    # big chunks per step
TMAX = 7                    # tail chunks per step (= SCQ/TQ - 1)
DMAX = 32                   # direct-row copies per step: single X rows
#                             the TPU kernel fetched itself
DEFAULT_DIRECT_QUOTA = 0    # direct rows off by default (as in the JAX
#                             package)
_KEEP_FRAC = 0.90
_BIG_T_PANELS = 8192        # lanes per step for graphs >= _BIG_T_NNZ
UNIT_EDGES = 8192           # mask bits per work unit of the kernel (port
#                             only; chip_smoke.py's panel phases time
#                             2,048-65,536 on the H100)

# ctrl words (sparse/panels.py of the JAX package documents all 19)
C_TILE, C_GCNT = 0, 1
C_SSRC, C_SBIG, C_RCNT, C_SDST, C_STAIL = 2, 3, 4, 5, 7
C_RFIRST, C_RREAD, C_SREAD, C_SEXT, C_TFIRST = 10, 11, 13, 14, 15
C_DCNT, C_DDST = 16, 18


@dataclasses.dataclass(frozen=True)
class PanelWindows:
    """Where each compute step's window rows come from (port only).

    Derived by ``attach_windows`` from one segment's control stream; the
    kernel and its plain version resolve window row w of a step through
    it (sparse/panels.py ``resolve_window_rows``):

    - hot row j: ``hot_ids[j]``;
    - range row p: ``range_rows[step_win[s, 0], p // RQ] + p % RQ``, the
      X row at which ``rcopy`` started that RQ-row chunk (-1: never
      copied);
    - scattered row q < P: ``stage_take[step_win[s, 1] + q]`` (times
      ``stage_scale`` there in per-edge mode), with P = ``step_win[s, 2]``;
    - scattered row P <= q < P + D: ``direct_rows[step_win[s, 3] + q - P]``
      with D = ``step_win[s, 4]``.

    ``tile_steps[t]:tile_steps[t+1]`` are the compute steps of the
    segment's tile t (a tile's pieces are consecutive in the stream).

    The kernel's work list (``work_units``): ``unit_slots`` are the group
    slots (step * G + g) that hold at least one mask bit, in step order;
    unit u covers ``unit_slots[units[u, 1]:units[u, 2]]``, all of one
    tile, ``units[u, 0]`` (``~tile`` when the tile is cut into several
    units, whose partial sums the kernel adds; ``split_tiles`` lists
    those tiles). Units are ordered heaviest first; a tile without edges
    has one empty unit, which writes its zero rows.
    """

    tile_steps: np.ndarray   # (n_tiles + 1,) int32
    step_win: np.ndarray     # (n_steps, 5) int32; zeros on non-compute steps
    range_rows: np.ndarray   # (n_windows, RC // RQ) int32
    direct_rows: np.ndarray  # (n_direct_rows,) int32
    unit_slots: np.ndarray   # (n_live_slots,) int32
    units: np.ndarray        # (n_units, 3) int32 [tile or ~tile, first, end]
    split_tiles: np.ndarray  # (n_split,) int32


@dataclasses.dataclass(frozen=True)
class PanelSegment:
    """One kernel launch worth of steps (contiguous output tiles)."""

    ctrl: np.ndarray      # (steps, 1, 24) int32 per-step control words:
    #  [0] compute tile id (block index into segment output; -1 = none)
    #  [1] real (non-padded) group count this step PLUS ONE (0 = run every
    #      slot). Padded group slots sit at the tail of each tile's list
    #  [2] scattered copy src base row (into this segment's table)
    #  [3] scattered big-chunk count this step (SCQ rows each)
    #  [4] range-copy count this step (RQ-row chunks)
    #  [5] scattered copy dst base row (parity*S_buf + progress)
    #  [6] prev-step big-chunk count
    #  [7] scattered tail-chunk count this step (TQ rows each)
    #  [8] prev-step tail-chunk count
    #  [9] zero-output flag (first step of first piece of a tile)
    #  [10] first-step-of-range flag (range scratch -> window)
    #  [11] range read parity base (= parity*RC)
    #  [12] prev-step range-copy count
    #  [13] scattered parity base for compute (= parity*S_buf)
    #  [14] scattered window extent rows (tile-first step)
    #  [15] first-step-of-tile flag
    #  [16] direct-row copy count this step (single rows from X)
    #  [17] prev-step direct-row count
    #  [18] direct-row dst base (absolute row into the scattered scratch)
    rcopy: np.ndarray     # (steps, 2, RMAX) int32 [src X row | dst row]
    dsrc: np.ndarray      # (steps, 1, DMAX) int32 direct-copy X rows
    blk: np.ndarray       # (steps, 1, G) int32 window block per group
    tile_of: np.ndarray   # (steps,) int32 out block index
    # adjacency bitmasks, (steps*G, 4, 128) int32: bit (w%32) of word
    # (w//32), column r = window row w contributes to tile row r. Plans
    # are built with the compact per-edge form below (16 bits per edge)
    # and expanded by ensure_masks (numpy on the host, one scatter-add on
    # the card at placement).
    masks: Optional[np.ndarray] = None
    mask_edges: Optional[np.ndarray] = None   # (E,) uint16 = (w<<8)|r,
    #                                           group-major order
    mask_counts: Optional[np.ndarray] = None  # (steps*G,) int32 edges
    #                                           per group slot
    stage_take: Optional[np.ndarray] = None  # (S_take,) int32 global col
    #                       ids, tile-consumption order, TQ-padded/tile
    stage_scale: Optional[np.ndarray] = None  # (S_take,) f32 per-row
    #                       scale (per-edge plans; None = rank-1)
    n_steps: int = 0
    n_tiles: int = 0
    windows: Optional[PanelWindows] = None    # port only: attach_windows


@dataclasses.dataclass(frozen=True)
class PanelPlan:
    segments: Tuple[PanelSegment, ...]
    hot_ids: np.ndarray
    row_scale: np.ndarray      # rank-1 factors
    col_scale: np.ndarray
    shape: Tuple[int, int]
    R: int
    T: int
    RC: int
    S_buf: int
    RMAX: int
    RQ: int
    n_ranges: int
    n_range_rows: int
    n_scattered: int           # total take rows (padded)
    n_groups: int
    n_direct: int = 0          # rows the TPU kernel fetched from X itself

    @property
    def n_hot(self) -> int:
        return int(self.hot_ids.shape[0])

    @property
    def per_edge(self) -> bool:
        return any(seg.stage_scale is not None for seg in self.segments)


def plan_memory_report(plan: PanelPlan, d: int = 128,
                       hbm_limit: Optional[int] = None) -> dict:
    """Device-memory model of one SpMM at width ``d`` (the JAX package's
    keys), counting what the port keeps on the card: the plan arrays
    with the expanded masks (2 KB per group slot), the window provenance
    and the kernel's work list (at most), X, and the output. The port
    builds no take table and no hot table (the kernel reads hot and
    scattered rows from X), so ``max_table_bytes`` and ``hot_bytes`` are
    0. The transient of the mask expansion at placement (int64 words) is
    not counted."""
    from of_spmm_tpu_torch.sparse.fused import (
        _BUDGET_FRACTION, _nbytes, device_hbm_bytes)

    hbm = hbm_limit or device_hbm_bytes()
    n, m = plan.shape
    plan_b = _nbytes(plan.hot_ids) + _nbytes(plan.row_scale) + \
        _nbytes(plan.col_scale)
    n_rq = plan.RC // plan.RQ
    for seg in plan.segments:
        for leaf in (seg.ctrl, seg.rcopy, seg.dsrc, seg.blk, seg.tile_of,
                     seg.stage_take, seg.stage_scale):
            if leaf is not None:
                plan_b += _nbytes(leaf)
        n_slots = (int(seg.masks.shape[0]) if seg.masks is not None
                   else int(seg.mask_counts.shape[0]))
        plan_b += n_slots * 4 * _L * 4
        # provenance: tile_steps, step_win, one range window per
        # first-of-range step, the direct rows
        ctrl = np.asarray(seg.ctrl)
        n_win = int(((ctrl[:, 0, C_TILE] >= 0) & (ctrl[:, 0, C_RFIRST] == 1)).sum())
        plan_b += 4 * ((seg.n_tiles + 1) + 5 * seg.n_steps + n_win * n_rq
                       + int(np.asarray(ctrl[:, 0, C_DCNT]).sum()))
        # the work list: each slot with bits, and (3 words each) at most one
        # unit per such slot and one per tile
        live = (int(np.count_nonzero(np.asarray(seg.mask_counts)))
                if seg.mask_counts is not None else n_slots)
        plan_b += 4 * (live + 3 * (live + seg.n_tiles))
    x_b = m * d * 4
    out_b = n * d * 4
    peak = plan_b + x_b + out_b
    budget = int(_BUDGET_FRACTION * hbm)
    return {
        "plan_bytes": plan_b, "x_bytes": x_b, "out_bytes": out_b,
        "hot_bytes": 0, "max_table_bytes": 0,
        "peak_bytes": peak, "hbm_bytes": hbm, "budget_bytes": budget,
        "fits": peak <= budget,
    }


def _dense_groups(win_pos: np.ndarray, rows: np.ndarray):
    """Compact dense-mask groups for one tile piece: (edges (E,) uint16 =
    (w << 8) | r in group-major order, counts (n_g,) int32, blk_of
    (n_g,) int32). One group per distinct 128-row window block; window
    row w selects into tile row r."""
    if win_pos.shape[0] == 0:
        return (np.zeros(0, np.uint16), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    blk = win_pos // _L
    bit = win_pos - blk * _L
    u_blk, inv = np.unique(blk, return_inverse=True)
    n_g = u_blk.shape[0]
    order = np.argsort(inv, kind="stable")
    edges = ((bit[order] << 8) | rows[order]).astype(np.uint16)
    counts = np.bincount(inv, minlength=n_g).astype(np.int32)
    return edges, counts, u_blk.astype(np.int32)


def _expand_masks_np(edges: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(n_slots, 4, 128) int32 bitmasks from compact edges (host).

    Distinct (row, col) edges map to distinct bits, so a carry-free
    bincount sum builds the words."""
    n_slots = counts.shape[0]
    if n_slots == 0:
        return np.zeros((0, 4, _L), np.int32)
    gid = np.repeat(np.arange(n_slots, dtype=np.int64),
                    counts.astype(np.int64))
    e = edges.astype(np.int64)
    w = e >> 8
    r = e & 255
    flat = gid * (4 * _L) + (w >> 5) * _L + r
    buf = np.bincount(flat, weights=(1 << (w & 31)).astype(np.float64),
                      minlength=n_slots * 4 * _L)
    return (buf.astype(np.int64).astype(np.uint32).view(np.int32)
            .reshape(n_slots, 4, _L))


_COMPACT_SLOTS = 1024  # slots compact_masks unpacks at once: 16 MB of bits


def compact_masks(masks: np.ndarray):
    """The inverse of the expansion: dense (n_slots, 4, 128) int32 bitmasks
    as compact edges ((E,) uint16 = (w << 8) | r, slot by slot) and the
    per-slot edge counts ((n_slots,) int32). Row-partitioned plans stack
    their shards' dense masks (parallel/partition.py); placing a shard's
    plan turns them back into edges for attach_windows."""
    masks = np.ascontiguousarray(masks, np.int32)
    n_slots = masks.shape[0]
    counts = np.zeros(n_slots, np.int32)
    edges = [np.zeros(0, np.uint16)]
    for s0 in range(0, n_slots, _COMPACT_SLOTS):
        words = masks[s0:s0 + _COMPACT_SLOTS]
        bits = np.unpackbits(words.view(np.uint8).reshape(words.shape + (4,)), axis=-1,
                             bitorder="little")  # (s, 4, 128, 32): bit b of word k
        s, k, r, b = np.nonzero(bits)
        edges.append((((k * 32 + b) << 8) | r).astype(np.uint16))
        counts[s0:s0 + words.shape[0]] = np.bincount(s, minlength=words.shape[0])
    return np.concatenate(edges), counts


def _expand_masks_torch(edges: np.ndarray, counts: np.ndarray, device):
    """The same expansion as one scatter-add on ``device``: the compact
    edges (2 B each) cross to the card instead of the dense words (2 KB
    per slot). Distinct bits make the int64 sum carry-free; it is then
    wrapped into int32."""
    n_slots = int(counts.shape[0])
    if n_slots == 0:
        return torch.zeros((0, 4, _L), dtype=torch.int32, device=device)
    cnt = torch.as_tensor(np.asarray(counts), device=device).long()
    gid = torch.repeat_interleave(
        torch.arange(n_slots, device=device), cnt,
        output_size=int(edges.shape[0]))
    e = torch.as_tensor(np.asarray(edges).astype(np.int32), device=device).long()
    w = e >> 8
    flat = gid * (4 * _L) + (w >> 5) * _L + (e & 255)
    buf = torch.zeros(n_slots * 4 * _L, dtype=torch.int64, device=device)
    buf.index_add_(0, flat, torch.ones_like(flat) << (w & 31))
    buf -= (buf >> 31) << 32   # [0, 2^32) -> [-2^31, 2^31)
    return buf.to(torch.int32).reshape(n_slots, 4, _L)


def ensure_masks(plan: PanelPlan, device=None) -> PanelPlan:
    """Expand compact mask edges into the kernel's dense bitmasks.

    ``device=None`` expands with numpy on the host; a torch device expands
    with one scatter-add there (placement), and the masks come back as a
    torch tensor on that device."""
    if all(seg.masks is not None for seg in plan.segments):
        return plan
    segs = []
    for seg in plan.segments:
        if seg.masks is not None:
            segs.append(seg)
            continue
        if device is not None:
            masks = _expand_masks_torch(seg.mask_edges, seg.mask_counts, device)
        else:
            masks = _expand_masks_np(np.asarray(seg.mask_edges),
                                     np.asarray(seg.mask_counts))
        segs.append(dataclasses.replace(seg, masks=masks,
                                        mask_edges=None,
                                        mask_counts=None))
    return dataclasses.replace(plan, segments=tuple(segs))


def default_panels_t(nnz: int, n_rows: int) -> int:
    """Adaptive lanes-per-step T for the panel engine, as the JAX package
    picks it: T=8192 for graphs of >= 8M nnz, T=2048 for graphs of >= 1024
    tiles, else T=1024. Tiles are counted in 128-row units whatever the
    plan's R (a quirk kept so that the plans stay equal)."""
    n_tiles = max(-(-n_rows // _L), 1)
    if nnz >= _BIG_T_NNZ:
        return _BIG_T_PANELS
    if n_tiles >= 1024:
        return 2048
    return DEFAULT_T


def build_panels_plan(
    csr: CSR,
    R: int = DEFAULT_R,
    T: Optional[int] = None,
    hot_budget: Optional[int] = DEFAULT_HOT_BUDGET,
    hot_min_run: int = DEFAULT_HOT_MIN_RUN,
    seg_steps: int = DEFAULT_SEG_STEPS,
    range_cap: int = DEFAULT_RANGE_CAP,
    s_cap: int = DEFAULT_S_CAP,
    rq: int = DEFAULT_RQ,
    min_block: int = DEFAULT_MIN_BLOCK,
    seg_stage_cap: int = 4_000_000,
    factors=None,
    s_buf_force: Optional[int] = None,
    direct_quota: int = DEFAULT_DIRECT_QUOTA,
    per_edge: bool = False,
) -> PanelPlan:
    """Host-side panel plan build (numpy + native pass-1). Values must
    factor rank-1 (vals[e] = r[row[e]] * c[col[e]]); raises ValueError
    otherwise, or pass ``per_edge=True`` for the general-valued mode.

    ``per_edge``: every edge gets its own scattered window row, scaled by
    its value (``PanelSegment.stage_scale``), and one mask bit. No hot
    rows and no range windows (shared window rows cannot carry per-edge
    values), no rank-1 requirement.

    ``factors=(r, c)``: trust the caller's rank-1 factorization instead of
    detecting it. ``s_buf_force``: pad the scattered buffer to a
    caller-chosen size (>= the computed one).

    ``direct_quota``: rows per step that the TPU kernel fetched from X
    itself instead of through the take table; each tile's last positions
    become its direct region, sized to the previous piece's step count.
    0 disables. The Hopper kernel resolves direct rows like any other
    window row (PanelWindows)."""
    if R != _L:
        raise ValueError("panel engine requires R=128 (dense masks index "
                         "output rows as mask columns)")
    if T is None:
        from of_spmm_tpu_torch.utils.config import FLAGS

        T = int(FLAGS.get("OFS_FUSED_T")) or default_panels_t(
            csr.nnz, csr.shape[0])
    n, m = csr.shape
    G = T // _L
    direct_quota = min(max(int(direct_quota), 0), DMAX)
    n_tiles = max(-(-n // R), 1)
    if per_edge:
        hot_budget = 0          # shared window rows can't carry values
        min_block = 1 << 30     # ranges off: everything stages per edge
        direct_quota = 0
    if hot_budget is None:
        hot_budget = _HOT_BIG if n_tiles >= _HOT_TILES else _HOT_SMALL

    # rank-1 detection runs on the RAW edge list: every copy of a
    # duplicated (row, col) carries r_i*c_j there, while the coalesced
    # SUM (k*r_i*c_j) does not factor. Duplicates then stage k copies of
    # the column in the scattered region, one mask bit each, which
    # reproduces the sum exactly (a bit has no multiplicity).
    if per_edge:
        row_scale = np.ones(n, np.float32)
        col_scale = np.ones(m, np.float32)
    else:
        if factors is None:
            factors = factor_rank1(csr)
        if factors is None:
            factors = factor_rank1(coalesce_duplicates(csr))
            if factors is not None:
                csr = coalesce_duplicates(csr)
        if factors is None:
            raise ValueError(
                "panel engine requires rank-1-factorable values; pass "
                "per_edge=True for the general-valued mode")
        row_scale, col_scale = factors
        row_scale = np.asarray(row_scale)[:n]
        col_scale = np.asarray(col_scale)[:m]

    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols_all = np.asarray(csr.cols, dtype=np.int64)
    vals_all = (np.asarray(csr.vals, dtype=np.float32) if per_edge
                else None)
    # split duplicates out of the structure (first copy stays)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dup = np.zeros(rows_all.shape[0], bool)
    if not per_edge:  # per-edge staging carries duplicates natively
        key = rows_all * (m + 1) + cols_all
        if key.shape[0] and not bool(np.all(key[1:] >= key[:-1])):
            order0 = np.argsort(key, kind="stable")
        else:
            order0 = None
        ks = key if order0 is None else key[order0]
        if key.shape[0]:
            dup_s = np.concatenate([[False], ks[1:] == ks[:-1]])
            if order0 is None:
                dup = dup_s
            else:
                dup[order0] = dup_s
    extra_rows = rows_all[dup]
    extra_cols = cols_all[dup]
    if extra_rows.shape[0]:
        keep = ~dup
        counts = np.bincount(rows_all[keep], minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        cols_all = cols_all[keep]
    # per-tile extra lists (row-local)
    extra_tile = extra_rows // R
    extra_order = np.argsort(extra_tile, kind="stable")
    extra_tile = extra_tile[extra_order]
    extra_rows = extra_rows[extra_order]
    extra_cols = extra_cols[extra_order]
    extra_ptr = np.searchsorted(extra_tile, np.arange(n_tiles + 1))

    RC = min(range_cap, max(m // _L * _L, _L))
    RQ = rq if RC % rq == 0 else _L
    n_rq = RC // RQ

    from of_spmm_tpu_torch import native

    nat = None if per_edge else native.expansion_pass1(
        indptr, cols_all, np.zeros(cols_all.shape[0], np.float32), R)
    touch = (np.bincount(nat[3][:nat[4][-1]].astype(np.int64), minlength=m)
             if nat is not None else None)
    hot_ids = choose_hot(csr, R, hot_budget, hot_min_run, touch=touch)
    H = hot_ids.shape[0]
    hot_rank = np.full(m, -1, dtype=np.int64)
    hot_rank[hot_ids] = np.arange(H, dtype=np.int64)

    # --- per-tile pass: classify cols, pick/keep ranges, build masks -----
    shuffle_rng = np.random.default_rng(0)
    tiles_meta = []    # (take_cols, edges, counts, blk_of, direct_cols, vals)
    out_of = []
    first_piece = []
    range_of = []
    range_lo = []
    n_scattered = 0
    n_direct = 0
    n_groups = 0
    cur_range = -1
    if per_edge:
        range_lo.append(0)  # one degenerate RC-row range, never consulted
        cur_range = 0
    prev_est = 1   # compute-step estimate of the previously emitted
    #                piece: the steps that stage this tile's directs
    starts = indptr[np.minimum(np.arange(n_tiles + 1) * R, n)]
    for t in range(n_tiles):
        r0, r1 = t * R, min((t + 1) * R, n)
        v_scat = None
        if per_edge:
            lo_e, hi_e = indptr[r0], indptr[r1]
            c = cols_all[lo_e:hi_e]
            v_scat = vals_all[lo_e:hi_e]
            r = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                          np.diff(indptr[r0:r1 + 1]))
        elif nat is not None:
            lane_inv, lane_row, _lv, uniq_all, uniq_ptr = nat
            lo_e, hi_e = starts[t], starts[t + 1]
            uniq_t = uniq_all[uniq_ptr[t]:uniq_ptr[t + 1]].astype(np.int64)
            inv_t = lane_inv[lo_e:hi_e].astype(np.int64)
            c = uniq_t[inv_t]
            r = lane_row[lo_e:hi_e].astype(np.int64)
            cnt_t = np.bincount(inv_t, minlength=uniq_t.shape[0])
        else:
            lo_e, hi_e = indptr[r0], indptr[r1]
            c = cols_all[lo_e:hi_e]
            r = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                          np.diff(indptr[r0:r1 + 1]))
            uniq_t, inv_small = np.unique(c, return_inverse=True)
            cnt_t = np.bincount(inv_small, minlength=uniq_t.shape[0])
        if per_edge:
            # everything scattered, one position per EDGE (values ride
            # stage_scale); no hot / range classification
            is_hot = np.zeros(c.shape[0], bool)
            scat_u = c
            scat_inv = np.arange(c.shape[0], dtype=np.int64)
            n_u = c.shape[0]
            hr = np.full(c.shape[0], -1, dtype=np.int64)
            in_range = np.zeros(c.shape[0], bool)
            is_scat = np.ones(c.shape[0], bool)
            lo_r = 0
        else:
            hr = hot_rank[c]
            is_hot = hr >= 0
            cold_mask_u = hot_rank[uniq_t] < 0
            cold_u = uniq_t[cold_mask_u]
            cold_cnt = cnt_t[cold_mask_u]

            # range choice with persistence
            best_lo, best_mass = _best_window(cold_u, cold_cnt, m, RC)
            if cur_range >= 0:
                clo = range_lo[cur_range]
                a = np.searchsorted(cold_u, clo, side="left")
                b = np.searchsorted(cold_u, clo + RC, side="left")
                cur_mass = int(cold_cnt[a:b].sum())
            else:
                cur_mass = -1
            if cur_range < 0 or cur_mass < _KEEP_FRAC * best_mass:
                range_lo.append(best_lo)
                cur_range = len(range_lo) - 1
            lo_r = range_lo[cur_range]

            in_range = (~is_hot) & (c >= lo_r) & (c < lo_r + RC)
            if min_block > 1 and np.any(in_range):
                rblk = (c[in_range] - lo_r) // _L
                per_blk = np.bincount(rblk, minlength=RC // _L)
                dense_blk = per_blk >= min_block
                keep = np.zeros(c.shape[0], bool)
                keep[in_range] = dense_blk[rblk]
                in_range = keep
            is_scat = (~is_hot) & ~in_range
            c_scat = c[is_scat]
            scat_u, scat_inv = np.unique(c_scat, return_inverse=True)
            n_u = scat_u.shape[0]
        # duplicate-edge extra copies ride the scattered path (one mask
        # bit per copy, see the dedup block above)
        ex_lo, ex_hi = int(extra_ptr[t]), int(extra_ptr[t + 1])
        n_ex = ex_hi - ex_lo
        # a per-tile permutation of the scattered window positions (the
        # JAX package's de-banding of its take table; kept so that the
        # plans stay equal)
        perm = shuffle_rng.permutation(n_u + n_ex).astype(np.int64)
        n_pos = n_u + n_ex
        n_pieces = max(1, -(-max(n_pos, 1) // s_cap))

        # direct region: the tile's LAST D positions (single-piece tiles
        # only). The table part pads to TQ so the pad gap [n_table, P)
        # sits between table and directs.
        if n_pieces == 1 and direct_quota > 0:
            D = int(min(n_pos, direct_quota * prev_est))
        else:
            D = 0
        n_table = n_pos - D
        P = -(-n_table // TQ) * TQ
        shift = P - n_table
        adj = np.where(perm >= n_table, perm + shift, perm) if shift \
            else perm

        win_pos = np.empty(c.shape[0], dtype=np.int64)
        win_pos[is_hot] = hr[is_hot]
        win_pos[in_range] = H + (c[in_range] - lo_r)
        win_pos[is_scat] = H + RC + adj[scat_inv]
        if n_ex:
            win_pos = np.concatenate(
                [win_pos,
                 H + RC + adj[n_u + np.arange(n_ex, dtype=np.int64)]])
            r = np.concatenate([r, extra_rows[ex_lo:ex_hi] - r0])

        # position -> column map (the table/window order is the
        # shuffled position order, BEFORE the pad-gap shift)
        col_at_pos = np.empty(n_pos, dtype=np.int64)
        col_at_pos[perm] = np.concatenate(
            [scat_u, extra_cols[ex_lo:ex_hi]]) if n_ex else scat_u
        val_at_pos = None
        if v_scat is not None:
            val_at_pos = np.empty(n_pos, dtype=np.float32)
            val_at_pos[perm] = v_scat
        direct_cols = col_at_pos[n_table:n_pos].astype(np.int32)

        # scattered overflow: split into virtual pieces; pieces > 0 carry
        # only the scattered tail (hot+range stay in piece 0)
        for piece in range(n_pieces):
            if n_pieces == 1:
                wp_p, rr_p = win_pos, r
            else:
                lo_pos = H + RC + piece * s_cap
                hi_pos = H + RC + (piece + 1) * s_cap
                if piece == 0:
                    sel = win_pos < hi_pos
                else:
                    sel = (win_pos >= lo_pos) & (win_pos < hi_pos)
                wp_p = win_pos[sel].copy()
                wp_p[wp_p >= H + RC] -= piece * s_cap
                rr_p = r[sel]
            edg, cnts, bo = _dense_groups(wp_p, rr_p)
            lo_tc = piece * s_cap
            hi_tc = min((piece + 1) * s_cap, n_table)
            take_cols = col_at_pos[lo_tc:hi_tc]
            tv = None if val_at_pos is None else val_at_pos[lo_tc:hi_tc]
            pad = -take_cols.shape[0] % TQ
            if pad:
                fill = take_cols[-1] if take_cols.shape[0] else 0
                take_cols = np.concatenate(
                    [take_cols, np.full(pad, fill, np.int64)])
                if tv is not None:  # pad rows scale to exact zero
                    tv = np.concatenate([tv, np.zeros(pad, np.float32)])
            dc = direct_cols if piece == n_pieces - 1 else \
                np.zeros(0, np.int32)
            tiles_meta.append((take_cols.astype(np.int32), edg, cnts, bo,
                               dc, tv))
            out_of.append(t)
            first_piece.append(piece == 0)
            range_of.append(cur_range)
            n_scattered += take_cols.shape[0]
            n_direct += dc.shape[0]
            n_groups += cnts.shape[0]
            prev_est = max(-(-cnts.shape[0] // G), 1)

    n_meta = len(tiles_meta)

    def staged_of(t):
        return tiles_meta[t][0].shape[0]

    # --- steps per tile: compute groups AND next tile's staging quota ----
    stage_quota = BMAX * SCQ  # rows stageable per step
    steps_of = []
    for t in range(n_meta):
        need_c = max(-(-tiles_meta[t][2].shape[0] // G), 1)
        nxt = staged_of(t + 1) if t + 1 < n_meta else 0
        need_s = -(-nxt // stage_quota)
        nxt_d = tiles_meta[t + 1][4].shape[0] if t + 1 < n_meta else 0
        need_d = -(-nxt_d // max(direct_quota, 1))
        steps_of.append(max(need_c, need_s, need_d, 1))
    # pad each tile's group arrays to steps*G
    for t in range(n_meta):
        take, edg, cnts, bo, dc, tv = tiles_meta[t]
        want_g = steps_of[t] * G
        pad_g = want_g - cnts.shape[0]
        if pad_g > 0:
            cnts = np.concatenate([cnts, np.zeros(pad_g, np.int32)])
            bo = np.concatenate([bo, np.zeros(pad_g, np.int32)])
            tiles_meta[t] = (take, edg, cnts, bo, dc, tv)
            n_groups += pad_g
    S_buf = max(max((staged_of(t) + tiles_meta[t][4].shape[0]
                     for t in range(n_meta)), default=TQ), TQ)
    # aligned to the JAX kernel's split chunk, so its chunked splits never
    # cross into the other parity's region
    S_buf += -S_buf % 2048 if S_buf > 2048 else -S_buf % TQ
    if s_buf_force is not None:
        if s_buf_force < S_buf:
            raise ValueError(f"s_buf_force={s_buf_force} < computed "
                             f"S_buf={S_buf}")
        S_buf = int(s_buf_force)

    # --- segment layout (cut at tile boundaries on steps or table cap) ---
    seg_lists = []
    seg_start = 0
    while seg_start < n_meta:
        seg_tiles = [seg_start]
        total = steps_of[seg_start] * 2
        stage_sum = staged_of(seg_start)
        while seg_tiles[-1] + 1 < n_meta:
            nxt = seg_tiles[-1] + 1
            fits = (total + steps_of[nxt] <= seg_steps
                    and stage_sum + staged_of(nxt) <= seg_stage_cap)
            if not fits and first_piece[nxt]:
                break
            seg_tiles.append(nxt)
            total += steps_of[nxt]
            stage_sum += staged_of(nxt)
        seg_lists.append(seg_tiles)
        seg_start = seg_tiles[-1] + 1

    # RMAX from the actual emission spans: within each segment, range
    # rid's copies spread over the PREVIOUS range's local step span minus
    # one (fill_range); a range split across segments gets a prologue in
    # the next segment, which sizes itself from RMAX, so only the
    # within-segment spans constrain it.
    RMAX = 1
    for seg_tiles in seg_lists:
        spans = []  # per in-segment range run: total steps
        for t in seg_tiles:
            if spans and range_of[t] == spans[-1][0]:
                spans[-1][1] += steps_of[t]
            else:
                spans.append([range_of[t], steps_of[t]])
        for k in range(len(spans) - 1):
            span = max(spans[k][1] - 1, 1)
            RMAX = max(RMAX, -(-n_rq // span))
    RMAX = min(max(RMAX, 1), max(RMAX_CAP, n_rq))

    segments = [
        _emit_segment(tiles_meta, seg_tiles, steps_of, out_of,
                      first_piece, range_of, range_lo, R, G, S_buf, RMAX,
                      RQ, RC, m, direct_quota)
        for seg_tiles in seg_lists
    ]

    plan = PanelPlan(
        segments=tuple(segments),
        hot_ids=hot_ids.astype(np.int32),
        row_scale=row_scale.astype(np.float32),
        col_scale=col_scale.astype(np.float32),
        shape=csr.shape,
        R=R, T=T, RC=int(RC), S_buf=int(S_buf), RMAX=int(RMAX),
        RQ=int(RQ), n_ranges=len(range_lo),
        n_range_rows=len(range_lo) * int(RC),
        n_scattered=int(n_scattered), n_groups=int(n_groups),
        n_direct=int(n_direct),
    )
    rep = plan_memory_report(plan)
    if not rep["fits"]:
        from of_spmm_tpu_torch.utils.errors import CapacityError

        raise CapacityError(
            f"panel plan cannot fit device memory: peak "
            f"{rep['peak_bytes'] / 2**30:.2f} GiB > budget "
            f"{rep['budget_bytes'] / 2**30:.2f} GiB; reduce seg_steps / "
            f"seg_stage_cap or use layout='tiered'.")
    return plan


def _emit_segment(tiles_meta, seg_tiles, steps_of, out_of, first_piece,
                  range_of, range_lo, R, G, S_buf, RMAX, RQ, RC,
                  m, direct_quota):  # noqa: C901
    """Lay out one segment's step stream.

    Prologue stages tile 0's scattered rows AND range 0's copies; per
    tile, compute steps co-stage the NEXT tile's scattered rows (parity
    ping-pong) and the NEXT tile's direct rows (DMAX per step); each
    range's steps carry the NEXT range's copies (minus the last step)."""
    # table: per-tile-piece padded col lists in consumption order
    table_base = {}
    base = 0
    take_list = []
    scale_list = []
    any_scale = any(tiles_meta[t][5] is not None for t in seg_tiles)
    for j, t in enumerate(seg_tiles):
        table_base[j] = base
        take_list.append(tiles_meta[t][0])
        if any_scale:
            tv = tiles_meta[t][5]
            scale_list.append(
                tv if tv is not None
                else np.ones(tiles_meta[t][0].shape[0], np.float32))
        base += tiles_meta[t][0].shape[0]
    stage_take = (np.concatenate(take_list).astype(np.int32)
                  if base else np.zeros(0, np.int32))
    stage_scale = (np.concatenate(scale_list).astype(np.float32)
                   if any_scale and base else
                   (np.zeros(0, np.float32) if any_scale else None))
    # the JAX kernel's semaphore waits reference table rows [0, SCQ);
    # the table stays at least that tall (pads name row 0)
    if stage_take.shape[0] < SCQ:
        pad_n = SCQ - stage_take.shape[0]
        stage_take = np.concatenate(
            [stage_take, np.zeros(pad_n, np.int32)])
        if stage_scale is not None:
            stage_scale = np.concatenate(
                [stage_scale, np.zeros(pad_n, np.float32)])

    first = seg_tiles[0]
    n_rq = RC // RQ
    d_first = tiles_meta[seg_tiles[0]][4].shape[0]
    prologue = max(steps_of[first], -(-n_rq // RMAX) + 1,
                   -(-staged_of_meta(tiles_meta, first) // (BMAX * SCQ)),
                   -(-d_first // max(direct_quota, 1)))
    n_steps = prologue + sum(steps_of[t] for t in seg_tiles)

    ctrl = np.zeros((n_steps, 1, 24), np.int32)
    rcopy = np.zeros((n_steps, 2, RMAX), np.int32)
    dsrc = np.zeros((n_steps, 1, DMAX), np.int32)
    mask_counts = np.zeros(n_steps * G, np.int32)
    mask_edges_list = []
    blk = np.zeros((n_steps, 1, G), np.int32)
    tile_of = np.zeros(n_steps, np.int32)

    def fill_scattered(j, step_lo, step_hi, parity):
        rows = tiles_meta[seg_tiles[j]][0].shape[0]
        if not rows:
            return
        src0 = table_base[j]
        nsteps = step_hi - step_lo
        n_big = rows // SCQ
        n_tail = (rows - n_big * SCQ) // TQ   # <= TMAX by construction
        per_big = -(-n_big // nsteps) if n_big else 0
        pos = 0  # rows staged
        bdone = 0
        tdone = False
        for s in range(step_lo, step_hi):
            b = max(min(per_big, n_big - bdone), 0)
            tl = 0
            if bdone + b == n_big and not tdone:
                tl = n_tail
                tdone = True
            ctrl[s, 0, 2] = src0 + pos
            ctrl[s, 0, 5] = parity * S_buf + pos
            ctrl[s, 0, 3] = b
            ctrl[s, 0, 7] = tl
            pos += b * SCQ + tl * TQ
            bdone += b
        assert pos == rows, (pos, rows, n_big, n_tail, nsteps)

    def fill_direct(j, step_lo, step_hi, parity):
        dc = tiles_meta[seg_tiles[j]][4]
        nd = dc.shape[0]
        if not nd:
            return
        base = parity * S_buf + tiles_meta[seg_tiles[j]][0].shape[0]
        nsteps = step_hi - step_lo
        per = -(-nd // nsteps)
        assert per <= DMAX, (per, nd, nsteps)
        pos = 0
        for s in range(step_lo, step_hi):
            k = max(min(per, nd - pos), 0)
            ctrl[s, 0, 16] = k
            ctrl[s, 0, 18] = base + pos
            if k:
                dsrc[s, 0, :k] = dc[pos:pos + k]
            pos += k
        assert pos == nd, (pos, nd, nsteps)

    def fill_range(rid, step_lo, step_hi, parity):
        lo = range_lo[rid]
        nsteps = max(step_hi - step_lo, 1)
        per = -(-n_rq // nsteps)
        pos = 0
        for s in range(step_lo, step_hi):
            cnt = max(min(per, n_rq - pos), 0)
            if cnt:
                src = lo + np.arange(pos, pos + cnt) * RQ
                src = np.minimum(src, max(m - RQ, 0))
                rcopy[s, 0, :cnt] = src
                rcopy[s, 1, :cnt] = (parity * RC
                                     + np.arange(pos, pos + cnt) * RQ)
            ctrl[s, 0, 4] = cnt
            pos += cnt

    # prologue: no compute
    ctrl[:prologue, 0, 0] = -1
    fill_scattered(0, 0, prologue, 0)
    fill_direct(0, 0, prologue, 0)
    fill_range(range_of[first], 0, prologue - 1, 0)

    seg_ranges = []
    for j, t in enumerate(seg_tiles):
        if not seg_ranges or range_of[t] != seg_ranges[-1][0]:
            seg_ranges.append([range_of[t], j, j])
        else:
            seg_ranges[-1][2] = j
    rpar_of = {rid: k % 2 for k, (rid, _, _) in enumerate(seg_ranges)}

    out_base = out_of[seg_tiles[0]]
    step = prologue
    step_at = []
    for j, t in enumerate(seg_tiles):
        step_at.append(step)
        ns = steps_of[t]
        take, edg, cnts, bo, dc, _tv = tiles_meta[t]
        rid = range_of[t]
        ctrl[step:step + ns, 0, 0] = out_of[t] - out_base
        n_real = int((cnts > 0).sum())
        ctrl[step:step + ns, 0, 1] = 1 + np.clip(
            n_real - np.arange(ns) * G, 0, G)
        ctrl[step, 0, 15] = 1
        ctrl[step, 0, 9] = 1 if first_piece[t] else 0
        ctrl[step, 0, 14] = take.shape[0] + dc.shape[0]
        ctrl[step:step + ns, 0, 13] = (j % 2) * S_buf
        ctrl[step:step + ns, 0, 11] = rpar_of[rid] * RC
        tile_of[step:step + ns] = out_of[t] - out_base
        mask_counts[step * G:(step + ns) * G] = cnts
        mask_edges_list.append(edg)
        blk[step:step + ns, 0, :] = bo.reshape(ns, G)
        if j + 1 < len(seg_tiles):
            fill_scattered(j + 1, step, step + ns, (j + 1) % 2)
            fill_direct(j + 1, step, step + ns, (j + 1) % 2)
        step += ns

    for k, (rid, j_lo, j_hi) in enumerate(seg_ranges):
        ctrl[step_at[j_lo], 0, 10] = 1
        if k + 1 < len(seg_ranges):
            nxt_rid = seg_ranges[k + 1][0]
            lo_s = step_at[j_lo]
            hi_s = step_at[j_hi] + steps_of[seg_tiles[j_hi]]
            fill_range(nxt_rid, lo_s, max(hi_s - 1, lo_s + 1),
                       rpar_of[nxt_rid])

    ctrl[1:, 0, 6] = ctrl[:-1, 0, 3]
    ctrl[1:, 0, 8] = ctrl[:-1, 0, 7]
    ctrl[1:, 0, 12] = ctrl[:-1, 0, 4]
    ctrl[1:, 0, 17] = ctrl[:-1, 0, 16]

    return PanelSegment(
        ctrl=ctrl,
        rcopy=rcopy,
        dsrc=dsrc,
        masks=None,
        mask_edges=(np.concatenate(mask_edges_list)
                    if mask_edges_list else np.zeros(0, np.uint16)),
        mask_counts=mask_counts,
        blk=blk,
        tile_of=tile_of,
        stage_take=stage_take,
        stage_scale=stage_scale,
        n_steps=n_steps,
        n_tiles=out_of[seg_tiles[-1]] - out_base + 1,
    )


def staged_of_meta(tiles_meta, t):
    return tiles_meta[t][0].shape[0]


# ---------------------------------------------------------------------------
# window provenance (port only)
# ---------------------------------------------------------------------------


def xs_rows(plan: PanelPlan) -> int:
    """Rows of the JAX package's padded, column-scaled X (``xs``): a window
    row at or past ``shape[1]`` and below this reads a zero row."""
    m = plan.shape[1]
    return max(-(-m // _L) * _L, plan.RC)


def segment_windows(plan: PanelPlan, seg: PanelSegment) -> PanelWindows:
    """Replay one segment's control stream on the host (the copies and
    the first-of-range / first-of-tile window fills, in the order the
    step oracle sparse/panels_sim.py applies them) and record where each
    compute step's window rows came from. Raises ValueError when the
    stream does not have the shape the kernel relies on: a tile's steps
    consecutive, and its scattered window region a run of consecutive
    table rows followed by direct rows."""
    RC, RQ, S_buf = plan.RC, plan.RQ, plan.S_buf
    if RC % _L or RC % RQ:
        raise ValueError(f"range window RC={RC} must be a multiple of 128 and of RQ={RQ}")
    n_rq = RC // RQ
    ctrl = np.asarray(seg.ctrl)[:, 0, :].astype(np.int64)
    rcopy = np.asarray(seg.rcopy)
    dsrc = np.asarray(seg.dsrc)
    n_take = int(np.asarray(seg.stage_take).shape[0])
    chunk_src = np.full(2 * n_rq, -1, np.int64)   # range scratch, per RQ chunk
    scat_tab = np.full(2 * S_buf, -1, np.int64)   # scattered scratch: table row
    scat_dir = np.full(2 * S_buf, -1, np.int64)   # ... or direct X row
    win_range = [-1, -1]                          # per parity: range window
    win_scat = [(0, 0, 0, 0), (0, 0, 0, 0)]       # per parity: base, P, dbase, D
    range_rows, direct_rows = [], []
    n_dir = 0
    step_win = np.zeros((seg.n_steps, 5), np.int32)
    for i in range(seg.n_steps):
        c = ctrl[i]
        rows = c[C_SBIG] * SCQ + c[C_STAIL] * TQ
        if rows:
            dst = c[C_SDST]
            scat_tab[dst:dst + rows] = c[C_SSRC] + np.arange(rows)
            scat_dir[dst:dst + rows] = -1
        if c[C_DCNT]:
            dst, k = c[C_DDST], c[C_DCNT]
            scat_dir[dst:dst + k] = dsrc[i, 0, :k]
            scat_tab[dst:dst + k] = -1
        for k in range(c[C_RCNT]):
            if rcopy[i, 1, k] % RQ:
                raise ValueError(f"step {i}: range copy to row {rcopy[i, 1, k]} "
                                 f"is not RQ={RQ}-aligned")
            chunk_src[rcopy[i, 1, k] // RQ] = rcopy[i, 0, k]
        if c[C_TILE] < 0:
            continue
        rpar, spar = c[C_RREAD] // RC, c[C_SREAD] // S_buf
        if c[C_RFIRST]:
            range_rows.append(chunk_src[rpar * n_rq:(rpar + 1) * n_rq].copy())
            win_range[rpar] = len(range_rows) - 1
        if c[C_TFIRST]:
            s0, ext = c[C_SREAD], c[C_SEXT]
            tab, dr = scat_tab[s0:s0 + ext], scat_dir[s0:s0 + ext]
            P = int(np.argmax(tab < 0)) if (tab < 0).any() else int(ext)
            base = int(tab[0]) if P else 0
            if (not np.array_equal(tab[:P], base + np.arange(P))
                    or base + P > n_take or (tab[P:] >= 0).any()
                    or (dr[P:] < 0).any()):
                raise ValueError(f"step {i}: the scattered window is not table rows "
                                 "followed by direct rows")
            direct_rows.append(dr[P:].copy())  # scat_dir changes later
            win_scat[spar] = (base, P, n_dir, int(ext) - P)
            n_dir += int(ext) - P
        step_win[i] = (win_range[rpar], *win_scat[spar])
    tiles = ctrl[:, C_TILE]
    comp = np.nonzero(tiles >= 0)[0]
    if comp.shape[0] and (not np.array_equal(comp, comp[0] + np.arange(comp.shape[0]))
                          or (np.diff(tiles[comp]) < 0).any()):
        raise ValueError("a tile's compute steps are not consecutive")
    first = int(comp[0]) if comp.shape[0] else seg.n_steps
    tile_steps = first + np.searchsorted(tiles[comp], np.arange(seg.n_tiles + 1))
    unit_slots, units, split_tiles = work_units(
        tiles, np.asarray(seg.mask_counts), plan.T // _L, seg.n_tiles, UNIT_EDGES)
    return PanelWindows(
        tile_steps=tile_steps.astype(np.int32),
        step_win=step_win,
        range_rows=(np.stack(range_rows) if range_rows
                    else np.zeros((0, n_rq), np.int64)).astype(np.int32),
        direct_rows=(np.concatenate(direct_rows) if direct_rows
                     else np.zeros(0, np.int64)).astype(np.int32),
        unit_slots=unit_slots,
        units=units,
        split_tiles=split_tiles,
    )


def work_units(step_tile: np.ndarray, mask_counts: np.ndarray, G: int, n_tiles: int,
               max_edges: int):
    """The panel kernel's work list for one segment (see PanelWindows):
    ``(unit_slots, units, split_tiles)``. ``step_tile`` is each step's
    compute tile (ctrl word 0), ``mask_counts`` the mask bits of each
    group slot. Each run of a tile's slots with bits is cut greedily, in
    step order, into units of at most ``max_edges`` bits (placement uses
    UNIT_EDGES); a single slot with more is a unit alone. A tile's slots
    come in one run on panel plans; a tile whose slots come in several
    (the fused kernel's window mode keys its units on 128-row output
    blocks, whose steps may interleave) gets units from each, so it is
    split. Units are ordered by their bits, heaviest first (stable, so
    ties keep step order)."""
    E = int(max_edges)
    if E < 1:
        raise ValueError(f"unit edge cap {E} must be positive")
    counts = np.asarray(mask_counts).astype(np.int64)
    slots = np.nonzero(counts)[0]
    tile = np.asarray(step_tile).astype(np.int64)[slots // G]
    if (tile < 0).any():
        raise ValueError("a slot with mask bits lies in a step that computes no tile")
    edges = counts[slots]
    cut = np.ones(slots.shape[0], bool)  # a unit starts at this slot
    if slots.shape[0]:
        tile_first = np.r_[True, tile[1:] != tile[:-1]]
        t0 = np.nonzero(tile_first)[0]
        totals = np.add.reduceat(edges, t0)
        cut = tile_first.copy()
        for a, b in zip(t0[totals > E], np.r_[t0[1:], slots.shape[0]][totals > E]):
            run = 0
            for i in range(a, b):  # the greedy cut, heavy tiles only
                if i > a and run + edges[i] > E:
                    cut[i], run = True, 0
                run += edges[i]
    first = np.nonzero(cut)[0]
    end = np.r_[first[1:], slots.shape[0]][:first.shape[0]]
    u_tile = tile[first]
    weight = np.add.reduceat(edges, first) if first.shape[0] else np.zeros(0, np.int64)
    n_units = np.bincount(u_tile, minlength=n_tiles)
    split = np.nonzero(n_units > 1)[0]
    u_tile = np.where(n_units[u_tile] > 1, ~u_tile, u_tile)
    empty = np.nonzero(n_units == 0)[0]  # tiles without edges still write zeros
    units = np.concatenate([np.stack([u_tile, first, end], 1),
                            np.stack([empty, np.zeros_like(empty), np.zeros_like(empty)], 1)])
    order = np.argsort(-np.r_[weight, np.zeros(empty.shape[0], np.int64)], kind="stable")
    return (slots.astype(np.int32), units[order].astype(np.int32).reshape(-1, 3),
            split.astype(np.int32))


def resolve_window_rows(plan: PanelPlan, seg: PanelSegment, step, pos):
    """X row and scale of window row ``pos`` of compute step ``step``
    (int64 tensors of one shape), through the segment's PanelWindows:
    ``(src, scale, bad)``. ``scale`` folds ``col_scale`` and, in per-edge
    mode, ``stage_scale``; a row of X's zero padding has scale 0. ``bad``
    marks rows that resolve to nothing staged or outside the padded X: no
    mask bit may name one. Works on the plan's numpy arrays (as CPU
    tensors) or on its placed tensors."""
    def t(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))

    win = seg.windows
    dev = pos.device
    H, RC, RQ = plan.n_hot, plan.RC, plan.RQ
    m = plan.shape[1]
    sw = t(win.step_win).to(dev).long()[step]
    src = torch.full_like(pos, -1)
    scale = torch.ones(pos.shape, dtype=torch.float32, device=dev)
    if H:
        hot = pos < H
        src = torch.where(hot, t(plan.hot_ids).to(dev).long()[pos.clamp(0, H - 1)], src)
    p = pos - H
    rng = (pos >= H) & (pos < H + RC) & (sw[:, 0] >= 0)
    rr = t(win.range_rows).to(dev).long()
    if rr.shape[0]:
        start = rr[sw[:, 0].clamp(min=0), (p // RQ).clamp(0, RC // RQ - 1)]
        src = torch.where(rng & (start >= 0), start + p % RQ, src)
    q = pos - H - RC
    tab = (q >= 0) & (q < sw[:, 2])
    take = t(seg.stage_take).to(dev).long()
    ti = (sw[:, 1] + q).clamp(0, max(take.shape[0] - 1, 0))
    if take.shape[0]:
        src = torch.where(tab, take[ti], src)
    if seg.stage_scale is not None and take.shape[0]:
        scale = torch.where(tab, t(seg.stage_scale).to(dev)[ti], scale)
    dr = t(win.direct_rows).to(dev).long()
    if dr.shape[0]:
        drow = (q >= sw[:, 2]) & (q < sw[:, 2] + sw[:, 4])
        di = (sw[:, 3] + q - sw[:, 2]).clamp(0, dr.shape[0] - 1)
        src = torch.where(drow, dr[di], src)
    bad = (src < 0) | (src >= xs_rows(plan))
    zero = bad | (src >= m)
    src = torch.where(zero, 0, src)
    scale = torch.where(zero, 0.0, scale * t(plan.col_scale).to(dev)[src])
    return src, scale, bad


def attach_windows(plan: PanelPlan) -> PanelPlan:
    """Derive every segment's PanelWindows and check, on the host, that
    each mask bit names a real group slot of a compute step and a window
    row that resolves to a row of X (a plan bug otherwise: raises
    ValueError). Takes a plan with compact masks (as build_panels_plan
    gives it); segments that carry their windows already were checked
    when they got them and pass through."""
    G = plan.T // _L
    segs = []
    for seg in plan.segments:
        if seg.windows is not None:
            segs.append(seg)
            continue
        if seg.mask_edges is None:
            raise ValueError("attach_windows needs the compact mask edges: place the "
                             "plan as build_panels_plan gives it, before ensure_masks")
        seg = dataclasses.replace(seg, windows=segment_windows(plan, seg))
        counts = np.asarray(seg.mask_counts).astype(np.int64)
        slot = np.repeat(np.arange(counts.shape[0], dtype=np.int64), counts)
        w = np.asarray(seg.mask_edges).astype(np.int64) >> 8
        step, g = slot // G, slot % G
        ctrl = np.asarray(seg.ctrl)[:, 0, :]
        g1 = ctrl[step, C_GCNT]
        live = (ctrl[step, C_TILE] >= 0) & ((g1 == 0) | (g < g1 - 1))
        if not live.all():
            raise ValueError("a mask bit lies in a padded group slot or a step that "
                             "computes no tile")
        pos = np.asarray(seg.blk)[step, 0, g].astype(np.int64) * _L + w
        _src, _scale, bad = resolve_window_rows(
            plan, seg, torch.from_numpy(step), torch.from_numpy(pos))
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise ValueError(f"mask bit of step {int(step[i])} names window row "
                             f"{int(pos[i])}, which resolves to no row of X")
        segs.append(seg)
    return dataclasses.replace(plan, segments=tuple(segs))
