"""Fused-engine plan: per-tile staging schedule + hot-column cache.

The port of the JAX package's sparse/fused.py. ``build_fused_plan``
gives, on the same CSR, plan arrays equal to the JAX package's (the
tests hold them array for array), so the Hopper kernel
(ops/cuda/fused.py, csrc/fused.cu) runs the same plan as the TPU kernel.

The plan cuts the output into R-row tiles and lays out, per tile, a
window of X rows:

- the HOT TABLE: the columns referenced by the most tiles, shared by
  every tile, chosen block by block (128 cols) while the expected lanes
  per tile and block stay dense enough to fill lane groups;
- the tile's STAGED rows: its sorted unique remaining (cold) columns.
  The TPU kernel copies them into a double-buffered scratch during the
  previous tile's steps, either row by row from X (``staging="rows"``)
  or in cq-row blocks from a tier-major take table (``"chunks"``).

A tile's edges become lanes of 128-lane groups, each group sharing one
128-row window block: rank-1 plans carry one lane per (output row,
window block) with a (4, 128) int32 selection bitmask (``multihot``),
general plans one lane per edge with a window-local index and the value
as a bf16 pair (``val_hi + val_lo``). The per-step control stream
(``ctrl``) says which tile a step computes and which copies it issues.

The control stream says where rows are copied, not where a compute
step's window rows came from. Placement replays it once on the host
(sparse/staged_windows.py) so the Hopper kernel reads each window row
straight from X; the plan's own arrays stay as the JAX package builds
them.

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
from of_spmm_tpu_torch.utils.errors import CapacityError

_L = 128
DEFAULT_R = 128          # output rows per tile
DEFAULT_T = 1024         # lanes per step (G = T/128 groups)
DEFAULT_HOT_BUDGET = 16384   # max hot rows
DEFAULT_HOT_MIN_RUN = 32     # keep hot blocks while lanes/tile/block >= this
DEFAULT_SEG_STEPS = 8192     # steps per segment (one kernel launch)
DMAX_CAP = 640               # max staging copies per step (rows mode)
S_CAP = 32768                # max staged rows per (virtual) tile: hub tiles
#                              split into virtual tiles revisiting the same
#                              output block
_CQ = 32                     # default chunk quantum: run alignment and copy
#                              granularity of chunks mode
_BIG_T = 1024                # lanes/step for graphs of >= _BIG_T_NNZ nnz
_BIG_T_NNZ = 8_000_000       # graphs at or above this nnz take the big-T default

# The plan-time memory budget: a plan must fit _BUDGET_FRACTION of the
# device's memory.
_H100_HBM = 80 * 10**9   # NVIDIA H100 SXM5: 80 GB HBM3
_BUDGET_FRACTION = 0.80
# The JAX package sizes chunks-mode segments by its own peak model, in
# which a segment's staged take table (512 B per row) is live with
# headroom; the port builds no take table, but cuts segments by the same
# model so that its plans stay equal to the JAX package's
# (_staging_model_report).
_TABLE_HEADROOM = 1.5


@dataclasses.dataclass(frozen=True)
class FusedSegment:
    """One kernel launch worth of steps (contiguous tiles)."""

    ctrl: np.ndarray      # (steps, 1, 16) int32 per-step control words:
    #  [0] compute tile id (block index into this segment's output; -1 none)
    #  [1] first-step-of-(virtual)-tile flag
    #  [2] staging dst base row = parity*S_buf + chunk base (rows mode)
    #  [3] staging count (rows, or chunk copies, this step; 0 = none)
    #  [5] staged read base row = read-parity*S_buf
    #  [6] prev-step staging count, [7] prev-step dst base row
    #  [8] staged rows of the tile being computed (rows mode)
    #  [9] zero-output flag (first step of the first virtual tile only)
    #  [10] dst 128-row window of the step (window mode)
    scols: np.ndarray     # rows mode: (steps, 8, DMAX/8) int32 X rows to
    #                        stage; chunks mode: (steps, 2, DMAX) int32
    #                        [src_blk | dst_blk] cq-row block copies from
    #                        the tier-major staged table (dst parity folded)
    lidx: np.ndarray      # (steps*G, 128) int32 window-local index, or
    #                        multi-hot masks (steps*G, 4, 128) int32 (bit j
    #                        of word w, lane l: window row 32w+j feeds lane l)
    lrow: np.ndarray      # (steps*G, 128) int32 tile-local output row
    #                        (R = padding; window mode: window-local, 128)
    blk: np.ndarray       # (steps, 1, G) int32 window block (>= H/128:
    #                        the staged region)
    tile_of: np.ndarray   # (steps,) int32 out block index
    val_hi: Optional[np.ndarray]  # (steps*G, 128) float32 holding the bf16
    val_lo: Optional[np.ndarray]  # pair of each value; None when rank-1
    # chunks mode: tier-local take indices (cq-padded per run) and the
    # tier boundaries of the staged table
    stage_take: Optional[np.ndarray] = None        # (S_table,) int32
    stage_tier_ptr: Optional[tuple] = None          # (n_tiers+1,) python ints
    n_steps: int = 0
    n_tiles: int = 0
    windows: Optional[object] = None   # port only: StagedWindows (placement)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    segments: Tuple[FusedSegment, ...]
    hot_ids: np.ndarray           # (H,) int32 global col ids of the hot table
    row_scale: Optional[np.ndarray]  # (n_rows,) f32 rank-1 row factor
    col_scale: Optional[np.ndarray]  # (n_cols,) f32 rank-1 col factor
    shape: Tuple[int, int]
    R: int
    T: int
    multihot: bool                # lanes carry selection bitmasks
    staging: str                  # "rows" | "chunks"
    stage_tier: int               # tier size of the chunks-mode take table
    S_buf: int                    # staging buffer rows (per parity)
    DMAX: int                     # max staging copies per step
    n_staged: int                 # total staged rows
    n_lanes: int                  # total lanes incl. padding
    window: bool = False          # steps are dst-window-homogeneous
    cq: int = _CQ                 # chunk quantum of chunks mode

    @property
    def n_hot(self) -> int:
        return int(self.hot_ids.shape[0])

    @property
    def rank1(self) -> bool:
        return self.row_scale is not None

    def padding_efficiency(self, true_nnz: int) -> float:
        return float(true_nnz) / max(self.n_lanes, 1)


def device_hbm_bytes(device=None) -> int:
    """Device memory bytes for the plan budget: OFS_HBM_BYTES when set,
    else the card's total memory, else (a host without a card, building
    a plan for one) the H100's 80 GB."""
    from of_spmm_tpu_torch.utils.config import FLAGS

    flag = int(FLAGS.get("OFS_HBM_BYTES"))
    if flag:
        return flag
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        if dev.type == "cuda":
            return int(torch.cuda.get_device_properties(dev).total_memory)
    return _H100_HBM


def _nbytes(a) -> int:
    if a is None:
        return 0
    if isinstance(a, torch.Tensor):
        return int(a.numel()) * a.element_size()
    return int(np.asarray(a).size) * a.dtype.itemsize


def _staging_model_report(plan: FusedPlan, hbm_limit: Optional[int]) -> dict:
    """The JAX package's peak model of a chunks-mode plan on its TPU
    (plan arrays with bf16 value pairs, X and its 128-wide slab, two
    copies of the output, the hot table, 1.5 x the largest per-segment
    staged table), which ``build_fused_plan`` cuts segments by so that
    its plans equal the JAX package's. What the port itself needs on the
    card is ``plan_memory_report``."""
    hbm = hbm_limit or device_hbm_bytes()
    n, m = plan.shape
    plan_b = _nbytes(plan.hot_ids) + _nbytes(plan.row_scale) + _nbytes(plan.col_scale)
    max_table = 0
    for seg in plan.segments:
        for leaf in (seg.ctrl, seg.scols, seg.lidx, seg.lrow, seg.blk, seg.tile_of,
                     seg.stage_take):
            plan_b += _nbytes(leaf)
        if seg.val_hi is not None:
            plan_b += 2 * 2 * int(np.asarray(seg.val_hi).size)  # two bf16 arrays
        if seg.stage_take is not None:
            max_table = max(max_table, int(seg.stage_take.shape[0]) * 512)
    out_rows = sum(seg.n_tiles * plan.R for seg in plan.segments)
    peak = (plan_b + m * _L * 4 * 2 + 2 * out_rows * _L * 4 + plan.n_hot * 512
            + int(_TABLE_HEADROOM * max_table))
    budget = int(_BUDGET_FRACTION * hbm)
    return {"peak_bytes": peak, "budget_bytes": budget, "hbm_bytes": hbm,
            "max_table_bytes": max_table, "plan_bytes": plan_b,
            "fits": peak <= budget}


def plan_memory_report(plan, d: int = 128, hbm_limit: Optional[int] = None) -> dict:
    """Device-memory model of one SpMM at width ``d`` through a FusedPlan
    or RangesPlan (the JAX package's keys), counting what the port keeps
    on the card: the plan arrays (values as float32 pairs), the window
    provenance placement derives (one int32 per staged row and three per
    step, plus the range windows), the kernel's work list (at most), X
    and the output. The port builds no staged table and no hot table (the
    kernel reads those rows from X), so ``max_table_bytes`` and
    ``hot_bytes`` are 0."""
    hbm = hbm_limit or device_hbm_bytes()
    n, m = plan.shape
    plan_b = _nbytes(plan.hot_ids) + _nbytes(plan.row_scale) + _nbytes(plan.col_scale)
    n_rq = (plan.RC // plan.RQ) if hasattr(plan, "RC") else 0
    for seg in plan.segments:
        for leaf in (seg.ctrl, seg.scols, getattr(seg, "rcopy", None), seg.lidx, seg.lrow,
                     seg.blk, seg.tile_of, seg.val_hi, seg.val_lo, seg.stage_take):
            plan_b += _nbytes(leaf)
        ctrl = np.asarray(seg.ctrl)[:, 0, :]
        staged = (int(seg.stage_take.shape[0]) if seg.stage_take is not None
                  else int(np.asarray(seg.scols).size))
        n_win = int(((ctrl[:, 0] >= 0) & (ctrl[:, 10] == 1)).sum()) if n_rq else 0
        plan_b += 4 * (staged + 3 * seg.n_steps + n_win * n_rq)
        # the work list: each group slot, and (3 words each) at most one
        # unit per slot and one per output block, and the split blocks
        slots, blocks = seg.n_steps * (plan.T // _L), seg.n_tiles * -(-plan.R // _L)
        plan_b += 4 * (slots + 3 * (slots + blocks) + blocks)
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


def bf16_pair(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo): float32 arrays holding the bf16 rounding of ``v`` and the
    bf16 rounding of the residual, as the JAX package splits plan values
    (round to nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    hi = t.to(torch.bfloat16).to(torch.float32)
    lo = (t - hi).to(torch.bfloat16).to(torch.float32)
    return hi.numpy(), lo.numpy()


def _lane_groups_multihot(win_pos, rows, R):
    """One lane per (output row, 128-row window block): win_pos-sorted
    entries dedup to lanes carrying 128-bit selection masks, so a row's
    repeats within a block ride one lane. Returns
    (masks (n_grp,4,128) int32, lrow (n_grp,128), blk_of (n_grp,))."""
    m = win_pos.shape[0]
    if m == 0:
        return (np.zeros((0, 4, _L), np.int32),
                np.zeros((0, _L), np.int32), np.zeros((0,), np.int32))
    blk = win_pos // _L
    bit = win_pos - blk * _L
    # lane key = (block, row): entries are block-sorted already; sort
    # within a block by row to group pairs
    key = blk * np.int64(2 ** 32) + rows
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    bit_s = bit[order]
    boundary = np.empty(m, dtype=bool)
    boundary[0] = True
    boundary[1:] = key_s[1:] != key_s[:-1]
    lane_of = np.cumsum(boundary) - 1
    n_lanes = int(lane_of[-1]) + 1
    lane_blk = blk[order][boundary]
    lane_row = rows[order][boundary]
    words = np.zeros((n_lanes, 4), np.uint32)
    np.bitwise_or.at(
        words, (lane_of, bit_s // 32),
        (np.uint32(1) << (bit_s % 32).astype(np.uint32)))
    # group lanes per block into 128-lane groups (pad: mask 0, row R)
    bnd = np.nonzero(np.diff(lane_blk))[0] + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [n_lanes]])
    lens = ends - starts
    plens = -(-lens // _L) * _L
    out_off = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(plens, out=out_off[1:])
    total = int(out_off[-1])
    runid = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    dst = out_off[runid] + (np.arange(n_lanes, dtype=np.int64) - starts[runid])
    masks = np.zeros((total, 4), np.uint32)
    lrow = np.full(total, R, dtype=np.int32)
    masks[dst] = words
    lrow[dst] = lane_row.astype(np.int32)
    blk_of = np.repeat(lane_blk[starts].astype(np.int32), plens // _L)
    # (n_grp, 4, 128): word-major, lanes along the last dim
    masks = masks.reshape(-1, _L, 4).transpose(0, 2, 1).astype(np.int32)
    return masks, lrow.reshape(-1, _L), blk_of


def _lane_groups(win_pos, rows, vals, R):
    """Cut (sorted win_pos) lanes at 128-row window boundaries; pad runs to
    full 128-lane groups. Returns (lidx, lrow, val, blk_of) per group."""
    m = win_pos.shape[0]
    if m == 0:
        return (np.zeros((0, _L), np.int32), np.zeros((0, _L), np.int32),
                np.zeros((0, _L), np.float32), np.zeros((0,), np.int32))
    blk = win_pos // _L
    bnd = np.nonzero(np.diff(blk))[0] + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [m]])
    lens = ends - starts
    plens = -(-lens // _L) * _L
    out_off = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(plens, out=out_off[1:])
    total = int(out_off[-1])
    runid = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    dst = out_off[runid] + (np.arange(m, dtype=np.int64) - starts[runid])

    lidx = np.zeros(total, dtype=np.int32)
    lrow = np.full(total, R, dtype=np.int32)  # R = padding sentinel
    val = np.zeros(total, dtype=np.float32)
    lidx[dst] = (win_pos - blk * _L).astype(np.int32)
    lrow[dst] = rows.astype(np.int32)
    if vals is not None:
        val[dst] = vals
    blk_of = np.repeat(blk[starts].astype(np.int32), plens // _L)
    return (lidx.reshape(-1, _L), lrow.reshape(-1, _L),
            val.reshape(-1, _L), blk_of)


def _build_groups(wp_p, rr_p, vv_p, use_rank1, R, G, window):
    """Lane groups for one (virtual) tile, padded to a G multiple.

    ``window=False``: groups in source-block order; dst rows span the
    whole R-row tile. ``window=True``: lanes are partitioned by
    destination 128-row window first (dw = row // 128) and each partition
    is padded to a G multiple, so every step's G groups share one dst
    window. Returns a 5th per-group array ``dwg`` (dst window of the
    group; 0 when window=False)."""
    parts = []
    if window:
        dwp = rr_p // _L
        splits = [(dw, dwp == dw) for dw in range(-(-R // _L))]
    else:
        splits = [(0, slice(None))]
    for dw, sel in splits:
        if window and not np.any(sel):
            continue
        rloc = (rr_p[sel] - dw * _L) if window else rr_p
        sent = _L if window else R
        if use_rank1:
            li, lr, bo = _lane_groups_multihot(wp_p[sel], rloc, sent)
            lv = np.zeros((li.shape[0], _L), np.float32)
        else:
            li, lr, lv, bo = _lane_groups(wp_p[sel], rloc,
                                          vv_p[sel] if vv_p is not None else None, sent)
        pad_g = -li.shape[0] % G
        if pad_g:
            li = np.concatenate([li, np.zeros((pad_g,) + li.shape[1:], np.int32)])
            lr = np.concatenate([lr, np.full((pad_g, _L), sent, np.int32)])
            lv = np.concatenate([lv, np.zeros((pad_g, _L), np.float32)])
            bo = np.concatenate([bo, np.zeros(pad_g, np.int32)])
        parts.append((li, lr, lv, bo, np.full(li.shape[0], dw, np.int32)))
    if not parts or sum(p[0].shape[0] for p in parts) == 0:
        shp = (G, 4, _L) if use_rank1 else (G, _L)
        return (np.zeros(shp, np.int32),
                np.full((G, _L), _L if window else R, np.int32),
                np.zeros((G, _L), np.float32), np.zeros(G, np.int32),
                np.zeros(G, np.int32))
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(5))


def _aligned_cold_positions(uniq: np.ndarray, stage_tier: int,
                            cq: int = _CQ) -> np.ndarray:
    """Positions of sorted cold columns in the tile's run-aligned staged
    space: each per-tier run starts on a cq-row boundary."""
    if uniq.shape[0] == 0:
        return np.zeros(0, np.int64)
    tiers = uniq // stage_tier
    bnd = np.nonzero(np.diff(tiers))[0] + 1
    starts = np.concatenate([[0], bnd])
    lens = np.diff(np.concatenate([starts, [uniq.shape[0]]]))
    alens = -(-lens // cq) * cq
    base = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(alens, out=base[1:])
    runid = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    return base[runid] + (np.arange(uniq.shape[0], dtype=np.int64) - starts[runid])


def _piece_take_entries(uniq: np.ndarray, stage_tier: int,
                        lo: int, hi: int, cq: int = _CQ):
    """Take entries for aligned-space rows [lo, hi) of a tile: per
    cq-block tier ids (n_blocks,) and tier-local indices (n_blocks*cq,)
    (run pads repeat the run's first index; the piece is padded to a
    128-row multiple by repeating its first block)."""
    if uniq.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    tiers = uniq // stage_tier
    bnd = np.nonzero(np.diff(tiers))[0] + 1
    starts = np.concatenate([[0], bnd])
    lens = np.diff(np.concatenate([starts, [uniq.shape[0]]]))
    alens = -(-lens // cq) * cq
    base = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(alens, out=base[1:])
    total = int(base[-1])
    runid = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    dst = base[runid] + (np.arange(uniq.shape[0], dtype=np.int64) - starts[runid])
    local = (uniq - tiers * stage_tier).astype(np.int32)
    head = local[starts]
    filled = np.repeat(head, alens)
    filled[dst] = local
    tier_of_row = np.repeat(tiers[starts], alens)
    lo_c, hi_c = lo, min(hi, total)
    if lo_c >= hi_c:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    take_idx = filled[lo_c:hi_c]
    take_tier = tier_of_row[lo_c:hi_c:cq]  # per block (runs are aligned)
    pad_rows = -take_idx.shape[0] % _L
    if pad_rows:
        nb = pad_rows // cq
        take_idx = np.concatenate([take_idx, np.tile(take_idx[:cq], nb)])
        take_tier = np.concatenate([take_tier, np.repeat(take_tier[:1], nb)])
    return take_tier.astype(np.int64), take_idx


def choose_hot(csr: CSR, R: int, hot_budget: int, min_run: int,
               touch: Optional[np.ndarray] = None) -> np.ndarray:
    """Pick hot columns: sort by tile-touch count, keep 128-blocks while the
    average lanes-per-tile-per-block stays >= min_run.

    Returns global col ids, sorted. The tile-touch count (how many R-row
    tiles reference the column) is what the column would otherwise cost in
    staged rows; pass it precomputed (a bincount of the native pass-1
    per-tile unique lists) to skip the unique over every (tile, col) key.
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    n_tiles = max(-(-n // R), 1)
    if touch is None:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        tiles = rows // R
        key = tiles * m + cols
        uniq_key = np.unique(key)
        touch = np.bincount((uniq_key % m).astype(np.int64), minlength=m)
    # in-reference count per column (lanes a hot block would serve)
    refs = np.bincount(cols, minlength=m)
    order = np.argsort(-touch, kind="stable")
    max_hot = min(hot_budget, m) // _L * _L
    if max_hot == 0:
        return np.zeros(0, np.int64)
    cand = order[:max_hot]
    keep = 0
    for b in range(max_hot // _L):
        blk_refs = refs[cand[b * _L:(b + 1) * _L]].sum()
        if blk_refs / n_tiles < min_run:
            break
        keep = b + 1
    # sorted by node id: on community-contiguous orderings hubs of one
    # community then share a hot 128-block
    return np.sort(cand[: keep * _L])


def coalesce_duplicates(csr: CSR) -> CSR:
    """Merge duplicate (row, col) entries by summing values (a mask bit has
    no multiplicity)."""
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols_all = np.asarray(csr.cols, dtype=np.int64)
    vals_all = np.asarray(csr.vals, dtype=np.float32)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    key = rows_all * m + cols_all
    if key.shape[0] and bool(np.all(key[1:] >= key[:-1])):
        vals_s, ks = vals_all, key  # row-sorted cols: no sort needed
    elif key.shape[0]:
        order = np.argsort(key, kind="stable")
        ks = key[order]
        vals_s = vals_all[order]
    else:
        vals_s, ks = vals_all, key
    if not (ks.shape[0] and int((ks[1:] == ks[:-1]).sum())):
        return csr
    keep = np.concatenate([[True], ks[1:] != ks[:-1]])
    seg_id = np.cumsum(keep) - 1
    vals_c = np.zeros(int(seg_id[-1]) + 1, np.float32)
    np.add.at(vals_c, seg_id, vals_s)
    ku = ks[keep]
    rows_u = ku // m
    cols_u = ku - rows_u * m
    indptr2 = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows_u, minlength=n), out=indptr2[1:])
    return CSR(indptr=indptr2, cols=cols_u.astype(np.int32),
               vals=vals_c, shape=csr.shape)


def factor_rank1(csr: CSR, rtol: float = 1e-6):
    """vals[e] = r[row[e]] * c[col[e]] detection (sparse/expansion2.py)."""
    from of_spmm_tpu_torch.sparse.expansion2 import factor_rank1 as _f

    return _f(csr, rtol=rtol)


def tile_lanes(nat, csr: CSR, t: int, R: int, use_rank1: bool):
    """Tile t's edges as (tile-local rows, global cols, values or None,
    sorted unique cols, inverse of each edge into them), from the native
    pass-1 (``nat``) when it ran, else from the CSR in numpy."""
    n = csr.shape[0]
    r0, r1 = t * R, min((t + 1) * R, n)
    if nat is not None:
        lane_inv, lane_row, lane_val, uniq_all, uniq_ptr = nat
        indptr = np.asarray(csr.indptr, dtype=np.int64)
        lo, hi = indptr[r0], indptr[r1]
        uniq_t = uniq_all[uniq_ptr[t]:uniq_ptr[t + 1]].astype(np.int64)
        inv = lane_inv[lo:hi].astype(np.int64)
        r = lane_row[lo:hi].astype(np.int64)
        v = None if use_rank1 else lane_val[lo:hi]
        return r, uniq_t[inv], v, uniq_t, inv
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    lo, hi = indptr[r0], indptr[r1]
    c = np.asarray(csr.cols[lo:hi], dtype=np.int64)
    v = None if use_rank1 else np.asarray(csr.vals[lo:hi], dtype=np.float32)
    r = np.repeat(np.arange(r1 - r0, dtype=np.int64), np.diff(indptr[r0:r1 + 1]))
    uniq_t, inv = np.unique(c, return_inverse=True)
    return r, c, v, uniq_t, inv


def build_fused_plan(
    csr: CSR,
    R: int = DEFAULT_R,
    T: Optional[int] = None,
    hot_budget: int = DEFAULT_HOT_BUDGET,
    hot_min_run: int = DEFAULT_HOT_MIN_RUN,
    seg_steps: int = DEFAULT_SEG_STEPS,
    rank1: Optional[bool] = None,
    dma_wave: int = 64,
    s_cap: int = S_CAP,
    staging: str = "chunks",
    stage_tier: int = 32768,
    window: bool = False,
    cq: int = _CQ,
    hbm_limit: Optional[int] = None,
) -> FusedPlan:
    """Host-side fused-engine plan build (numpy + the native pass-1).

    ``staging="rows"`` stages each cold column as its own X row;
    ``"chunks"`` stages cq-row blocks of a per-segment tier-major take
    table. Chunks-mode segments are cut so that the JAX package's peak
    model fits ``hbm_limit`` (default: device_hbm_bytes), shrinking the
    per-segment table cap until it fits or raising CapacityError."""
    if staging not in ("rows", "chunks"):
        raise ValueError(f"staging must be rows|chunks, got {staging!r}")
    if T is None:
        from of_spmm_tpu_torch.utils.config import FLAGS

        T = int(FLAGS.get("OFS_FUSED_T")) or (
            _BIG_T if csr.nnz >= _BIG_T_NNZ else DEFAULT_T)
    n, m = csr.shape
    G = T // _L
    n_tiles = max(-(-n // R), 1)

    csr = coalesce_duplicates(csr)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols_all = np.asarray(csr.cols, dtype=np.int64)
    vals_all = np.asarray(csr.vals, dtype=np.float32)

    factors = factor_rank1(csr) if rank1 in (None, True) else None
    if rank1 is True and factors is None:
        raise ValueError("rank1=True but values do not factor as r_i*c_j")
    use_rank1 = factors is not None
    row_scale = col_scale = None
    if use_rank1:
        row_scale, col_scale = factors

    # per-tile column sort + unique runs in the native planner when it
    # builds; numpy per tile otherwise. The tile-touch counts of the hot
    # choice come from its unique lists.
    from of_spmm_tpu_torch import native

    nat = native.expansion_pass1(indptr, cols_all, vals_all.astype(np.float32), R)
    touch = (np.bincount(nat[3][:nat[4][-1]].astype(np.int64), minlength=m)
             if nat is not None else None)
    hot_ids = choose_hot(csr, R, hot_budget, hot_min_run, touch=touch)
    H = hot_ids.shape[0]
    hot_rank = np.full(m, -1, dtype=np.int64)
    hot_rank[hot_ids] = np.arange(H, dtype=np.int64)

    tiles_meta = []   # (stage_cols, lidx, lrow, val, blk_of, dwg) per virtual tile
    out_of = []       # output block (real tile) per meta entry
    first_piece = []  # True on the first virtual tile of each output block
    n_staged = 0
    n_lanes = 0
    for t in range(n_tiles):
        r, c, v, uniq_t, inv = tile_lanes(nat, csr, t, R, use_rank1)
        hr_u = hot_rank[uniq_t]
        cold_mask = hr_u < 0
        uniq = uniq_t[cold_mask]
        # window position per unique col: hot rank, or H + staged position
        if staging == "chunks":
            cpos = _aligned_cold_positions(uniq, stage_tier, cq)
            upos = np.zeros(uniq_t.shape[0], np.int64)
            upos[cold_mask] = H + cpos
            upos[~cold_mask] = hr_u[~cold_mask]
        else:
            cold_pos = np.cumsum(cold_mask) - 1
            upos = np.where(cold_mask, H + cold_pos, hr_u)
        win_pos = upos[inv]
        order = np.argsort(win_pos, kind="stable")
        wp = win_pos[order]
        rr = r[order]
        vv = None if use_rank1 else v[order]
        # hub tiles whose staged list exceeds s_cap split into virtual
        # tiles (same output block, separate staging rounds); lanes are
        # win_pos-sorted, so each piece's lanes are contiguous
        n_pieces = max(1, -(-max(uniq.shape[0], 1) // s_cap))
        for piece in range(n_pieces):
            if n_pieces == 1:
                wp_p, rr_p, vv_p, uniq_p = wp, rr, vv, uniq
            else:
                lo_pos = H + piece * s_cap
                hi_pos = H + (piece + 1) * s_cap
                if piece == 0:
                    sel = wp < hi_pos  # includes all hot lanes
                else:
                    sel = (wp >= lo_pos) & (wp < hi_pos)
                wp_p = wp[sel].copy()
                wp_p[wp_p >= H] -= piece * s_cap
                rr_p = rr[sel]
                vv_p = None if use_rank1 else vv[sel]
                uniq_p = uniq[piece * s_cap:(piece + 1) * s_cap]
            li, lr, lv, bo, dwg = _build_groups(wp_p, rr_p, vv_p, use_rank1, R, G, window)
            if staging == "chunks":
                take_t, take_idx = _piece_take_entries(
                    uniq, stage_tier, piece * s_cap, (piece + 1) * s_cap, cq)
                uniq_p = (take_t, take_idx)  # per-block tier + tier-local idx
                staged_rows = take_idx.shape[0]
            else:
                # pad the staged list to a 128 multiple (col 0 repeats)
                pad_s = -uniq_p.shape[0] % _L
                if pad_s:
                    uniq_p = np.concatenate([uniq_p, np.zeros(pad_s, uniq_p.dtype)])
                staged_rows = uniq_p.shape[0]
            tiles_meta.append((uniq_p, li, lr, lv, bo, dwg))
            out_of.append(t)
            first_piece.append(piece == 0)
            n_staged += staged_rows
            n_lanes += li.shape[0] * _L

    # --- steps per tile and the per-step copy quota -----------------------
    n_meta = len(tiles_meta)

    def staged_of(t):
        u = tiles_meta[t][0]
        return u[1].shape[0] if isinstance(u, tuple) else u.shape[0]

    dma_quantum = cq if staging == "chunks" else 1
    dma_cap = (32 * max(T // 1024, 1)) if staging == "chunks" else DMAX_CAP
    steps_of = []
    for t in range(n_meta):
        need_c = max(tiles_meta[t][1].shape[0] // G, 1)
        nxt = staged_of(t + 1) if t + 1 < n_meta else 0
        need_s = -(-(nxt // dma_quantum) // dma_cap)
        steps_of.append(max(need_c, need_s, 1))
    # pad lane arrays of tiles whose step count grew
    for t in range(n_meta):
        uniq, li, lr, lv, bo, dwg = tiles_meta[t]
        pad_g = steps_of[t] * G - li.shape[0]
        if pad_g > 0:
            sent = _L if window else R
            li = np.concatenate([li, np.zeros((pad_g,) + li.shape[1:], np.int32)])
            lr = np.concatenate([lr, np.full((pad_g, _L), sent, np.int32)])
            lv = np.concatenate([lv, np.zeros((pad_g, _L), np.float32)])
            bo = np.concatenate([bo, np.zeros(pad_g, np.int32)])
            dwg = np.concatenate([dwg, np.zeros(pad_g, np.int32)])
            tiles_meta[t] = (uniq, li, lr, lv, bo, dwg)
            n_lanes += pad_g * _L
    S_buf = max(max(staged_of(t) for t in range(n_meta)), _L)
    if S_buf > s_cap + _L:
        raise AssertionError((S_buf, s_cap))
    S_buf += -S_buf % 2048 if S_buf > 2048 else -S_buf % _L
    # DMAX: tile t+1's staged rows spread over tile t's steps (a segment's
    # first tile over a prologue sized like its own step count)
    DMAX = dma_wave if staging == "rows" else 1
    for t in range(n_meta):
        budget_steps = min(steps_of[t - 1], steps_of[t]) if t else steps_of[0]
        need = -(-(staged_of(t) // dma_quantum) // budget_steps)
        if staging == "rows":
            need += -need % dma_wave  # per-step counts round to waves
        DMAX = max(DMAX, need)
    if staging == "rows":
        DMAX += -DMAX % dma_wave

    # --- per-segment staged-table cap from the memory budget --------------
    stage_cap_rows = None
    min_cap = _L
    if staging == "chunks":
        hbm = hbm_limit or device_hbm_bytes()
        n_groups = n_lanes // _L
        fixed = (
            n_groups * ((4 * _L * 4) if use_rank1 else (_L * 4))  # lidx
            + n_groups * _L * 4                                   # lrow
            + (0 if use_rank1 else n_groups * _L * 4)             # val hi/lo
            + sum(steps_of) * 4 * (16 + 2 * DMAX + G + 1)         # ctrl/scols/...
            + n_staged * 4                                        # take idx
            + m * _L * 4 * 2                                      # x + slab
            + 2 * n_tiles * R * _L * 4                            # outputs
            + H * 512                                             # hot
        )
        avail = int(_BUDGET_FRACTION * hbm) - fixed
        stage_cap_rows = int(avail / (512 * _TABLE_HEADROOM))
        # a tile's pieces cannot be cut apart: the cap never goes below
        # the largest single tile's staged rows
        group_rows = {}
        for t in range(n_meta):
            group_rows[out_of[t]] = group_rows.get(out_of[t], 0) + staged_of(t)
        min_cap = max(group_rows.values(), default=_L)
        stage_cap_rows = max(stage_cap_rows, min_cap)

    # --- emit segments (cut only at real-tile boundaries) -----------------
    def emit_all(cap):
        segments = []
        seg_start = 0
        while seg_start < n_meta:
            seg_tiles = [seg_start]
            total = steps_of[seg_start] * 2  # prologue + t0
            stage_sum = staged_of(seg_start)
            while seg_tiles[-1] + 1 < n_meta:
                nxt = seg_tiles[-1] + 1
                fits_next = (total + steps_of[nxt] <= seg_steps
                             and (cap is None or stage_sum + staged_of(nxt) <= cap))
                if not (fits_next or not first_piece[nxt]):
                    break
                seg_tiles.append(nxt)
                total += steps_of[nxt]
                stage_sum += staged_of(nxt)
            segments.append(
                _emit_segment(tiles_meta, seg_tiles, steps_of, out_of,
                              first_piece, R, T, G, S_buf, DMAX, use_rank1,
                              staging=staging, stage_tier=stage_tier,
                              window=window, cq=cq))
            seg_start = seg_tiles[-1] + 1
        return segments

    def mk_plan(segments):
        return FusedPlan(
            segments=tuple(segments),
            hot_ids=hot_ids.astype(np.int32),
            row_scale=(row_scale.astype(np.float32) if use_rank1 else None),
            col_scale=(col_scale.astype(np.float32) if use_rank1 else None),
            shape=csr.shape,
            R=R, T=T, multihot=use_rank1, staging=staging,
            stage_tier=stage_tier, S_buf=int(S_buf), DMAX=int(DMAX),
            n_staged=int(n_staged), n_lanes=int(n_lanes), window=window,
            cq=cq,
        )

    plan = mk_plan(emit_all(stage_cap_rows))
    if staging == "chunks":
        # validate against the model; splitting adds per-segment prologue
        # steps the estimate cannot see, so shrink the cap by the measured
        # overshoot and re-emit until it fits or the cap reaches the
        # largest uncuttable tile -- then refuse
        for _ in range(4):
            rep = _staging_model_report(plan, hbm_limit)
            if rep["fits"]:
                break
            table_budget = rep["budget_bytes"] - (
                rep["peak_bytes"] - int(_TABLE_HEADROOM * rep["max_table_bytes"]))
            new_cap = int(table_budget / (512 * _TABLE_HEADROOM))
            if new_cap >= stage_cap_rows:
                new_cap = stage_cap_rows // 2
            if table_budget <= 0 or new_cap < min_cap:
                break
            stage_cap_rows = new_cap
            plan = mk_plan(emit_all(stage_cap_rows))
        rep = _staging_model_report(plan, hbm_limit)
        if not rep["fits"]:
            raise CapacityError(
                f"fused plan cannot fit device memory: peak "
                f"{rep['peak_bytes'] / 2**30:.2f} GiB > budget "
                f"{rep['budget_bytes'] / 2**30:.2f} GiB "
                f"({_BUDGET_FRACTION:.0%} of {rep['hbm_bytes'] / 2**30:.1f} GiB) "
                f"in the staged-table model; reduce R/T, raise hot_budget, "
                f"or use staging='rows' / layout='tiered'.")
    rep = plan_memory_report(plan, d=_L, hbm_limit=hbm_limit)
    if not rep["fits"]:
        raise CapacityError(
            f"fused plan cannot fit device memory: peak "
            f"{rep['peak_bytes'] / 2**30:.2f} GiB > budget "
            f"{rep['budget_bytes'] / 2**30:.2f} GiB; use layout='tiered'.")
    return plan


def _emit_segment(tiles_meta, seg_tiles, steps_of, out_of, first_piece,
                  R, T, G, S_buf, DMAX, rank1,
                  staging="rows", stage_tier=32768,
                  window=False, cq=_CQ):  # noqa: C901
    """Lay out one segment's step stream: a prologue staging the first
    tile, then per tile its compute steps, which also stage the next
    tile."""
    multihot = rank1
    chunks = staging == "chunks"
    S_blocks = S_buf // cq if chunks else S_buf // _L

    if chunks:
        # tier-major take table: per tier, per segment tile, its blocks;
        # per_tier_src[j] maps tile j's local block -> table block
        n_tiers_tot = 0
        for t in seg_tiles:
            tt = tiles_meta[t][0][0]
            if tt.shape[0]:
                n_tiers_tot = max(n_tiers_tot, int(tt.max()) + 1)
        per_tier_idx = [[] for _ in range(n_tiers_tot)]
        per_tier_src = {}
        for j, t in enumerate(seg_tiles):
            take_tier, take_idx = tiles_meta[t][0]
            src_map = np.zeros(take_tier.shape[0], np.int64)
            per_tier_src[j] = src_map
            for b in range(take_tier.shape[0]):
                per_tier_idx[int(take_tier[b])].append((j, b, take_idx[b * cq:(b + 1) * cq]))
        table_blk = 0
        tier_ptr = [0]
        take_list = []
        for tier in range(n_tiers_tot):
            for (j, b, idx) in per_tier_idx[tier]:
                per_tier_src[j][b] = table_blk
                take_list.append(idx)
                table_blk += 1
            tier_ptr.append(table_blk * cq)
        stage_take = (np.concatenate(take_list).astype(np.int32)
                      if take_list else np.zeros(0, np.int32))
        stage_tier_ptr = tuple(tier_ptr)
    first = seg_tiles[0]
    prologue = steps_of[first]
    n_steps = prologue + sum(steps_of[t] for t in seg_tiles)

    ctrl = np.zeros((n_steps, 1, 16), np.int32)
    scols = (np.zeros((n_steps, 2, DMAX), np.int32) if chunks
             else np.zeros((n_steps, DMAX), np.int32))
    lidx = (np.zeros((n_steps * G, 4, _L), np.int32) if multihot
            else np.zeros((n_steps * G, _L), np.int32))
    lrow = np.full((n_steps * G, _L), R, np.int32)
    blk = np.zeros((n_steps, 1, G), np.int32)
    tile_of = np.zeros(n_steps, np.int32)
    lval = None if rank1 else np.zeros((n_steps * G, _L), np.float32)

    def fill_staging(tile, step_lo, step_hi, parity):
        if chunks:
            # spread the tile's cq-row block copies over the steps
            j = seg_tiles.index(tile)
            src = per_tier_src[j]
            n_blk = src.shape[0]
            nsteps = step_hi - step_lo
            per = -(-n_blk // nsteps) if n_blk else 0
            pos = 0
            for s in range(step_lo, step_hi):
                cnt = max(min(per, n_blk - pos), 0)
                if cnt:
                    scols[s, 0, :cnt] = src[pos:pos + cnt]
                    scols[s, 1, :cnt] = parity * S_blocks + np.arange(pos, pos + cnt)
                ctrl[s, 0, 3] = cnt
                pos += cnt
            return
        # per-step counts are rounded to 64-row waves; a chunk's tail
        # re-copies the chunk's first rows (rewritten by the next step)
        stage_cols = tiles_meta[tile][0]
        nsteps = step_hi - step_lo
        per = -(-stage_cols.shape[0] // nsteps) if stage_cols.shape[0] else 0
        per += -per % 64
        pos = 0
        for s in range(step_lo, step_hi):
            cnt = max(min(per, stage_cols.shape[0] - pos), 0)
            pad = -cnt % 64
            if cnt:
                scols[s, :cnt] = stage_cols[pos:pos + cnt]
                if pad:
                    scols[s, cnt:cnt + pad] = stage_cols[pos:pos + pad]
            ctrl[s, 0, 2] = parity * S_buf + pos
            ctrl[s, 0, 3] = cnt + pad
            pos += cnt

    # prologue: stage the first tile into parity 0; no compute
    ctrl[:prologue, 0, 0] = -1
    fill_staging(first, 0, prologue, 0)

    out_base = out_of[seg_tiles[0]]
    step = prologue
    for j, t in enumerate(seg_tiles):
        ns = steps_of[t]
        uniq, li, lr, lv, bo, dwg = tiles_meta[t]
        ctrl[step:step + ns, 0, 0] = out_of[t] - out_base
        ctrl[step, 0, 1] = 1  # first step of a (virtual) tile
        ctrl[step, 0, 9] = 1 if first_piece[t] else 0  # zero output
        ctrl[step, 0, 8] = (0 if chunks else uniq.shape[0])
        ctrl[step:step + ns, 0, 5] = (j % 2) * S_buf
        if window:
            ctrl[step:step + ns, 0, 10] = dwg.reshape(ns, G)[:, 0]
        tile_of[step:step + ns] = out_of[t] - out_base
        lidx[step * G:(step + ns) * G] = li
        lrow[step * G:(step + ns) * G] = lr
        blk[step:step + ns, 0, :] = bo.reshape(ns, G)
        if not rank1:
            lval[step * G:(step + ns) * G] = lv
        if j + 1 < len(seg_tiles):
            fill_staging(seg_tiles[j + 1], step, step + ns, (j + 1) % 2)
        step += ns

    # previous step's staging (the TPU kernel waits one step behind)
    ctrl[1:, 0, 6] = ctrl[:-1, 0, 3]
    ctrl[1:, 0, 7] = ctrl[:-1, 0, 2]

    val_hi = val_lo = None
    if not rank1:
        val_hi, val_lo = bf16_pair(lval)
    n_tiles = out_of[seg_tiles[-1]] - out_base + 1
    if chunks:
        return FusedSegment(ctrl=ctrl, scols=scols, lidx=lidx, lrow=lrow, blk=blk,
                            tile_of=tile_of, val_hi=val_hi, val_lo=val_lo,
                            stage_take=stage_take, stage_tier_ptr=stage_tier_ptr,
                            n_steps=n_steps, n_tiles=n_tiles)
    return FusedSegment(ctrl=ctrl, scols=scols.reshape(n_steps, 8, DMAX // 8), lidx=lidx,
                        lrow=lrow, blk=blk, tile_of=tile_of, val_hi=val_hi, val_lo=val_lo,
                        n_steps=n_steps, n_tiles=n_tiles)
