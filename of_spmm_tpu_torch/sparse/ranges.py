"""Range-staging SpMM plan: locality-aware windows copied from X.

The port of the JAX package's sparse/ranges.py. ``build_ranges_plan``
gives, on the same CSR, plan arrays equal to the JAX package's (the
tests hold them array for array), so the Hopper kernel
(ops/cuda/ranges.py, csrc/ranges.cu) runs the same plan as the TPU
kernel.

On a community-contiguous ordering the columns a 128-row output tile
references concentrate in a contiguous id band. So per tile the window
of X rows has three regions:

- HOT columns (graph-wide hubs), shared by every tile, as in the fused
  engine (sparse/fused.py);
- a RANGE [lo, lo + RC) of contiguous X rows, which the TPU kernel
  copies in RQ-row chunks into a double-buffered scratch. A range is kept
  across consecutive tiles while it still covers ~90% of what the tile's
  best window would (``_KEEP_FRAC``); range blocks a tile meets with
  fewer than ``min_block`` edges are demoted to the scattered path;
- the SCATTERED rest (unique per tile), which rides the fused engine's
  chunks transport: cq-row blocks of a per-segment tier-major take table.

The compute is the fused engine's: multi-hot (rank-1) or one-hot
(general values) lane groups over the window, scattered into the tile.
Placement replays the control stream into window provenance
(sparse/staged_windows.py), so the Hopper kernel reads window rows from X.

Reference semantics: gather x segment-sum
(oneflow/user/ops/gather_op.cpp:51-82,
oneflow/user/kernels/unsorted_segment_sum_kernel_util.cu:52-151).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.fused import (
    _L, _BIG_T_NNZ, DEFAULT_HOT_BUDGET, DEFAULT_HOT_MIN_RUN, DEFAULT_T,
    _aligned_cold_positions, _build_groups, _piece_take_entries, bf16_pair,
    choose_hot, coalesce_duplicates, factor_rank1, plan_memory_report, tile_lanes)

DEFAULT_R = 128
DEFAULT_RANGE_CAP = 12288    # rows per range window
DEFAULT_S_CAP = 8192         # scattered rows per tile (per parity)
DEFAULT_SEG_STEPS = 8192
DEFAULT_RQ = 1024            # rows per range-copy chunk
RMAX_CAP = 16                # range chunk copies per step
_BIG_T_RANGES = 2048         # lanes/step for graphs of >= _BIG_T_NNZ nnz
_KEEP_FRAC = 0.90            # keep the current range while it covers this
#                              fraction of the tile's best-window mass
DEFAULT_MIN_BLOCK = 48       # a tile keeps a range 128-row block only if
#                              >= this many of its edges land there; thin
#                              blocks' edges ride the scattered path


@dataclasses.dataclass(frozen=True)
class RangesSegment:
    """One kernel launch worth of steps (contiguous tiles + their ranges)."""

    ctrl: np.ndarray      # (steps, 1, 16) int32 per-step control words:
    #  [0] compute tile id (block index into segment output; -1 = none)
    #  [1] first-step-of-tile flag
    #  [3] scattered chunk-copy count this step (cq-row blocks)
    #  [4] range-copy count this step (RQ-row chunks)
    #  [5] scattered read base = parity*S_buf
    #  [6] prev-step scattered chunk count
    #  [9] zero-output flag (first step of first virtual tile)
    #  [10] first-step-of-range flag
    #  [11] range read parity base = parity*RC
    #  [12] prev-step range-copy count
    scols: np.ndarray     # (steps, 2, DMAX) int32 [src_blk | dst_blk] cq-row
    #                        block copies from the scattered take table
    rcopy: np.ndarray     # (steps, 2, RMAX) int32 [src X row | dst row in
    #                        the range scratch incl. parity] per RQ-row copy
    lidx: np.ndarray      # (steps*G, 128) int32 window-local index OR
    #                        multi-hot masks (steps*G, 4, 128) int32
    lrow: np.ndarray      # (steps*G, 128) int32 tile-local output row (R = pad)
    blk: np.ndarray       # (steps, 1, G) int32 window block (unified
    #                        [hot | range | scattered] space)
    tile_of: np.ndarray   # (steps,) int32 out block index
    val_hi: Optional[np.ndarray]  # (steps*G, 128) float32 holding the bf16
    val_lo: Optional[np.ndarray]  # pair of each value; None when rank-1
    stage_take: Optional[np.ndarray] = None   # tier-local take indices
    stage_tier_ptr: Optional[tuple] = None    # tier boundaries (python ints)
    n_steps: int = 0
    n_tiles: int = 0
    windows: Optional[object] = None   # port only: StagedWindows (placement)


@dataclasses.dataclass(frozen=True)
class RangesPlan:
    segments: Tuple[RangesSegment, ...]
    hot_ids: np.ndarray
    row_scale: Optional[np.ndarray]
    col_scale: Optional[np.ndarray]
    shape: Tuple[int, int]
    R: int
    T: int
    multihot: bool
    RC: int                # range window rows (per parity)
    S_buf: int             # scattered window rows (per parity)
    DMAX: int              # max scattered chunk copies per step
    RMAX: int              # max range chunk copies per step
    RQ: int                # rows per range copy
    n_ranges: int          # distinct ranges over the whole plan
    n_range_rows: int      # total rows moved by range copies
    n_scattered: int       # total scattered take rows (aligned + padded)
    n_lanes: int
    stage_tier: int = 32768  # tier size of the scattered take table
    cq: int = 32             # chunk quantum (rows per scattered copy)

    @property
    def n_hot(self) -> int:
        return int(self.hot_ids.shape[0])

    @property
    def rank1(self) -> bool:
        return self.row_scale is not None

    def padding_efficiency(self, true_nnz: int) -> float:
        return float(true_nnz) / max(self.n_lanes, 1)


def _best_window(cold_cols: np.ndarray, counts: np.ndarray, m: int,
                 rc: int) -> Tuple[int, int]:
    """(lo, mass) of the densest rc-row window over weighted cold cols.

    Sparse two-pointer over the sorted distinct cols, O(k) per tile."""
    if cold_cols.shape[0] == 0:
        return 0, 0
    pref = np.zeros(cold_cols.shape[0] + 1, np.int64)
    np.cumsum(counts, out=pref[1:])
    # a window starting at col c covers cols in [c, c+rc); the densest
    # window starts at a distinct col
    hi = np.searchsorted(cold_cols, cold_cols + rc, side="left")
    mass = pref[hi] - pref[np.arange(cold_cols.shape[0])]
    j = int(np.argmax(mass))
    lo = int(cold_cols[j])
    # snap to 128 and clamp so [lo, lo+rc) stays in [0, m)
    lo = min(max(lo // _L * _L, 0), max((m - rc) // _L * _L, 0))
    # the mass of the snapped window
    a = np.searchsorted(cold_cols, lo, side="left")
    b = np.searchsorted(cold_cols, lo + rc, side="left")
    return lo, int(pref[b] - pref[a])


def build_ranges_plan(
    csr: CSR,
    R: int = DEFAULT_R,
    T: Optional[int] = None,
    hot_budget: int = DEFAULT_HOT_BUDGET,
    hot_min_run: int = DEFAULT_HOT_MIN_RUN,
    seg_steps: int = DEFAULT_SEG_STEPS,
    range_cap: int = DEFAULT_RANGE_CAP,
    s_cap: int = DEFAULT_S_CAP,
    rank1: Optional[bool] = None,
    rq: int = DEFAULT_RQ,
    min_block: int = DEFAULT_MIN_BLOCK,
    stage_tier: int = 32768,
    cq: int = 32,
    seg_stage_cap: int = 3_000_000,
) -> RangesPlan:
    """Host-side range-staging plan build (numpy + the native pass-1)."""
    if T is None:
        from of_spmm_tpu_torch.utils.config import FLAGS

        T = int(FLAGS.get("OFS_FUSED_T")) or (
            _BIG_T_RANGES if csr.nnz >= _BIG_T_NNZ else DEFAULT_T)
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

    RC = min(range_cap, m // _L * _L)
    if RC < _L:
        RC = _L  # tiny graphs still get a 128-row window (clamped copies)
    RQ = rq if RC % rq == 0 else _L
    n_rq = RC // RQ

    from of_spmm_tpu_torch import native

    nat = native.expansion_pass1(indptr, cols_all, vals_all.astype(np.float32), R)
    touch = (np.bincount(nat[3][:nat[4][-1]].astype(np.int64), minlength=m)
             if nat is not None else None)
    hot_ids = choose_hot(csr, R, hot_budget, hot_min_run, touch=touch)
    H = hot_ids.shape[0]
    hot_rank = np.full(m, -1, dtype=np.int64)
    hot_rank[hot_ids] = np.arange(H, dtype=np.int64)

    # --- per-tile pass: classify cols, pick/keep ranges, build lanes ------
    tiles_meta = []    # (take entries, li, lr, lv, bo) per virtual tile
    out_of = []        # output block per meta entry
    first_piece = []
    range_of = []      # range index per meta entry
    range_lo = []      # lo per range index
    n_scattered = 0
    n_lanes = 0
    cur_range = -1
    for t in range(n_tiles):
        r, c, v, uniq_t, inv = tile_lanes(nat, csr, t, R, use_rank1)
        cnt_t = np.bincount(inv, minlength=uniq_t.shape[0])  # lanes per distinct col
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
            # thin-block demotion: keep only the range blocks where this
            # tile's edges fill lane groups densely enough
            rblk = (c[in_range] - lo_r) // _L
            per_blk = np.bincount(rblk, minlength=RC // _L)
            keep = np.zeros(c.shape[0], bool)
            keep[in_range] = (per_blk >= min_block)[rblk]
            in_range = keep
        is_scat = (~is_hot) & ~in_range
        scat_u, scat_inv = np.unique(c[is_scat], return_inverse=True)
        # scattered transport = the fused chunks machinery (run-aligned
        # staged space, per-piece take entries)
        cpos = _aligned_cold_positions(scat_u, stage_tier, cq)

        win_pos = np.empty(c.shape[0], dtype=np.int64)
        win_pos[is_hot] = hr[is_hot]
        win_pos[in_range] = H + (c[in_range] - lo_r)
        win_pos[is_scat] = H + RC + cpos[scat_inv]
        order = np.argsort(win_pos, kind="stable")
        wp = win_pos[order]
        rr = r[order]
        vv = None if use_rank1 else v[order]

        # scattered overflow: virtual tiles (pieces after the first carry
        # only the scattered tail; hot and range stay in piece 0)
        n_aligned = int(cpos[-1]) + 1 if cpos.shape[0] else 0
        n_pieces = max(1, -(-max(n_aligned, 1) // s_cap))
        for piece in range(n_pieces):
            if n_pieces == 1:
                wp_p, rr_p, vv_p = wp, rr, vv
            else:
                lo_pos = H + RC + piece * s_cap
                hi_pos = H + RC + (piece + 1) * s_cap
                if piece == 0:
                    sel = wp < hi_pos
                else:
                    sel = (wp >= lo_pos) & (wp < hi_pos)
                wp_p = wp[sel].copy()
                wp_p[wp_p >= H + RC] -= piece * s_cap
                rr_p = rr[sel]
                vv_p = None if use_rank1 else vv[sel]
            li, lr_, lv, bo, _dwg = _build_groups(wp_p, rr_p, vv_p, use_rank1, R, G, False)
            take_t, take_idx = _piece_take_entries(
                scat_u, stage_tier, piece * s_cap, (piece + 1) * s_cap, cq)
            tiles_meta.append(((take_t, take_idx), li, lr_, lv, bo))
            out_of.append(t)
            first_piece.append(piece == 0)
            range_of.append(cur_range)
            n_scattered += take_idx.shape[0]
            n_lanes += li.shape[0] * _L

    n_meta = len(tiles_meta)

    def staged_of(t):
        return tiles_meta[t][0][1].shape[0]

    # --- steps per tile + scattered chunk quota (the fused chunks policy)
    dma_cap = 32 * max(T // 1024, 1)
    steps_of = []
    for t in range(n_meta):
        need_c = max(tiles_meta[t][1].shape[0] // G, 1)
        nxt = staged_of(t + 1) if t + 1 < n_meta else 0
        need_s = -(-(nxt // cq) // dma_cap)
        steps_of.append(max(need_c, need_s, 1))
    for t in range(n_meta):
        take, li, lr_, lv, bo = tiles_meta[t]
        pad_g = steps_of[t] * G - li.shape[0]
        if pad_g > 0:
            li = np.concatenate([li, np.zeros((pad_g,) + li.shape[1:], np.int32)])
            lr_ = np.concatenate([lr_, np.full((pad_g, _L), R, np.int32)])
            lv = np.concatenate([lv, np.zeros((pad_g, _L), np.float32)])
            bo = np.concatenate([bo, np.zeros(pad_g, np.int32)])
            tiles_meta[t] = (take, li, lr_, lv, bo)
            n_lanes += pad_g * _L
    S_buf = max(max((staged_of(t) for t in range(n_meta)), default=_L), _L)
    S_buf += -S_buf % _L
    DMAX = 1
    for t in range(n_meta):
        budget_steps = min(steps_of[t - 1], steps_of[t]) if t else steps_of[0]
        DMAX = max(DMAX, -(-(staged_of(t) // cq) // budget_steps))

    # --- segment layout: cut at tile boundaries; bound the per-segment
    # scattered take table (seg_stage_cap rows) and the steps
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
            # cut at any tile (first-piece) boundary once a cap is hit: the
            # new segment's prologue re-stages the active range
            if not fits and first_piece[nxt]:
                break
            seg_tiles.append(nxt)
            total += steps_of[nxt]
            stage_sum += staged_of(nxt)
        seg_lists.append(seg_tiles)
        seg_start = seg_tiles[-1] + 1

    # RMAX from the emission spans: within a segment, a range's copies
    # spread over the previous range's local step span minus one
    RMAX = 1
    for seg_tiles in seg_lists:
        spans = []
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
        _emit_segment(tiles_meta, seg_tiles, steps_of, out_of, first_piece, range_of,
                      range_lo, R, T, G, S_buf, DMAX, RMAX, RQ, RC, m, use_rank1,
                      stage_tier=stage_tier, cq=cq)
        for seg_tiles in seg_lists
    ]

    plan = RangesPlan(
        segments=tuple(segments),
        hot_ids=hot_ids.astype(np.int32),
        row_scale=(row_scale.astype(np.float32) if use_rank1 else None),
        col_scale=(col_scale.astype(np.float32) if use_rank1 else None),
        shape=csr.shape,
        R=R, T=T, multihot=use_rank1,
        RC=int(RC), S_buf=int(S_buf), DMAX=int(DMAX), RMAX=int(RMAX),
        RQ=int(RQ), n_ranges=len(range_lo),
        n_range_rows=len(range_lo) * int(RC),
        n_scattered=int(n_scattered), n_lanes=int(n_lanes),
        stage_tier=int(stage_tier), cq=int(cq),
    )
    rep = plan_memory_report(plan)
    if not rep["fits"]:
        from of_spmm_tpu_torch.utils.errors import CapacityError

        raise CapacityError(
            f"ranges plan cannot fit device memory: peak "
            f"{rep['peak_bytes'] / 2**30:.2f} GiB > budget "
            f"{rep['budget_bytes'] / 2**30:.2f} GiB; reduce seg_steps or "
            f"use layout='fused'/'tiered'.")
    return plan


def _emit_segment(tiles_meta, seg_tiles, steps_of, out_of, first_piece,
                  range_of, range_lo, R, T, G, S_buf, DMAX, RMAX, RQ, RC,
                  m, rank1, stage_tier=32768, cq=32):  # noqa: C901
    """Lay out one segment's step stream: a prologue stages tile 0's
    scattered chunks and range 0's copies; then per tile, compute steps
    that also stage the next tile's scattered chunks; the steps of each
    range's tiles also carry the next range's copies (parity ping-pong)."""
    multihot = rank1
    S_blocks = S_buf // cq

    # tier-major scattered take table (the fused chunks layout)
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
    n_rq = RC // RQ
    # the prologue must fit range 0's copies with one spare step
    prologue = max(steps_of[first], -(-n_rq // RMAX) + 1)
    n_steps = prologue + sum(steps_of[t] for t in seg_tiles)

    ctrl = np.zeros((n_steps, 1, 16), np.int32)
    scols = np.zeros((n_steps, 2, DMAX), np.int32)
    rcopy = np.zeros((n_steps, 2, RMAX), np.int32)
    lidx = (np.zeros((n_steps * G, 4, _L), np.int32) if multihot
            else np.zeros((n_steps * G, _L), np.int32))
    lrow = np.full((n_steps * G, _L), R, np.int32)
    blk = np.zeros((n_steps, 1, G), np.int32)
    tile_of = np.zeros(n_steps, np.int32)
    lval = None if rank1 else np.zeros((n_steps * G, _L), np.float32)

    def fill_scattered(tile, step_lo, step_hi, parity):
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

    def fill_range(rid, step_lo, step_hi, parity):
        """Spread range rid's n_rq chunk copies over [step_lo, step_hi)."""
        lo = range_lo[rid]
        nsteps = max(step_hi - step_lo, 1)
        per = -(-n_rq // nsteps)
        pos = 0
        for s in range(step_lo, step_hi):
            cnt = max(min(per, n_rq - pos), 0)
            if cnt:
                # clamp: copies stay inside X (tiny graphs ride the edge)
                src = np.minimum(lo + np.arange(pos, pos + cnt) * RQ, max(m - RQ, 0))
                rcopy[s, 0, :cnt] = src
                rcopy[s, 1, :cnt] = parity * RC + np.arange(pos, pos + cnt) * RQ
            ctrl[s, 0, 4] = cnt
            pos += cnt

    # prologue: the first tile's scattered rows (parity 0) + the first
    # range (parity 0); no compute
    ctrl[:prologue, 0, 0] = -1
    fill_scattered(first, 0, prologue, 0)
    fill_range(range_of[first], 0, prologue - 1, 0)

    # per-range parity and the tile spans of each range in this segment
    seg_ranges = []
    for j, t in enumerate(seg_tiles):
        if not seg_ranges or range_of[t] != seg_ranges[-1][0]:
            seg_ranges.append([range_of[t], j, j])
        else:
            seg_ranges[-1][2] = j
    rpar_of = {rid: k % 2 for k, (rid, _, _) in enumerate(seg_ranges)}

    out_base = out_of[seg_tiles[0]]
    step = prologue
    step_at = []   # step index where tile j starts
    for j, t in enumerate(seg_tiles):
        step_at.append(step)
        ns = steps_of[t]
        _take, li, lr_, lv, bo = tiles_meta[t]
        ctrl[step:step + ns, 0, 0] = out_of[t] - out_base
        ctrl[step, 0, 1] = 1
        ctrl[step, 0, 9] = 1 if first_piece[t] else 0
        ctrl[step:step + ns, 0, 5] = (j % 2) * S_buf
        ctrl[step:step + ns, 0, 11] = rpar_of[range_of[t]] * RC
        tile_of[step:step + ns] = out_of[t] - out_base
        lidx[step * G:(step + ns) * G] = li
        lrow[step * G:(step + ns) * G] = lr_
        blk[step:step + ns, 0, :] = bo.reshape(ns, G)
        if not rank1:
            lval[step * G:(step + ns) * G] = lv
        if j + 1 < len(seg_tiles):
            fill_scattered(seg_tiles[j + 1], step, step + ns, (j + 1) % 2)
        step += ns

    # each range's first compute step, and the next range's copies over
    # this range's steps (minus the last, for the one-behind wait)
    for k, (rid, j_lo, j_hi) in enumerate(seg_ranges):
        ctrl[step_at[j_lo], 0, 10] = 1
        if k + 1 < len(seg_ranges):
            nxt_rid = seg_ranges[k + 1][0]
            lo_s = step_at[j_lo]
            hi_s = step_at[j_hi] + steps_of[seg_tiles[j_hi]]
            fill_range(nxt_rid, lo_s, max(hi_s - 1, lo_s + 1), rpar_of[nxt_rid])

    ctrl[1:, 0, 6] = ctrl[:-1, 0, 3]
    ctrl[1:, 0, 12] = ctrl[:-1, 0, 4]

    val_hi = val_lo = None
    if not rank1:
        val_hi, val_lo = bf16_pair(lval)

    return RangesSegment(
        ctrl=ctrl, scols=scols, rcopy=rcopy, lidx=lidx, lrow=lrow, blk=blk,
        tile_of=tile_of, val_hi=val_hi, val_lo=val_lo, stage_take=stage_take,
        stage_tier_ptr=stage_tier_ptr, n_steps=n_steps,
        n_tiles=out_of[seg_tiles[-1]] - out_base + 1,
    )
