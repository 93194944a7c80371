"""1-D row partition of a sparse matrix with a precomputed halo-exchange plan.

The port of the JAX package's parallel/partition.py: on the same CSR and
options ``partition_rows`` gives the same plan, array for array, stacked
and padded the same way (the tests hold the two leaf by leaf), as numpy
arrays. ``parallel/dist_spmm.py`` places it on devices and runs it.

Shard p owns A rows [p*rps, (p+1)*rps) and X rows [p*cps, (p+1)*cps)
(refined cuts move those bounds off the uniform grid). The columns A_p
references outside p's own X range are halo rows; need[p][q] lists them
per owner q. Column indices of A_p are remapped at plan time into the
concatenated local index space [own X (cps) | halo | hub slab], so the
local SpMM runs unmodified on [x_local ; halo ; hubs] with no runtime
index translation. The halo moves as one all-to-all padded to the worst
pair (width H), or, with ``ragged=True``, one ring shift per offset k
padded to that offset's worst pair: segment k of p's halo holds the rows
owned by (p - k) mod S.

Reference semantics: the per-rank row ranges of the reference's SBP slice
views (oneflow/core/job/nd_sbp_util.cpp:98-106,
oneflow/user/kernels/unsorted_segment_sum_kernel.cpp:59-75) and its
ragged id-shuffle exchange (oneflow/user/kernels/data_shuffle_kernel.cu:
41-130), as a static plan built on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.binned import SUBLANES, BinnedEll, bin_rows, optimal_ladder
from of_spmm_tpu_torch.sparse.formats import CSR

# one row per leaf of a stacked panel plan (leading dim = n_shards)
PANEL_LEAVES = ("ctrl", "rcopy", "dsrc", "masks", "blk", "tile_of", "stage_take",
                "row_scale", "col_scale")
HUB_CANDIDATES = (0, 256, 1024, 4096, 16384, 65536)  # replicate_hubs="auto"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class StackedBucket:
    """An EllBucket stacked across shards (leading dim = n_shards)."""

    row_ids: np.ndarray  # (S, R) int32
    cols: np.ndarray  # (S, R, K) int32, remapped into [own | halo | hub]
    vals: np.ndarray  # (S, R, K) float32

    @property
    def width(self) -> int:
        return int(self.cols.shape[2])


@dataclasses.dataclass(frozen=True)
class RowPartitionPlan:
    """Static halo-exchange plan for Y = A @ X row-partitioned over S shards.

    Built with ``split_boundary=True``, each shard's ELL rows are divided
    into INTERIOR rows (every nonzero hits shard-local X) and BOUNDARY rows
    (at least one halo reference): ``buckets`` is then empty and
    ``interior_buckets`` / ``boundary_buckets`` carry the work, so the
    interior runs while the halo is in flight."""

    buckets: Tuple[StackedBucket, ...]
    send_idx: np.ndarray  # (S, S, H) int32: p sends own-local X rows send_idx[p, q] to q
    shape: Tuple[int, int]  # global logical A shape
    n_shards: int
    rows_per_shard: int  # output rows per shard (padded)
    cols_per_shard: int  # X rows per shard (padded)
    halo_size: int  # H
    interior_buckets: Optional[Tuple[StackedBucket, ...]] = None
    boundary_buckets: Optional[Tuple[StackedBucket, ...]] = None
    # hub replication: the K highest in-degree columns leave the pairwise
    # need lists and are gathered once per call instead.
    # hub_local_idx[p, k] is the p-local X row of p's k-th hub slot (0
    # padded); hub_perm maps the gathered (S * Kmax) slab to hub-rank order.
    hub_local_idx: Optional[np.ndarray] = None  # (S, Kmax) int32
    hub_perm: Optional[np.ndarray] = None  # (K,) int32 into S*Kmax
    # A_local^T (cps + halo + K, rps), binned and stacked: the backward of
    # the local SpMM, dXcat = A_local^T @ dY
    transpose_buckets: Optional[Tuple[StackedBucket, ...]] = None
    # ragged halo: one ring shift per offset k = 1..S-1, padded to that
    # offset's worst pair
    offset_send: Optional[Tuple[np.ndarray, ...]] = None  # k-1 -> (S, H_k)
    offset_widths: Optional[Tuple[int, ...]] = None  # (S-1,) H_k
    # refined cuts: x_pack_idx gathers global X rows into the padded
    # (S*cps,) layout, y_unpack_idx maps padded outputs back to row order
    x_pack_idx: Optional[np.ndarray] = None  # (S*cps,) int32
    y_unpack_idx: Optional[np.ndarray] = None  # (n,) int32
    # per-shard panel plans (local_engine="panels"), leaves PANEL_LEAVES
    # stacked across shards; panel_aux holds each stack's static config
    # (forward, backward, interior); panel_bwd is the transposed local plan
    panel_fwd: Optional[Tuple[np.ndarray, ...]] = None
    panel_bwd: Optional[Tuple[np.ndarray, ...]] = None
    # split_boundary + panels: panel_fwd is the BOUNDARY piece and
    # panel_int the interior piece (cols in [own X | hub] only)
    panel_int: Optional[Tuple[np.ndarray, ...]] = None
    panel_aux: Optional[tuple] = None

    @property
    def split(self) -> bool:
        return self.interior_buckets is not None

    @property
    def ragged(self) -> bool:
        return self.offset_send is not None

    @property
    def halo_rows_total(self) -> int:
        """Halo buffer rows per shard (ragged-aware)."""
        if self.offset_widths is not None:
            return int(sum(self.offset_widths))
        return self.n_shards * self.halo_size

    @property
    def n_hubs(self) -> int:
        return 0 if self.hub_perm is None else int(self.hub_perm.shape[0])

    @property
    def halo_fraction(self) -> float:
        """Exchanged rows / owned rows: comms pressure indicator."""
        return self.halo_rows_total / max(1, self.cols_per_shard)

    def comm_stats(self, d: int = 128, bytes_per: int = 4) -> dict:
        """Per-shard exchanged bytes: padded halo + hub gather against an
        all-gather of X."""
        S = self.n_shards
        halo = self.halo_rows_total * d * bytes_per
        kmax = 0 if self.hub_local_idx is None else int(self.hub_local_idx.shape[1])
        hub = S * kmax * d * bytes_per
        allg = S * self.cols_per_shard * d * bytes_per
        return {"halo_bytes": halo, "hub_bytes": hub, "all_gather_bytes": allg,
                "saving": 1.0 - (halo + hub) / max(allg, 1)}

    def shard_rows(self, p: int) -> int:
        """Real (unpadded) output rows of shard p."""
        if self.y_unpack_idx is not None:
            return int(((self.y_unpack_idx >= p * self.rows_per_shard)
                        & (self.y_unpack_idx < (p + 1) * self.rows_per_shard)).sum())
        return int(min(max(self.shape[0] - p * self.rows_per_shard, 0), self.rows_per_shard))


def _stack_panel_plans(plans):
    """Pad per-shard PanelPlans to common shapes and stack their leaves
    (leading dim = n_shards). All plans must share S_buf (built with
    s_buf_force), T, RC, RQ, tiles, and have one segment."""
    from of_spmm_tpu_torch.sparse.panels import ensure_masks

    plans = [ensure_masks(p) for p in plans]  # stack dense masks
    G = plans[0].T // 128
    assert all(len(p.segments) == 1 for p in plans)
    assert len({p.S_buf for p in plans}) == 1
    assert len({p.segments[0].n_tiles for p in plans}) == 1
    RMAX = max(p.RMAX for p in plans)
    n_steps = max(p.segments[0].n_steps for p in plans)
    take_len = max(int(p.segments[0].stage_take.shape[0]) for p in plans)
    leaves = []
    for p in plans:
        seg = p.segments[0]
        pad_s = n_steps - seg.n_steps
        ctrl, rc, ds = np.asarray(seg.ctrl), np.asarray(seg.rcopy), np.asarray(seg.dsrc)
        masks, blk, tile_of = np.asarray(seg.masks), np.asarray(seg.blk), np.asarray(seg.tile_of)
        if pad_s:
            # appended no-op steps: no compute (tile -1), no staging, no
            # mask bits; the out-block index stays on the LAST tile
            pad_ctrl = np.zeros((pad_s, 1, 24), np.int32)
            pad_ctrl[:, 0, 0] = -1
            ctrl = np.concatenate([ctrl, pad_ctrl])
            rc = np.concatenate([rc, np.zeros((pad_s,) + rc.shape[1:], np.int32)])
            ds = np.concatenate([ds, np.zeros((pad_s,) + ds.shape[1:], np.int32)])
            masks = np.concatenate([masks, np.zeros((pad_s * G,) + masks.shape[1:], np.int32)])
            blk = np.concatenate([blk, np.zeros((pad_s,) + blk.shape[1:], np.int32)])
            tile_of = np.concatenate([tile_of, np.full(pad_s, seg.n_tiles - 1, np.int32)])
        if rc.shape[2] < RMAX:
            rc = np.pad(rc, ((0, 0), (0, 0), (0, RMAX - rc.shape[2])))
        take = np.asarray(seg.stage_take)
        take = np.pad(take, (0, take_len - take.shape[0]))
        leaves.append((ctrl, rc, ds, masks, blk, tile_of, take,
                       np.asarray(p.row_scale, np.float32), np.asarray(p.col_scale, np.float32)))
    stacked = tuple(np.stack([lv[i] for lv in leaves]) for i in range(len(PANEL_LEAVES)))
    p0 = plans[0]
    aux = dict(n_steps=int(n_steps), n_tiles=int(p0.segments[0].n_tiles), shape=p0.shape,
               T=p0.T, RC=p0.RC, S_buf=p0.S_buf, RMAX=int(RMAX), RQ=p0.RQ)
    return stacked, aux


def make_panel_plan(leaves, aux):
    """Rebuild one shard's PanelPlan from its slice of the stacked leaves
    (dense masks, as stacked; ``dist_spmm`` turns them back into compact
    edges before it places the plan)."""
    from of_spmm_tpu_torch.sparse.panels import PanelPlan, PanelSegment

    (ctrl, rcopy, dsrc, masks, blk, tile_of, stage_take, row_scale, col_scale) = leaves
    seg = PanelSegment(ctrl=ctrl, rcopy=rcopy, dsrc=dsrc, masks=masks, blk=blk,
                       tile_of=tile_of, stage_take=stage_take, n_steps=aux["n_steps"],
                       n_tiles=aux["n_tiles"])
    return PanelPlan(segments=(seg,), hot_ids=np.zeros(0, np.int32), row_scale=row_scale,
                     col_scale=col_scale, shape=aux["shape"], R=128, T=aux["T"], RC=aux["RC"],
                     S_buf=aux["S_buf"], RMAX=aux["RMAX"], RQ=aux["RQ"], n_ranges=0,
                     n_range_rows=0, n_scattered=0, n_groups=0)


def _build_panel_stack(csrs, facs, T):
    """Per-shard panel plans with uniform static params, stacked."""
    from of_spmm_tpu_torch.sparse.panels import build_panels_plan

    kw = dict(T=T, hot_budget=0, seg_steps=1 << 30, seg_stage_cap=1 << 60)
    plans = [build_panels_plan(c, factors=f, **kw) for c, f in zip(csrs, facs)]
    sb = max(p.S_buf for p in plans)
    plans = [p if p.S_buf == sb else build_panels_plan(c, factors=f, s_buf_force=sb, **kw)
             for p, c, f in zip(plans, csrs, facs)]
    return _stack_panel_plans(plans)


def _refine_bounds(n: int, S: int, rows, cols, slack: float) -> np.ndarray:
    """Shard boundaries moved off the uniform grid toward min-cut points.

    An edge (r, c) crosses cut x when min(r,c) < x <= max(r,c); one +-1
    sweep gives the crossing count at every position, and each boundary
    picks the minimum within +-slack*rps of its uniform position (rounded
    down to a multiple of 8)."""
    rps = _cdiv(n, S)
    lo_rc = np.minimum(rows, cols)
    hi_rc = np.maximum(rows, cols)
    ev = np.zeros(n + 1, np.int64)
    np.add.at(ev, lo_rc + 1, 1)
    np.add.at(ev, hi_rc + 1, -1)
    crossing = np.cumsum(ev)  # crossing[x] = edges straddling cut x
    w = max(int(slack * rps), 1)
    bounds = np.zeros(S + 1, np.int64)
    bounds[S] = n
    for p in range(1, S):
        u = p * rps
        lo = max(u - w, bounds[p - 1] + 1)
        hi = min(u + w, n - (S - p))
        c = int(lo + np.argmin(crossing[lo:hi + 1]))
        c -= c % SUBLANES
        bounds[p] = max(c, bounds[p - 1] + 1)
    return bounds


def partition_rows(
    csr: CSR,
    n_shards: int,
    ladder="auto",
    split_boundary: bool = False,
    with_transpose: bool = True,
    replicate_hubs=0,
    ragged: bool = False,
    refine_slack: float = 0.0,
    local_engine: str = "binned",
) -> RowPartitionPlan:
    """Build the plan (host-side, once per graph x shard count).

    ``ladder="auto"`` picks one global width ladder from the whole
    graph's degree histogram, so every shard bins with the same widths.
    ``replicate_hubs=K``: the K highest in-degree columns are gathered
    once per call instead of riding the pairwise halo; ``"auto"`` picks K
    from HUB_CANDIDATES by the modeled exchange bytes. ``ragged=True``:
    per-offset ring shifts instead of one padded all-to-all;
    ``refine_slack > 0``: min-cut boundary refinement (square matrices
    only). ``local_engine="panels"`` adds per-shard panel plans (rank-1
    values only). ``with_transpose`` builds the backward's plans.
    """
    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        ladder = optimal_ladder(csr)
    n, m = csr.shape
    S = n_shards
    if local_engine not in ("binned", "panels"):
        raise ValueError(f"local_engine must be binned|panels, got {local_engine!r}")
    rg = cg = None
    if local_engine == "panels":
        # split_boundary + panels: TWO panel plans per shard, interior
        # (refs in [own X | hub], compacted col space) and boundary (refs
        # in the halo, full [own | halo | hub] space)
        from of_spmm_tpu_torch.sparse.expansion2 import factor_rank1

        fg = factor_rank1(csr)
        if fg is None:
            raise ValueError("local_engine='panels' requires rank-1-factorable values "
                             "(normalized adjacency); use local_engine='binned'")
        rg, cg = (np.asarray(a, np.float64) for a in fg)

    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols).astype(np.int64)
    vals = np.asarray(csr.vals)

    # --- shard boundaries -------------------------------------------------
    if refine_slack > 0:
        if n != m:
            raise ValueError("refine_slack needs a square adjacency "
                             "(rows and cols share the cut points)")
        rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        bounds = _refine_bounds(n, S, rows_all, cols, refine_slack)
        del rows_all
    else:
        bounds = np.minimum(np.arange(S + 1, dtype=np.int64) * _cdiv(n, S), n)
    uniform = refine_slack <= 0
    sizes = np.diff(bounds)
    rps = int(sizes.max())
    rps += -rps % SUBLANES
    if uniform:
        rps = _cdiv(n, S)
        cps = _cdiv(m, S)
        col_bounds = np.minimum(np.arange(S + 1, dtype=np.int64) * cps, m)
    else:
        cps = rps  # square: cols share the refined bounds
        col_bounds = bounds

    def owner_of(c):
        if uniform:
            return c // cps
        return np.searchsorted(col_bounds, c, side="right") - 1

    # --- hub selection ----------------------------------------------------
    indeg = np.bincount(cols, minlength=m)
    auto_hubs = replicate_hubs == "auto"
    hub_candidates = HUB_CANDIDATES if auto_hubs else (min(int(replicate_hubs), m),)

    # per-shard unique referenced cols (computed once; hub filtering masks)
    shard_uniq = []
    shard_slices = []
    for p in range(S):
        r0, r1 = int(bounds[p]), int(bounds[p + 1])
        lo, hi = indptr[r0], indptr[r1]
        shard_slices.append((r0, r1, lo, hi))
        shard_uniq.append(np.unique(cols[lo:hi]))

    hub_order = np.argsort(-indeg, kind="stable")

    def modeled_bytes(K):
        """Exchanged rows (hub slab included) for hub count K, with the
        padding the final plan applies."""
        if K:
            hub_set = np.zeros(m, bool)
            hub_set[hub_order[:K]] = True
        worst = np.zeros(S, np.int64)  # per-offset max (ragged model)
        for p in range(S):
            u = shard_uniq[p]
            if K:
                u = u[~hub_set[u]]
            cnt = np.bincount(owner_of(u), minlength=S)
            for q in range(S):
                if q == p:
                    continue
                k = (p - q) % S
                worst[k] = max(worst[k], cnt[q])
        if ragged:
            hk = np.maximum(worst[1:], 1)
            hk += (-hk) % SUBLANES
            halo_rows = int(hk.sum())
        else:
            h = max(int(worst.max()), 1)
            h += -h % SUBLANES
            halo_rows = S * h
        kmax = 0
        if K:
            kmax = max(int(np.bincount(owner_of(hub_order[:K]), minlength=S).max()), 1)
        return halo_rows + S * kmax

    if split_boundary and local_engine != "panels":
        # the binned split body computes on [x_local | halo] only: it never
        # appends the hub slab, so replicated hubs would read wrong rows
        if not auto_hubs and hub_candidates[0]:
            raise ValueError(
                "split_boundary=True is incompatible with replicate_hubs>0 for "
                "local_engine='binned' (the split compute body does not gather the hub "
                "slab); use replicate_hubs=0, split_boundary=False, or local_engine='panels'")
        if auto_hubs:
            hub_candidates = (0,)
    if len(hub_candidates) > 1:
        K = min(hub_candidates, key=modeled_bytes)
    else:
        K = hub_candidates[0]
    K = min(K, m)

    hub_rank = np.full(m, -1, dtype=np.int64)
    hub_ids = np.zeros(0, np.int64)
    hub_local_idx = None
    hub_perm = None
    if K:
        hub_ids = hub_order[:K]
        hub_rank[hub_ids] = np.arange(K, dtype=np.int64)
        owner_h = owner_of(hub_ids)
        kmax = max(int(np.bincount(owner_h, minlength=S).max()), 1)
        hub_local_idx = np.zeros((S, kmax), np.int32)
        hub_perm = np.zeros(K, np.int32)
        slot_of = np.zeros(S, np.int64)
        for r, c in enumerate(hub_ids):
            p = int(owner_h[r])
            k = int(slot_of[p])
            hub_local_idx[p, k] = c - col_bounds[p]
            hub_perm[r] = p * kmax + k
            slot_of[p] += 1

    # --- per-shard halo needs -------------------------------------------
    # need[p][q]: sorted unique global cols owned by q (!= p) referenced by A_p
    need = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for p in range(S):
        uniq = shard_uniq[p]
        if K:
            uniq = uniq[hub_rank[uniq] < 0]  # hubs ride the gather
        owner = owner_of(uniq)
        for q in range(S):
            if q != p:
                need[p][q] = uniq[owner == q]

    H = max((need[p][q].shape[0] for p in range(S) for q in range(S)), default=0)
    H = max(H, 1)
    H += -H % SUBLANES  # align halo buffer rows

    # --- ragged per-offset widths + halo segment bases -------------------
    offset_widths = None
    offset_send = None
    if ragged:
        offset_widths = []
        for k in range(1, S):
            hk = max((need[p][(p - k) % S].shape[0] for p in range(S)), default=0)
            hk = max(hk, 1)
            hk += -hk % SUBLANES
            offset_widths.append(hk)
        offset_widths = tuple(offset_widths)
        # off_pref[k] = sum of widths for offsets < k (k >= 1): the base of
        # segment k, which holds owner (p - k) % S's rows
        off_pref = np.zeros(S, np.int64)
        np.cumsum(np.asarray(offset_widths[:-1]), out=off_pref[2:])
        # send plan per offset: p sends need[(p+k)%S][p] to (p+k)%S
        offset_send = []
        for k in range(1, S):
            sk = np.zeros((S, offset_widths[k - 1]), np.int32)
            for p in range(S):
                idx = need[(p + k) % S][p] - col_bounds[p]
                sk[p, : idx.shape[0]] = idx
            offset_send.append(sk)
        halo_total = int(sum(offset_widths))
    else:
        halo_total = S * H

    # --- send plan: p sends need[q][p] (as p-local indices) to q ---------
    send_idx = np.zeros((S, S, H), dtype=np.int32)
    for p in range(S):
        for q in range(S):
            if q != p:
                idx = need[q][p] - col_bounds[p]  # p-local X row indices
                send_idx[p, q, : idx.shape[0]] = idx

    def halo_pos(p, q):
        """Base of owner-q's halo rows in p's halo section."""
        if ragged:
            return int(off_pref[(p - q) % S])
        return q * H

    # --- pack/unpack maps for refined (non-uniform) boundaries -----------
    x_pack_idx = None
    y_unpack_idx = None
    if not uniform:
        x_pack_idx = np.zeros(S * cps, np.int32)
        y_unpack_idx = np.zeros(n, np.int32)
        for p in range(S):
            r0, r1 = int(bounds[p]), int(bounds[p + 1])
            x_pack_idx[p * cps: p * cps + (r1 - r0)] = np.arange(r0, r1)
            y_unpack_idx[r0:r1] = p * rps + np.arange(r1 - r0)

    # --- per-shard local CSR with remapped cols, then bin ----------------
    n_xcat = cps + halo_total + K
    per_shard_binned = []
    per_shard_t_binned = []
    panel_csrs, panel_facs = [], []
    panel_int_csrs, panel_int_facs = [], []
    panel_t_csrs, panel_t_facs = [], []
    for p in range(S):
        r0, r1, lo, hi = shard_slices[p]
        c = cols[lo:hi]
        v = vals[lo:hi]
        local_indptr = (indptr[r0: r1 + 1] - lo).astype(np.int64)
        # remap: own cols -> c - col_bounds[p]; halo col from owner q at
        # position j of need[p][q] -> cps + halo_pos(p, q) + j; hub of rank
        # r -> cps + halo_total + r
        owner = owner_of(c)
        remapped = np.empty_like(c)
        is_hub = hub_rank[c] >= 0 if K else np.zeros(c.shape[0], bool)
        own = np.logical_and(owner == p, ~is_hub)
        remapped[own] = c[own] - col_bounds[p]
        if K:
            remapped[is_hub] = cps + halo_total + hub_rank[c[is_hub]]
        for q in range(S):
            if q == p:
                continue
            sel = np.logical_and(owner == q, ~is_hub)
            if not sel.any():
                continue
            pos = np.searchsorted(need[p][q], c[sel])
            remapped[sel] = cps + halo_pos(p, q) + pos
        pad_rows = rps - (r1 - r0)
        if pad_rows:
            local_indptr = np.concatenate(
                [local_indptr, np.full(pad_rows, local_indptr[-1], np.int64)])
        if with_transpose:
            # A_local^T (cps + halo + K, rps): the local backward operator
            local_rows = np.repeat(np.arange(rps, dtype=np.int64), np.diff(local_indptr))
            order = np.argsort(remapped, kind="stable")
            t_cols = remapped[order]
            t_counts = np.bincount(t_cols, minlength=n_xcat)
            t_indptr = np.zeros(n_xcat + 1, np.int64)
            np.cumsum(t_counts, out=t_indptr[1:])
            t_csr = CSR.from_arrays(t_indptr, local_rows[order].astype(np.int32), v[order],
                                    (n_xcat, rps))
            per_shard_t_binned.append(bin_rows(t_csr, ladder=ladder))
        if local_engine == "panels":
            # global rank-1 factors remapped into the shard's index spaces:
            # rows -> p's row slice; cols -> [own | halo | hub] (pad slots
            # scale 0, never referenced)
            rl = np.zeros(rps, np.float64)
            rl[: r1 - r0] = rg[r0:r1]
            cl = np.zeros(n_xcat, np.float64)
            own_w = int(col_bounds[p + 1] - col_bounds[p])
            cl[:own_w] = cg[col_bounds[p]:col_bounds[p + 1]]
            for q in range(S):
                if q != p:
                    ids = need[p][q]
                    base = cps + halo_pos(p, q)
                    cl[base:base + ids.shape[0]] = cg[ids]
            if K:
                cl[cps + halo_total:] = cg[hub_ids]
            panel_facs.append((rl, cl))
            if with_transpose:
                panel_t_csrs.append(t_csr)
                panel_t_facs.append((cl, rl))
        if split_boundary:
            # a row is BOUNDARY iff any of its nonzeros references the halo
            # (hub columns come with the gather, before the exchange)
            is_halo = ((remapped >= cps) & (remapped < cps + halo_total)).astype(np.int64)
            cum = np.zeros(remapped.shape[0] + 1, np.int64)
            np.cumsum(is_halo, out=cum[1:])
            row_halo = (cum[local_indptr[1:]] - cum[local_indptr[:-1]]) > 0

            def masked_csr(keep_rows: np.ndarray) -> CSR:
                keep_nnz = np.repeat(keep_rows, np.diff(local_indptr))
                counts = np.diff(local_indptr) * keep_rows
                ip = np.zeros(local_indptr.shape[0], np.int64)
                np.cumsum(counts, out=ip[1:])
                return CSR.from_arrays(ip.astype(np.int32), remapped[keep_nnz].astype(np.int32),
                                       v[keep_nnz], (rps, n_xcat))

            per_shard_binned.append((bin_rows(masked_csr(~row_halo), ladder=ladder),
                                     bin_rows(masked_csr(row_halo), ladder=ladder)))
            if local_engine == "panels":
                # edge-granularity split: interior = every edge whose col
                # is in [own X | hub] (hub cols compacted next to own X),
                # boundary = the halo-referencing edges
                nnz_keep = ~is_halo.astype(bool)

                def edge_csr(keep_nnz, col_map, width):
                    cnt = np.zeros(rps, np.int64)
                    seg = np.repeat(np.arange(rps), np.diff(local_indptr))
                    np.add.at(cnt, seg[keep_nnz], 1)
                    ip = np.zeros(rps + 1, np.int64)
                    np.cumsum(cnt, out=ip[1:])
                    return CSR.from_arrays(ip, col_map[keep_nnz].astype(np.int32), v[keep_nnz],
                                           (rps, width))

                ci = remapped.copy()
                ci[ci >= cps + halo_total] -= halo_total
                panel_int_csrs.append(edge_csr(nnz_keep, ci, cps + K))
                panel_int_facs.append((rl, np.concatenate([cl[:cps], cl[cps + halo_total:]])))
                panel_csrs.append(edge_csr(~nnz_keep, remapped, n_xcat))  # boundary piece
        else:
            local_csr = CSR.from_arrays(local_indptr.astype(np.int32),
                                        remapped.astype(np.int32), v, (rps, n_xcat))
            per_shard_binned.append(bin_rows(local_csr, ladder=ladder))
            if local_engine == "panels":
                panel_csrs.append(local_csr)

    t_buckets = _stack_binned(per_shard_t_binned) if with_transpose else None
    panel_fwd = panel_bwd = panel_int = None
    panel_aux = None
    if local_engine == "panels":
        from of_spmm_tpu_torch.sparse.fused import _BIG_T_NNZ, DEFAULT_T
        from of_spmm_tpu_torch.sparse.panels import _BIG_T_PANELS

        T_force = _BIG_T_PANELS if csr.nnz >= _BIG_T_NNZ else DEFAULT_T
        panel_fwd, aux_f = _build_panel_stack(panel_csrs, panel_facs, T_force)
        aux_b = aux_i = None
        if split_boundary:
            panel_int, aux_i = _build_panel_stack(panel_int_csrs, panel_int_facs, T_force)
        if with_transpose:
            panel_bwd, aux_b = _build_panel_stack(panel_t_csrs, panel_t_facs, T_force)
        panel_aux = (aux_f, aux_b, aux_i)
    common = dict(
        send_idx=send_idx, shape=tuple(csr.shape), n_shards=S, rows_per_shard=rps,
        cols_per_shard=cps, halo_size=H, hub_local_idx=hub_local_idx, hub_perm=hub_perm,
        transpose_buckets=t_buckets,
        offset_send=None if offset_send is None else tuple(offset_send),
        offset_widths=offset_widths, x_pack_idx=x_pack_idx, y_unpack_idx=y_unpack_idx,
        panel_fwd=panel_fwd, panel_bwd=panel_bwd, panel_int=panel_int, panel_aux=panel_aux)
    if split_boundary:
        return RowPartitionPlan(
            buckets=(), interior_buckets=_stack_binned([a for a, _ in per_shard_binned]),
            boundary_buckets=_stack_binned([b for _, b in per_shard_binned]), **common)
    return RowPartitionPlan(buckets=_stack_binned(per_shard_binned), **common)


def _stack_binned(per_shard: Sequence[BinnedEll]) -> Tuple[StackedBucket, ...]:
    """Stack per-shard BinnedElls into uniform (S, R, K) arrays.

    Each width bucket is padded to the max row count over shards (padding
    rows: row_id the shard's last one, so row_ids stay ascending; cols 0,
    vals 0, harmless under scatter-add)."""
    S = len(per_shard)
    out = []
    for w in sorted({b.width for sh in per_shard for b in sh.buckets}):
        per = []
        for sh in per_shard:
            found = None
            for b in sh.buckets:
                if b.width == w:
                    found = b
            per.append(found)
        rmax = max((b.n_ell_rows if b is not None else 0) for b in per)
        rmax += -rmax % SUBLANES
        if rmax == 0:
            continue
        rids = np.zeros((S, rmax), np.int32)
        cols = np.zeros((S, rmax, w), np.int32)
        vals = np.zeros((S, rmax, w), np.float32)
        for s, b in enumerate(per):
            if b is None:
                continue
            r = b.n_ell_rows
            b_rids = np.asarray(b.row_ids)
            rids[s, :r] = b_rids
            if r:
                rids[s, r:] = b_rids[-1]
            cols[s, :r] = np.asarray(b.cols)
            vals[s, :r] = np.asarray(b.vals)
        out.append(StackedBucket(row_ids=rids, cols=cols, vals=vals))
    return tuple(out)
