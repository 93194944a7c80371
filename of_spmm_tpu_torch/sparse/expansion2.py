"""Expansion plan v2: single-block lane groups for the one-hot SpMM.

The port of the JAX package's sparse/expansion2.py. ``build_expansion2_plan``
gives, on the same CSR, plan arrays equal to the JAX package's (the tests
hold them array for array, the bf16 values bitwise), and
``spmm_expansion2`` (ops/cuda/expansion2.py, csrc/expansion2.cu) runs it.

v2 is v1 (sparse/expansion.py) with three changes:

1. **Single-block lane groups.** A tile's lanes (column-sorted, so their
   staged positions ascend) are cut at 128-row staging-block boundaries
   and each run is padded to 128-lane groups; every group carries ONE
   staging block index (``blk_of``). G groups make a step.
2. **Unpadded staging.** The staged table is exactly the tiles' unique
   columns, tier-major.
3. **Values out of the gather.** Rank-1 values (a_ij = r_i * c_j, e.g.
   every degree-normalized adjacency): c is kept per staged row
   (``stage_scale``) and r per output row (``row_scale``), so the lanes
   carry no values. General values are kept per lane as a bf16 pair.

Padding lanes carry the row sentinel R; a tile without nonzeros gets one
step of padding groups.

Placement (``attach_stage_rows``, port only) derives each group's
``stage_row`` and the kernel's work list as for v1 (sparse/expansion.py).

Reference semantics: gather x segment-sum
(oneflow/user/ops/gather_op.cpp:51-82,
oneflow/user/kernels/unsorted_segment_sum_kernel_util.cu:52-151).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.expansion import (
    LaneWork, bf16_pair_bits, bf16_value, check_lanes, group_tiles, lane_work, stage_rows,
    tile_pass1)
from of_spmm_tpu_torch.sparse.formats import CSR

DEFAULT_R = 512      # output rows per tile
DEFAULT_G = 8        # lane groups (of 128 lanes) per kernel step
STAGE_TIER = 32768   # columns per staging tier
DEFAULT_STAGE_BUDGET = 4 * 1024 * 1024  # staged rows per group of tiles
_L = 128             # lanes per group == staging block rows


@dataclasses.dataclass(frozen=True)
class Expansion2Group:
    """One group of row tiles: dense staging + single-block lane groups."""

    stage_idx: np.ndarray               # (U,) int32, tier-local column ids
    stage_tier_ptr: Tuple[int, ...]     # python ints
    stage_scale: Optional[np.ndarray]   # (U,) f32 column scale (rank-1) or None

    lidx: np.ndarray                # (n_grp, 128) int32, block-local staged index
    lrow: np.ndarray                # (n_grp, 128) int32, row within the tile; R = padding
    val_hi: Optional[np.ndarray]    # (n_grp, 128) uint16 bf16 bits, or None (rank-1)
    val_lo: Optional[np.ndarray]

    blk_of: np.ndarray   # (n_grp,) int32 staging block of each group
    tile_of: np.ndarray  # (n_steps,) int32 tile of each step (n_grp = n_steps * G)

    n_steps: int
    n_tiles: int
    stage_row: Optional[np.ndarray] = None  # port only: (U,) int32 X row of each staged row


@dataclasses.dataclass(frozen=True)
class Expansion2Plan:
    groups: Tuple[Expansion2Group, ...]
    row_scale: Optional[np.ndarray]  # (n_rows,) f32 (rank-1) or None
    shape: Tuple[int, int]
    R: int
    G: int
    stage_tier: int = STAGE_TIER
    work: Optional[LaneWork] = None  # port only: the kernel's work list (placement)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def rank1(self) -> bool:
        return self.row_scale is not None

    @property
    def n_steps(self) -> int:
        return sum(g.n_steps for g in self.groups)

    @property
    def n_tiles(self) -> int:
        return sum(g.n_tiles for g in self.groups)

    @property
    def n_staged(self) -> int:
        return sum(int(g.stage_idx.shape[0]) for g in self.groups)

    def padding_efficiency(self, true_nnz: int) -> float:
        lanes = self.n_steps * self.G * _L
        return float(true_nnz) / lanes if lanes else 1.0


def factor_rank1(csr: CSR, rtol: float = 1e-6):
    """Try to factor vals[e] = r[row[e]] * c[col[e]] (degree-normalized
    adjacencies are exactly this form). Returns (r, c) float64 numpy
    arrays or None.

    Tests the candidates that cover the package's normalizations:
    c_j = f(deg_j) with r_i = g(deg_i): sym (f=g=deg^-1/2), row (r=deg^-1,
    c=1), col (r=1, c=deg^-1), unweighted (r=c=1), and for square matrices
    the same row-degree (or column-degree) scaling on both sides.
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    vals = np.asarray(csr.vals, dtype=np.float64)
    if vals.size == 0:
        return np.ones(n), np.ones(m)
    deg_out = np.diff(indptr).astype(np.float64)
    deg_in = np.bincount(cols, minlength=m).astype(np.float64)
    with np.errstate(divide="ignore"):
        inv_out = np.where(deg_out > 0, 1.0 / deg_out, 0.0)
        inv_in = np.where(deg_in > 0, 1.0 / deg_in, 0.0)
        rs_out = np.where(deg_out > 0, deg_out ** -0.5, 0.0)
        rs_in = np.where(deg_in > 0, deg_in ** -0.5, 0.0)
    candidates = [
        (np.ones(n), np.ones(m)),                # unweighted
        (rs_out, rs_in),                         # sym normalized
        (inv_out, np.ones(m)),                   # row normalized
        (np.ones(n), inv_in),                    # col normalized
    ]
    if n == m:
        # GCN normalization of a directed square graph applies the row
        # degrees on both sides (models/gcn.py normalized_adjacency); its
        # transpose factors with the column degrees on both sides
        candidates.append((rs_out, rs_out))
        candidates.append((inv_out, inv_out))
        candidates.append((rs_in, rs_in))
        candidates.append((inv_in, inv_in))
    # screen the candidates on a random edge sample, then verify the
    # survivor on a capped subsample (4M edges)
    nnz = vals.shape[0]
    rng0 = np.random.default_rng(0)

    def row_of(idx):
        return np.searchsorted(indptr, idx, side="right") - 1

    if nnz > 1 << 20:
        sample = rng0.integers(0, nnz, 1 << 16)
        rs, cs, vs = row_of(sample), cols[sample], vals[sample]
    else:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        rs, cs, vs = rows, cols, vals
    for r, c in candidates:
        if not np.allclose(r[rs] * c[cs], vs, rtol=rtol, atol=0):
            continue
        if nnz > rs.shape[0]:
            ver = rng0.integers(0, nnz, min(nnz, 1 << 22))
            if not np.allclose(r[row_of(ver)] * c[cols[ver]], vals[ver],
                               rtol=rtol, atol=0):
                continue
        return r, c
    return None


def _lane_groups_for_tile(gidx, rows, vals, R):
    """Cut a tile's (sorted-gidx) lanes at 128-row block boundaries and
    pad every run to 128-lane groups. Returns per-group arrays."""
    m = gidx.shape[0]
    if m == 0:
        return (np.zeros((0, _L), np.int32), np.zeros((0, _L), np.int32),
                np.zeros((0, _L), np.float32), np.zeros((0,), np.int32))
    blk = gidx // _L
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
    lidx[dst] = (gidx - blk * _L).astype(np.int32)
    lrow[dst] = rows.astype(np.int32)
    if vals is not None:
        val[dst] = vals
    blk_of = np.repeat(blk[starts].astype(np.int32), plens // _L)
    return (lidx.reshape(-1, _L), lrow.reshape(-1, _L),
            val.reshape(-1, _L), blk_of)


def _build_group(tiles, tile_data, n_tiers, stage_tier, R, G, rank1,
                 col_scale) -> Expansion2Group:
    n_tl = len(tiles)
    # dense tier-major staging offsets: run_off[tier, tile]
    seg_len = np.zeros((n_tiers, n_tl), dtype=np.int64)
    for j, t in enumerate(tiles):
        seg_len[:, j] = np.bincount(tile_data[t][0] // stage_tier, minlength=n_tiers)
    flat = seg_len.reshape(-1)
    run_off = np.zeros(flat.shape[0] + 1, dtype=np.int64)
    np.cumsum(flat, out=run_off[1:])
    tier_ptr = [0] + list(np.cumsum(seg_len.sum(axis=1)))
    U = int(tier_ptr[-1])
    run_off = run_off[:-1].reshape(n_tiers, n_tl)

    stage_idx = np.zeros(U, dtype=np.int32)
    scale = np.ones(U, dtype=np.float32) if rank1 else None
    g_lidx, g_lrow, g_val, g_blk, steps_tile = [], [], [], [], []
    for j, t in enumerate(tiles):
        uniq, inv, r, v = tile_data[t]
        tiers = uniq // stage_tier
        within = np.arange(uniq.shape[0], dtype=np.int64)
        tier_first = np.searchsorted(tiers, np.arange(n_tiers), side="left")
        gpos = run_off[tiers, j] + within - tier_first[tiers]
        stage_idx[gpos] = (uniq - tiers * stage_tier).astype(np.int32)
        if rank1:
            scale[gpos] = col_scale[uniq]
        li, lr, lv, bo = _lane_groups_for_tile(gpos[inv], r, None if rank1 else v, R)
        # pad the tile's groups to whole steps; an empty tile gets one step
        n_grp = li.shape[0]
        pad_g = G if n_grp == 0 else (-n_grp % G)
        if pad_g:
            li = np.concatenate([li, np.zeros((pad_g, _L), np.int32)])
            lr = np.concatenate([lr, np.full((pad_g, _L), R, np.int32)])
            lv = np.concatenate([lv, np.zeros((pad_g, _L), np.float32)])
            bo = np.concatenate([bo, np.zeros(pad_g, np.int32)])
        g_lidx.append(li)
        g_lrow.append(lr)
        g_val.append(lv)
        g_blk.append(bo)
        steps_tile += [j] * ((n_grp + pad_g) // G)

    val_hi = val_lo = None
    if not rank1:
        val_hi, val_lo = bf16_pair_bits(np.concatenate(g_val))
    # pad the staging so block [blk * 128, blk * 128 + 128) stays in bounds
    stage_pad = (-U) % _L + _L
    stage_idx = np.pad(stage_idx, (0, stage_pad))
    if rank1:
        scale = np.pad(scale, (0, stage_pad))
    tier_ptr = tuple(int(x) for x in tier_ptr[:-1]) + (U + stage_pad,)
    return Expansion2Group(
        stage_idx=stage_idx, stage_tier_ptr=tier_ptr, stage_scale=scale,
        lidx=np.concatenate(g_lidx), lrow=np.concatenate(g_lrow), val_hi=val_hi,
        val_lo=val_lo, blk_of=np.concatenate(g_blk),
        tile_of=np.asarray(steps_tile, dtype=np.int32),
        n_steps=len(steps_tile), n_tiles=n_tl)


def build_expansion2_plan(
    csr: CSR,
    R: int = DEFAULT_R,
    G: int = DEFAULT_G,
    stage_tier: int = STAGE_TIER,
    stage_budget: int = DEFAULT_STAGE_BUDGET,
    rank1: Optional[bool] = None,
) -> Expansion2Plan:
    """Host-side v2 plan build. ``rank1``: None = auto-detect, True =
    require rank-1 values (ValueError when they do not factor), False =
    per-lane values."""
    m = csr.shape[1]
    n_tiers = max(-(-m // stage_tier), 1)
    factors = factor_rank1(csr) if rank1 in (None, True) else None
    if rank1 is True and factors is None:
        raise ValueError("rank1=True but values do not factor as r_i*c_j")
    use_rank1 = factors is not None
    row_scale = col_scale = None
    if use_rank1:
        row_scale, col_scale = factors
    tile_data = tile_pass1(csr, R)
    built = tuple(_build_group(g, tile_data, n_tiers, stage_tier, R, G, use_rank1, col_scale)
                  for g in group_tiles(tile_data, stage_budget))
    return Expansion2Plan(
        groups=built, row_scale=(row_scale.astype(np.float32) if use_rank1 else None),
        shape=csr.shape, R=R, G=G, stage_tier=stage_tier)


# ---------------------------------------------------------------------------
# placement (port only)
# ---------------------------------------------------------------------------


def lane_stage_pos(group: Expansion2Group, R: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each lane's staged row ``blk_of[group] * 128 + lidx`` and whether it
    adds anything: its row is below the sentinel R and its value, where
    the plan carries values, is not 0."""
    lidx = np.asarray(group.lidx).astype(np.int64)
    u = (np.asarray(group.blk_of).astype(np.int64)[:, None] * _L + lidx).reshape(-1)
    real = (np.asarray(group.lrow) < R).reshape(-1)
    if group.val_hi is not None:
        real &= (bf16_value(np.asarray(group.val_hi)) + bf16_value(np.asarray(group.val_lo))
                 ).reshape(-1) != 0
    return u, real


def attach_stage_rows(plan: Expansion2Plan, max_lanes: Optional[int] = None) -> Expansion2Plan:
    """The plan with each group's ``stage_row`` derived (vectorised numpy;
    sparse/expansion.py ``stage_rows``), after checking that every real
    lane names a staged row of its group that holds a row of X, and with
    the kernel's work list (sparse/expansion.py ``lane_work``, units of at
    most ``max_lanes`` lanes)."""
    groups, reals = [], []
    for g in plan.groups:
        rows = stage_rows(g.stage_idx, g.stage_tier_ptr, plan.stage_tier, plan.n_cols)
        u, real = lane_stage_pos(g, plan.R)
        check_lanes(u, real, rows, "expansion2 plan")
        groups.append(dataclasses.replace(g, stage_row=rows))
        reals.append(real)
    return dataclasses.replace(plan, groups=tuple(groups),
                               work=lane_work(plan, reals, plan.G * _L, max_lanes))
