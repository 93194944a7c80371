"""Expansion plan: the one-hot expansion SpMM layout (layout="expansion").

The port of the JAX package's sparse/expansion.py. ``build_expansion_plan``
gives, on the same CSR, plan arrays equal to the JAX package's (the
tests hold them array for array, the bf16 values bitwise), so the Hopper
kernel (ops/cuda/expansion.py, csrc/expansion.cu) runs the same plan as
the TPU kernel.

Structure (all plan-time, host-side numpy):

1. Rows are cut into tiles of R rows; each tile's result is one R-row
   block of the output.
2. Per tile, nonzeros are sorted by column and deduplicated: each tile
   stages its unique columns once.
3. Tiles are batched into groups whose staged rows fit a budget
   (``stage_budget`` rows per group).
4. Within a group the staging is tier-major: unique columns are grouped
   by ``stage_tier``-column tier (``stage_idx`` holds tier-local column
   ids, ``stage_tier_ptr`` the tier boundaries), each (tier, tile) run
   padded to 128 rows.
5. A tile's lanes (its nonzeros in column order) are cut into steps of
   TILE lanes whose staged rows fall in at most CW/128 128-row blocks of
   the staging table (``base_blk``, the step's window, padded by
   repeating its last block); each lane carries its window-local staged
   index, its row within the tile and its value as a bf16 pair. Padding
   lanes carry index 0, row 0 and value 0.

The plan keeps each bf16 value as its 16 bits (``uint16``): numpy has no
bf16 type, and the bits are what the JAX package's ``jnp.bfloat16``
arrays hold (round to nearest even on both sides).

Placement (``attach_stage_rows``, port only): the TPU kernel reads a
staged table that XLA gathers before the kernel, one take per tier. The
Hopper kernel gathers X rows itself, so placement derives per group
``stage_row[u]``, the X row that staged row ``u`` holds (the tier clamp
and the take's clip included), and refuses a plan whose lanes name a
staged row outside the table. It also derives the kernel's work list
(``lane_work``, shared with v2): the real lanes sorted by 128-row output
block and row, cut into balanced work units with the panel engine's
``work_units``.

Reference semantics: gather x segment-sum
(oneflow/user/ops/gather_op.cpp, unsorted_segment_sum_op.cpp).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.sparse import panels
from of_spmm_tpu_torch.sparse.formats import CSR

DEFAULT_R = 512          # output rows per tile
DEFAULT_TILE = 1024      # lanes per kernel step
DEFAULT_CW = 512         # staging window rows per step (multiple of 128)
STAGE_TIER = 32768       # columns per staging tier
DEFAULT_STAGE_BUDGET = 4 * 1024 * 1024  # staged rows per group
_BLK = 128               # window block granularity
UNIT_LANES = 2048        # real lanes per work unit of the kernel (port only)


@dataclasses.dataclass(frozen=True)
class ExpansionGroup:
    """One group of row tiles: its staging lists, lanes and step tables."""

    # staging: per-tier LOCAL column ids, concatenated tier-major
    stage_idx: np.ndarray            # (U,) int32: col - tier * stage_tier
    stage_tier_ptr: Tuple[int, ...]  # (n_tiers + 1,) python ints

    # lanes, blocked into steps of TILE: (n_steps * TILE / 128, 128)
    win_lidx: np.ndarray   # int32, window-local staged index in [0, CW)
    lrow: np.ndarray       # int32, row within the tile in [0, R)
    val_hi: np.ndarray     # uint16: bf16 bits of the value
    val_lo: np.ndarray     # uint16: bf16 bits of the residual

    # per step: the CW/128 independent 128-row staging blocks of the
    # step's window, and the step's tile, LOCAL to the group
    base_blk: np.ndarray   # (n_steps * CW / 128,) int32
    tile_of: np.ndarray    # (n_steps,) int32

    n_steps: int
    n_tiles: int
    stage_row: Optional[np.ndarray] = None  # port only: (U,) int32 X row of each staged row


@dataclasses.dataclass(frozen=True)
class LaneWork:
    """The expansion kernel's work list (port only, both engines; built by
    ``lane_work``). A key is a 128-row output block, ``tile * ceil(R /
    128) + row // 128`` with tiles counted over the whole plan. ``lanes``
    lists every real lane (a lane that adds a row: below the row sentinel,
    value not 0) by its index in its group's lane arrays, group by group,
    sorted by key and then output row. Unit u covers
    ``lanes[units[u, 1]:units[u, 2]]`` of group ``units[u, 3]``, all of
    key ``units[u, 0]`` (``~key`` when the key has several units;
    ``split_keys`` lists those keys); a key without lanes has one empty
    unit, which writes its zero rows. The units of one key run together
    (they read the same tile's X rows, which L2 then holds), keys
    heaviest first by their lanes (hub tiles start at once), a key's
    units heaviest first.
    ``table`` and ``ptrs`` are set on the card (ops/cuda/expansion.py
    place_plan): each group's array pointers. The kernel's op builds the
    same table from the groups it is given at each call."""

    lanes: np.ndarray       # (n_real,) int32
    units: np.ndarray       # (n_units, 4) int32 [key or ~key, first, end, group]
    split_keys: np.ndarray  # (n_split,) int32
    E: int                  # lanes per unit at most (a key's run cut greedily)
    table: Optional[np.ndarray] = None  # (n_groups, 8) int64
    ptrs: Tuple[int, ...] = ()


def lane_work(plan, reals, lanes_per_step: int, max_lanes: Optional[int] = None) -> LaneWork:
    """The work list of an ExpansionPlan or Expansion2Plan (see LaneWork):
    ``reals[g]`` marks group g's real lanes, ``lanes_per_step`` is a
    step's lanes (TILE, or G * 128). Each key's run of lanes is cut into
    units of at most ``max_lanes`` lanes (UNIT_LANES by default) by
    sparse/panels.py ``work_units``, each lane a slot of one count, and
    the units are ordered key by key, heaviest key first."""
    E = UNIT_LANES if max_lanes is None else int(max_lanes)
    nwb = -(-plan.R // _BLK)
    keys, lanes = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    first_tile = [0]
    for g, real in zip(plan.groups, reals):
        e = np.nonzero(np.asarray(real).reshape(-1))[0]
        lrow = np.asarray(g.lrow).reshape(-1)[e].astype(np.int64)
        tile = first_tile[-1] + np.asarray(g.tile_of).astype(np.int64)[e // lanes_per_step]
        key = tile * nwb + lrow // _BLK
        order = np.lexsort((lrow, key))
        keys.append(key[order])
        lanes.append(e[order])
        first_tile.append(first_tile[-1] + g.n_tiles)
    key = np.concatenate(keys)
    _slots, units, split = panels.work_units(key, np.ones(key.shape[0], np.int64), 1,
                                             first_tile[-1] * nwb, E)
    k = np.where(units[:, 0] < 0, ~units[:, 0], units[:, 0]).astype(np.int64)
    size = (units[:, 2] - units[:, 1]).astype(np.int64)
    key_lanes = np.bincount(k, weights=size, minlength=first_tile[-1] * nwb)
    order = np.lexsort((-size, k, -key_lanes[k]))
    units, k = units[order], k[order]
    group = np.searchsorted(np.asarray(first_tile), k // nwb, side="right") - 1
    return LaneWork(lanes=np.concatenate(lanes).astype(np.int32),
                    units=np.concatenate([units, group[:, None]], 1).astype(np.int32),
                    split_keys=split.astype(np.int32), E=E)


@dataclasses.dataclass(frozen=True)
class ExpansionPlan:
    """The one-hot expansion SpMM plan of one direction of A."""

    groups: Tuple[ExpansionGroup, ...]
    shape: Tuple[int, int]   # logical (n_rows, n_cols)
    R: int
    TILE: int
    CW: int
    stage_tier: int = STAGE_TIER
    work: Optional[LaneWork] = None  # port only: the kernel's work list (placement)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

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
        lanes = self.n_steps * self.TILE
        return float(true_nnz) / lanes if lanes else 1.0


def bf16_bits(v: np.ndarray) -> np.ndarray:
    """The bf16 rounding (to nearest even) of float32 ``v``, as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    """The float32 value of bf16 ``bits`` (exact)."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def bf16_pair_bits(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) bf16 bits of float32 ``v`` as the JAX package splits plan
    values: hi = bf16(v), lo = bf16(v - hi)."""
    v = np.asarray(v, dtype=np.float32)
    hi = bf16_bits(v)
    return hi, bf16_bits(v - bf16_value(hi))


def tile_pass1(csr: CSR, R: int) -> List[tuple]:
    """Pass 1 of both expansion plans: per R-row tile, (unique columns,
    each lane's index into them, each lane's row in the tile, each lane's
    value), lanes in column order. The native planner's per-tile sort when
    it is available, numpy otherwise; both give the same lanes."""
    from of_spmm_tpu_torch import native

    n, _m = csr.shape
    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols_all = np.asarray(csr.cols).astype(np.int64)
    vals_all = np.asarray(csr.vals).astype(np.float32)
    n_tiles = max(-(-n // R), 1)
    starts = indptr[np.minimum(np.arange(n_tiles + 1) * R, n)]
    tile_data = []
    nat = native.expansion_pass1(indptr, cols_all, vals_all, R)
    if nat is not None:
        lane_inv, lane_row, lane_val, uniq_cols, uniq_ptr = nat
        for t in range(n_tiles):
            lo, hi = starts[t], starts[t + 1]
            tile_data.append((
                uniq_cols[uniq_ptr[t]:uniq_ptr[t + 1]].astype(np.int64),
                lane_inv[lo:hi].astype(np.int64),
                lane_row[lo:hi].astype(np.int64),
                lane_val[lo:hi],
            ))
        return tile_data
    for t in range(n_tiles):
        lo, hi = starts[t], starts[t + 1]
        c = cols_all[lo:hi]
        v = vals_all[lo:hi]
        r = np.repeat(np.arange(min(R, n - t * R), dtype=np.int64),
                      np.diff(indptr[t * R:min((t + 1) * R, n) + 1]))
        order = np.argsort(c, kind="stable")
        c, v, r = c[order], v[order], r[order]
        uniq, inv = np.unique(c, return_inverse=True)
        tile_data.append((uniq, inv, r, v))
    return tile_data


def group_tiles(tile_data: List[tuple], stage_budget: int) -> List[List[int]]:
    """Consecutive tiles batched greedily so a group's unique columns stay
    within ``stage_budget`` rows (a tile over the budget is a group alone)."""
    groups, cur, cur_u = [], [], 0
    for t, data in enumerate(tile_data):
        u = data[0].shape[0]
        if cur and cur_u + u > stage_budget:
            groups.append(cur)
            cur, cur_u = [], 0
        cur.append(t)
        cur_u += u
    if cur:
        groups.append(cur)
    return groups


def _build_group(tiles, tile_data, n_tiers, stage_tier, R, TILE, CW) -> ExpansionGroup:
    """Assemble one group's arrays from its tiles' (uniq, inv, rows, vals)."""
    n_tl = len(tiles)
    seg_len = np.zeros((n_tiers, n_tl), dtype=np.int64)
    for j, t in enumerate(tiles):
        seg_len[:, j] = np.bincount(tile_data[t][0] // stage_tier, minlength=n_tiers)
    # each (tier, tile) staging run padded to 128 rows: a window block then
    # belongs to one run
    seg_pad = -(-seg_len // _BLK) * _BLK
    flat = seg_pad.reshape(-1)
    run_off = np.zeros(flat.shape[0] + 1, dtype=np.int64)
    np.cumsum(flat, out=run_off[1:])
    run_off = run_off[:-1].reshape(n_tiers, n_tl)
    tier_ptr = [0] + list(np.cumsum(seg_pad.sum(axis=1)))
    U = int(tier_ptr[-1])

    nblk = CW // _BLK
    stage_idx = np.zeros(U, dtype=np.int32)
    steps_base, steps_tile = [], []
    lanes_lidx, lanes_row, lanes_val = [], [], []
    for j, t in enumerate(tiles):
        uniq, inv, r, v = tile_data[t]
        tiers = uniq // stage_tier
        within = np.arange(uniq.shape[0], dtype=np.int64)
        tier_first = np.searchsorted(tiers, np.arange(n_tiers), side="left")
        gpos = run_off[tiers, j] + within - tier_first[tiers]
        stage_idx[gpos] = (uniq - tiers * stage_tier).astype(np.int32)
        gidx = gpos[inv]  # per lane, non-decreasing within each tier run
        mlanes = gidx.shape[0]
        # a step's window is nblk arbitrary 128-row staging blocks, so steps
        # pack lanes across tier-run boundaries; walk the runs of lanes that
        # share a staging block
        lane_blk = gidx // _BLK
        bnd = np.nonzero(np.diff(lane_blk))[0] + 1
        run_starts = np.concatenate([[0], bnd, [mlanes]])
        nruns = run_starts.shape[0] - 1
        ri = 0
        i = 0
        while i < mlanes:
            blocks = []
            k = i
            rj = ri
            while rj < nruns and k < i + TILE and len(blocks) <= nblk:
                b = int(lane_blk[run_starts[rj]])
                if b not in blocks:
                    if len(blocks) == nblk:
                        break
                    blocks.append(b)
                run_end = int(run_starts[rj + 1])
                if run_end - i > TILE:  # the run outlasts the step
                    k = i + TILE
                    break
                k = run_end
                rj += 1
            blk_arr = np.asarray(blocks, dtype=np.int64)
            seg_blk = lane_blk[i:k]
            pos = np.searchsorted(blk_arr, seg_blk)  # blocks ascend per tile
            li = (pos * _BLK + (gidx[i:k] - seg_blk * _BLK)).astype(np.int32)
            pad = TILE - (k - i)
            lanes_lidx.append(np.pad(li, (0, pad)))
            lanes_row.append(np.pad(r[i:k].astype(np.int32), (0, pad)))
            lanes_val.append(np.pad(v[i:k], (0, pad)))  # pad value 0
            blocks += [blocks[-1]] * (nblk - len(blocks))
            steps_base.append(blocks)
            steps_tile.append(j)
            i = k
            ri = rj

    n_steps = len(steps_base)

    def lanes(parts, dtype):
        return (np.concatenate(parts) if parts else np.zeros(0, dtype)).astype(dtype)

    val_hi, val_lo = bf16_pair_bits(lanes(lanes_val, np.float32))
    # pad the staging so every window [base_blk * 128, + CW) stays in bounds
    stage_pad = -U % _BLK + CW
    stage_idx = np.pad(stage_idx, (0, stage_pad))
    tier_ptr = tuple(int(x) for x in tier_ptr[:-1]) + (U + stage_pad,)
    return ExpansionGroup(
        stage_idx=stage_idx,
        stage_tier_ptr=tier_ptr,
        win_lidx=lanes(lanes_lidx, np.int32).reshape(-1, 128),
        lrow=lanes(lanes_row, np.int32).reshape(-1, 128),
        val_hi=val_hi.reshape(-1, 128),
        val_lo=val_lo.reshape(-1, 128),
        base_blk=np.asarray(steps_base, dtype=np.int32).reshape(-1),
        tile_of=np.asarray(steps_tile, dtype=np.int32),
        n_steps=n_steps,
        n_tiles=n_tl,
    )


def build_expansion_plan(
    csr: CSR,
    R: int = DEFAULT_R,
    TILE: int = DEFAULT_TILE,
    CW: int = DEFAULT_CW,
    stage_tier: int = STAGE_TIER,
    stage_budget: int = DEFAULT_STAGE_BUDGET,
) -> ExpansionPlan:
    """Host-side plan build (numpy). See the module docstring for the layout."""
    if CW % _BLK:
        raise ValueError(f"CW must be a multiple of {_BLK}, got {CW}")
    if TILE % 128:
        raise ValueError(f"TILE must be a multiple of 128, got {TILE}")
    m = csr.shape[1]
    n_tiers = max(-(-m // stage_tier), 1)
    tile_data = tile_pass1(csr, R)
    built = tuple(_build_group(g, tile_data, n_tiers, stage_tier, R, TILE, CW)
                  for g in group_tiles(tile_data, stage_budget))
    return ExpansionPlan(groups=built, shape=csr.shape, R=R, TILE=TILE, CW=CW,
                         stage_tier=stage_tier)


# ---------------------------------------------------------------------------
# placement (port only)
# ---------------------------------------------------------------------------


def stage_rows(stage_idx, tier_ptr, stage_tier: int, n_x: int) -> np.ndarray:
    """The X row each staged row holds, as the TPU wrapper's staging gives
    it: tier t's slice of the staging list is a take, with its indices
    clipped, from X[lo:hi], lo = min(t * stage_tier, n_x - 1),
    hi = min((t + 1) * stage_tier, n_x). Rows of an X without rows are -1."""
    idx = np.asarray(stage_idx).astype(np.int64)
    if n_x == 0:
        return np.full(idx.shape, -1, np.int32)
    ptr = np.asarray(tier_ptr, dtype=np.int64)
    tier = np.repeat(np.arange(ptr.shape[0] - 1, dtype=np.int64), np.diff(ptr))
    lo = np.minimum(tier * stage_tier, n_x - 1)
    hi = np.minimum((tier + 1) * stage_tier, n_x)
    return (lo + np.clip(idx, 0, hi - lo - 1)).astype(np.int32)


def check_lanes(u: np.ndarray, real: np.ndarray, stage_row: np.ndarray, what: str) -> None:
    """Refuse lanes that name a staged row outside the group's table, or
    one that holds no row of X."""
    u = u[real]
    if u.size == 0:
        return
    bad = (u < 0) | (u >= stage_row.shape[0])
    if bad.any():
        raise ValueError(f"{what}: a lane names staged row {int(u[bad][0])}, beyond the "
                         f"group's {stage_row.shape[0]}-row staging table")
    if (stage_row[u] < 0).any():
        raise ValueError(f"{what}: a lane names a staged row that holds no row of x")


def lane_stage_pos(group: ExpansionGroup, CW: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each lane's staged row ``base_blk[s * CW/128 + li // 128] * 128 +
    li % 128`` and whether it adds anything (its value is not 0; padding
    lanes carry value 0)."""
    nblk = CW // _BLK
    li = np.asarray(group.win_lidx).reshape(-1).astype(np.int64)
    per_step = li.shape[0] // max(group.n_steps, 1)
    step = np.arange(li.shape[0], dtype=np.int64) // max(per_step, 1)
    base = np.asarray(group.base_blk).astype(np.int64)
    u = base[step * nblk + li // _BLK] * _BLK + li % _BLK
    val = (bf16_value(np.asarray(group.val_hi).reshape(-1))
           + bf16_value(np.asarray(group.val_lo).reshape(-1)))
    return u, val != 0


def attach_stage_rows(plan: ExpansionPlan, max_lanes: Optional[int] = None) -> ExpansionPlan:
    """The plan with each group's ``stage_row`` derived (vectorised numpy),
    after checking that every lane with a value names a staged row of its
    group that holds a row of X, and with the kernel's work list
    (``lane_work``, units of at most ``max_lanes`` lanes)."""
    groups, reals = [], []
    for g in plan.groups:
        rows = stage_rows(g.stage_idx, g.stage_tier_ptr, plan.stage_tier, plan.n_cols)
        u, real = lane_stage_pos(g, plan.CW)
        check_lanes(u, real, rows, "expansion plan")
        groups.append(dataclasses.replace(g, stage_row=rows))
        reals.append(real)
    return dataclasses.replace(plan, groups=tuple(groups),
                               work=lane_work(plan, reals, plan.TILE, max_lanes))


def plan_memory_report(plan, d: int = 128, hbm_limit: Optional[int] = None) -> dict:
    """Device-memory model of one SpMM at width ``d`` through a placed
    ExpansionPlan or Expansion2Plan: the plan arrays as the port keeps
    them on the card (``stage_idx`` included, values as bf16 bits), the
    provenance placement adds (``stage_row``: one int32 per staged row),
    X and the output. The port builds no staged table: the kernels read
    staged rows straight from X."""
    from of_spmm_tpu_torch.sparse.fused import _BUDGET_FRACTION, _nbytes, device_hbm_bytes

    hbm = hbm_limit or device_hbm_bytes()
    n, m = plan.shape
    plan_b = _nbytes(getattr(plan, "row_scale", None))
    prov_b = 0
    for g in plan.groups:
        for f in dataclasses.fields(g):
            a = getattr(g, f.name)
            if f.name == "stage_row":
                prov_b += int(g.stage_idx.shape[0]) * 4
            elif isinstance(a, (np.ndarray, torch.Tensor)):
                plan_b += _nbytes(a)
    x_b, out_b = m * d * 4, n * d * 4
    peak = plan_b + prov_b + x_b + out_b
    budget = int(_BUDGET_FRACTION * hbm)
    return {"plan_bytes": plan_b, "stage_row_bytes": prov_b, "x_bytes": x_b,
            "out_bytes": out_b, "peak_bytes": peak, "hbm_bytes": hbm,
            "budget_bytes": budget, "fits": peak <= budget}
