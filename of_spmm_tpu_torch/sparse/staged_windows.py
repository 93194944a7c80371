"""Window provenance of the fused and ranges plans (port only).

Both engines compute over a window of X rows per step: ``[hot | staged]``
(fused) or ``[hot | range | scattered]`` (ranges). The plan's control
stream says where the TPU kernel copies rows (staged rows, cq-row blocks
of a take table, RQ-row range chunks), not where a compute step's
window rows came from: earlier steps issued those copies. ``attach_windows``
replays each segment's stream once on the host, in the order the step
oracles (sparse/fused_sim.py, sparse/ranges_sim.py) apply it, and
records per compute step where its window rows live in X, so the Hopper
kernels (csrc/staged_spmm.cuh) read them straight from X and need no
staging buffers, take table or hot table.

Window row ``pos`` of compute step ``s`` resolves to an X row as follows,
with ``sw = step_win[s]``:

- ``pos < H``: ``hot_ids[pos]``;
- ``H <= pos < H + RC`` (ranges): ``range_rows[sw[0], p // RQ] + p % RQ``
  with ``p = pos - H``: the X row at which the copy of that RQ-row chunk
  started (``-1``: never copied);
- ``q = pos - H - RC >= 0``: ``staged_rows[sw[1] + q]`` for ``q < sw[2]``
  (``-1``: never copied).

The staged slice is a snapshot of the step's (virtual) tile, taken at its
first step; the replay checks that no later step of the tile overwrites
it. Rows at or past ``m`` and below the padded height ``xs_rows`` are the
TPU wrapper's zero padding and read as zero.

Placement also derives the kernel's work list (``work_list``): the group
slots with real selections, cut into balanced work units with the panel
engine's ``work_units``. A unit's key is the output block its steps
write: the tile, or in window mode the tile's 128-row window block
``tile * ceil(R / 128) + ctrl[10]`` (window blocks of one tile interleave
across its virtual tiles, so such a block is split).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.sparse import panels

_L = 128
# control words the replay reads (both engines' ctrl layouts)
C_TILE, C_TFIRST, C_SBASE, C_SCNT, C_RCNT, C_SREAD = 0, 1, 2, 3, 4, 5
C_RFIRST, C_RREAD = 10, 11
C_WIN = 10  # fused window mode: the step's 128-row output window


@dataclasses.dataclass(frozen=True)
class StagedWindows:
    """Where each compute step's window rows come from (see the module
    docstring). Zeros in ``step_win`` rows of non-compute steps."""

    step_win: np.ndarray     # (n_steps, 3) int32 [range window, staged offset, extent]
    range_rows: np.ndarray   # (n_windows, RC // RQ) int32
    staged_rows: np.ndarray  # (N,) int32
    # the kernel's work list (``work_list``; sparse/panels.py work_units):
    # unit u covers unit_slots[units[u, 1]:units[u, 2]], the slots
    # (step * G + g) with real selections, in step order, of one key
    # units[u, 0] (~key when the key has several units; split_tiles lists
    # those keys); heaviest first; a key without selections has one empty
    # unit, which writes its zero rows
    unit_slots: np.ndarray   # (n_live_slots,) int32
    units: np.ndarray        # (n_units, 3) int32 [key or ~key, first, end]
    split_tiles: np.ndarray  # (n_split,) int32 keys


def geometry(plan) -> Tuple[int, int, int, int, int]:
    """(H, RC, RQ, xs_rows, lane sentinel) of a FusedPlan or RangesPlan.
    ``xs_rows`` is the height of the X the TPU wrapper pads (ranges: to
    cover a full range window); the sentinel is the lrow of padding
    lanes (the tile height, or 128 in window mode)."""
    m = plan.shape[1]
    if hasattr(plan, "RC"):
        return plan.n_hot, plan.RC, plan.RQ, max(-(-m // _L) * _L, plan.RC), plan.R
    return plan.n_hot, 0, 1, m, (_L if plan.window else plan.R)


def _t(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def unit_geometry(plan) -> Tuple[int, int]:
    """(window blocks per tile, rows of a key's output block) of a
    FusedPlan or RangesPlan: a key is a tile of R rows, or in window mode
    one of a tile's ceil(R / 128) window blocks of (up to) 128 rows."""
    nwb = -(-plan.R // _L)
    return (nwb, _L) if getattr(plan, "window", False) else (1, plan.R)


def slot_selections(plan, seg) -> np.ndarray:
    """Window-row selections of each group slot's real lanes (int64,
    steps * G): the set bits of multi-hot lanes' masks, or the count of
    one-hot lanes. Takes the plan's numpy arrays or placed tensors."""
    real = _np(seg.lrow) < geometry(plan)[4]
    if not plan.multihot:
        return real.sum(1).astype(np.int64)
    out = np.zeros(real.shape[0], np.int64)
    for s0 in range(0, real.shape[0], 4096):  # (slots, 4, 128) words, in chunks
        words = _np(seg.lidx[s0:s0 + 4096]).view(np.uint32)
        bits = np.bitwise_count(words) * real[s0:s0 + 4096, None, :]
        out[s0:s0 + 4096] = bits.reshape(bits.shape[0], -1).sum(1)
    return out


def unit_keys(plan, seg) -> Tuple[np.ndarray, int]:
    """Each step's unit key (-1 on steps that compute nothing) and the
    segment's number of keys: the step's tile, or in window mode its
    window block ``tile * ceil(R / 128) + ctrl[10]``."""
    ctrl = _np(seg.ctrl)[:, 0, :].astype(np.int64)
    nwb, _rows = unit_geometry(plan)
    key = ctrl[:, C_TILE]
    if getattr(plan, "window", False):
        key = np.where(key >= 0, key * nwb + ctrl[:, C_WIN], -1)
    return key, seg.n_tiles * nwb


def work_list(plan, seg):
    """The kernel's work list for one segment, ``(unit_slots, units,
    split_tiles)`` (see StagedWindows): each key's slots with real
    selections cut into units of at most sparse/panels.py UNIT_EDGES
    selections (sparse/panels.py work_units); a denser single slot is a
    unit alone."""
    key, n_keys = unit_keys(plan, seg)
    return panels.work_units(key, slot_selections(plan, seg), plan.T // _L, n_keys,
                             panels.UNIT_EDGES)


def used_window_rows(plan, seg) -> Tuple[np.ndarray, np.ndarray]:
    """(step, pos) int64 of every window row a real lane of the segment
    reads, one entry per (group slot, window row): the OR of the group's
    lane masks (multi-hot) or its real lanes' indices (one-hot)."""
    G = plan.T // _L
    _H, _RC, _RQ, _xs, sent = geometry(plan)
    lrow = np.asarray(seg.lrow)
    lidx = np.asarray(seg.lidx)
    real = lrow < sent
    if plan.multihot:
        words = np.bitwise_or.reduce(np.where(real[:, None, :], lidx, 0), axis=2)
        bits = (words.astype(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        slot, w = np.nonzero(bits.reshape(-1, _L))
    else:
        slot, lane = np.nonzero(real)
        w = lidx[slot, lane].astype(np.int64)
        key = np.unique(slot.astype(np.int64) * _L + w)
        slot, w = key // _L, key % _L
    step = slot.astype(np.int64) // G
    pos = np.asarray(seg.blk)[step, 0, slot % G].astype(np.int64) * _L + w
    return step, pos


def _table_rows(seg, stage_tier: int, rows: int) -> np.ndarray:
    """X row of each row of a chunks-mode take table: tier t's entries are
    tier-local indices, clamped to the tier's last row of the (padded)
    X."""
    take = np.asarray(seg.stage_take).astype(np.int64)
    out = np.zeros(take.shape[0], np.int64)
    ptr = seg.stage_tier_ptr
    for t in range(len(ptr) - 1):
        lo, hi = ptr[t], ptr[t + 1]
        if hi > lo:
            last = min((t + 1) * stage_tier, rows) - t * stage_tier - 1
            out[lo:hi] = t * stage_tier + np.minimum(take[lo:hi], last)
    return out


def segment_windows(plan, seg) -> StagedWindows:  # noqa: C901
    """Replay one segment's control stream and record each compute step's
    window provenance. Raises ValueError where the stream does not have
    the shape the kernel relies on: a tile's staged rows unchanged over
    its steps, range copies RQ-aligned."""
    H, RC, RQ, xs_rows, _sent = geometry(plan)
    ranges = RC > 0
    chunks = ranges or plan.staging == "chunks"
    S_buf, cq = plan.S_buf, plan.cq
    n_rq = RC // RQ if ranges else 0
    if ranges and (RC % _L or RC % RQ):
        raise ValueError(f"range window RC={RC} must be a multiple of 128 and of RQ={RQ}")
    ctrl = np.asarray(seg.ctrl)[:, 0, :].astype(np.int64)
    n_steps = seg.n_steps
    comp = ctrl[:, C_TILE] >= 0
    # virtual tile of each compute step, and its staged extent: the last
    # staged window row any real lane of the tile reads
    vt_of = np.cumsum(comp & (ctrl[:, C_TFIRST] == 1)) - 1
    if comp.any() and vt_of[np.argmax(comp)] < 0:
        raise ValueError("the first compute step does not open a tile")
    n_vt = int(vt_of.max()) + 1 if comp.any() else 0
    step, pos = used_window_rows(plan, seg)
    if not comp[step].all():
        raise ValueError("a real lane lies in a step that computes no tile")
    q = pos - H - RC
    ext = np.zeros(max(n_vt, 1), np.int64)
    np.maximum.at(ext, vt_of[step[q >= 0]], q[q >= 0] + 1)

    if chunks:
        table_x = _table_rows(seg, plan.stage_tier, xs_rows)
        scols = np.asarray(seg.scols)
        lane = np.arange(cq, dtype=np.int64)
    else:
        scols = np.asarray(seg.scols).reshape(n_steps, -1)
    rcopy = np.asarray(seg.rcopy) if ranges else None
    region = np.full(2 * S_buf, -1, np.int64)  # staged / scattered scratch: X row
    chunk_src = np.full(2 * n_rq, -1, np.int64)  # range scratch, per RQ chunk
    win_range = [-1, -1]                          # per parity: range window
    range_rows, staged, offsets = [], [], np.zeros(max(n_vt, 1), np.int64)
    n_staged = 0
    cur = None  # (base, extent) of the current virtual tile
    step_win = np.zeros((n_steps, 3), np.int32)
    for i in range(n_steps):
        c = ctrl[i]
        v = vt_of[i]
        if comp[i] and c[C_TFIRST]:
            cur = (int(c[C_SREAD]), int(ext[v]))
            if cur[0] + cur[1] > 2 * S_buf:
                raise ValueError(f"step {i}: staged window past the scratch")
        cnt = int(c[C_SCNT])
        dst = None
        if cnt and chunks:
            sb = scols[i, 0, :cnt].astype(np.int64)
            db = scols[i, 1, :cnt].astype(np.int64)
            dst = (db[:, None] * cq + lane).ravel()
            region[dst] = table_x[(sb[:, None] * cq + lane).ravel()]
        elif cnt:
            base = int(c[C_SBASE])
            region[base:base + cnt] = scols[i, :cnt]
            dst = np.arange(base, base + cnt)
        # the TPU kernel reads a chunks-mode tile's staged rows live, and
        # a rows-mode tile's as split at its first step: no copy may land
        # in them meanwhile
        if (dst is not None and comp[i] and (chunks or c[C_TFIRST])
                and ((dst >= cur[0]) & (dst < cur[0] + cur[1])).any()):
            raise ValueError(f"step {i} overwrites the staged rows its tile reads")
        if ranges:
            for k in range(int(c[C_RCNT])):
                if rcopy[i, 1, k] % RQ:
                    raise ValueError(f"step {i}: range copy to row {rcopy[i, 1, k]} "
                                     f"is not RQ={RQ}-aligned")
                chunk_src[rcopy[i, 1, k] // RQ] = rcopy[i, 0, k]
        if not comp[i]:
            continue
        rpar = 0
        if ranges:
            rpar = int(c[C_RREAD]) // RC
            if c[C_RFIRST]:
                range_rows.append(chunk_src[rpar * n_rq:(rpar + 1) * n_rq].copy())
                win_range[rpar] = len(range_rows) - 1
        if c[C_TFIRST]:
            staged.append(region[cur[0]:cur[0] + cur[1]].copy())
            offsets[v] = n_staged
            n_staged += cur[1]
        step_win[i] = (win_range[rpar] if ranges else -1, offsets[v], ext[v])
    unit_slots, units, split_tiles = work_list(plan, seg)
    return StagedWindows(
        step_win=step_win,
        range_rows=(np.stack(range_rows) if range_rows
                    else np.zeros((0, n_rq), np.int64)).astype(np.int32),
        staged_rows=(np.concatenate(staged) if staged
                     else np.zeros(0, np.int64)).astype(np.int32),
        unit_slots=unit_slots,
        units=units,
        split_tiles=split_tiles,
    )


def resolve_window_rows(plan, seg, step, pos):
    """X row and scale of window row ``pos`` of compute step ``step``
    (int64 tensors of one shape), through the segment's StagedWindows:
    ``(src, scale, bad)``. ``scale`` is ``col_scale`` of the row (1 for
    general plans); a row of the zero padding has scale 0. ``bad`` marks
    rows that resolve to nothing copied or outside the padded X: no real
    lane may read one. Works on the plan's numpy arrays (as CPU tensors)
    or on its placed tensors."""
    win = seg.windows
    dev = pos.device
    H, RC, RQ, xs_rows, _sent = geometry(plan)
    m = plan.shape[1]
    sw = _t(win.step_win).to(dev).long()[step]
    src = torch.full_like(pos, -1)
    if H:
        hot = pos < H
        src = torch.where(hot, _t(plan.hot_ids).to(dev).long()[pos.clamp(0, H - 1)], src)
    if RC:
        p = pos - H
        rr = _t(win.range_rows).to(dev).long()
        if rr.shape[0]:
            rng = (p >= 0) & (p < RC) & (sw[:, 0] >= 0)
            start = rr[sw[:, 0].clamp(min=0), (p // RQ).clamp(0, RC // RQ - 1)]
            src = torch.where(rng & (start >= 0), start + p % RQ, src)
    q = pos - H - RC
    rows = _t(win.staged_rows).to(dev).long()
    if rows.shape[0]:
        st = (q >= 0) & (q < sw[:, 2])
        src = torch.where(st, rows[(sw[:, 1] + q).clamp(0, rows.shape[0] - 1)], src)
    bad = (src < 0) | (src >= xs_rows)
    zero = bad | (src >= m)
    src = torch.where(zero, 0, src)
    scale = torch.ones(pos.shape, dtype=torch.float32, device=dev)
    if plan.col_scale is not None:
        scale = _t(plan.col_scale).to(dev)[src]
    return src, torch.where(zero, 0.0, scale), bad


def attach_windows(plan):
    """Derive every segment's StagedWindows and check, on the host, that
    every window row a real lane reads resolves to a row of X (a plan bug
    otherwise: raises ValueError). Segments that carry their windows
    already pass through."""
    segs = []
    for seg in plan.segments:
        if seg.windows is not None:
            segs.append(seg)
            continue
        seg = dataclasses.replace(seg, windows=segment_windows(plan, seg))
        step, pos = used_window_rows(plan, seg)
        _src, _scale, bad = resolve_window_rows(plan, seg, torch.from_numpy(step),
                                                torch.from_numpy(pos))
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise ValueError(f"a lane of step {int(step[i])} reads window row "
                             f"{int(pos[i])}, which resolves to no row of X")
        segs.append(seg)
    return dataclasses.replace(plan, segments=tuple(segs))
