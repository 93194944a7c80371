"""What the fused and the ranges kernels share: the plain versions, the
plan checks and the per-segment launcher.

Both kernels (csrc/fused.cu, csrc/ranges.cu, built on
csrc/staged_spmm.cuh) take a placed FusedPlan or RangesPlan: its arrays
as tensors on the card and, per segment, the window provenance and the
work list (sparse/staged_windows.py StagedWindows) that placement
derives. ``define_op`` registers each engine's ``ofs::`` op
(ops/cuda/library.py), through which its wrapper runs the plain version
on the CPU and this launcher on the card. ``staged_spmm_units_torch``
repeats the kernel's split into work units (partial sums, row-scaled,
added per output block) in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from of_spmm_tpu_torch.ops.cuda import library
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream
from of_spmm_tpu_torch.sparse.staged_windows import (
    _L, geometry, resolve_window_rows, unit_geometry)
from of_spmm_tpu_torch.utils.config import FLAGS

# group slots the plain version decodes at once: slots x 16384 bits
_PLAIN_SLOTS = 1024
C_TILE, C_WIN = 0, 10


def bind(fn) -> None:
    """argtypes of ofs_fused_spmm / ofs_ranges_spmm (same signature)."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p] * 16 + [i64] * 7 + [i32] * 8 + [p]
    fn.restype = i32


def check_plan(plan, x: torch.Tensor, plan_type, what: str) -> None:
    if not isinstance(plan, plan_type):
        raise TypeError(f"{what} takes a {plan_type.__name__}, got {type(plan).__name__}")
    require(x, "x", torch.float32, 2)
    if x.shape[0] != plan.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows, the plan {plan.shape[1]} columns")
    for seg in plan.segments:
        if seg.windows is None:
            raise ValueError("the plan is not placed: run ops.place_operator (it "
                             "attaches the window provenance)")
        if not isinstance(seg.lidx, torch.Tensor):
            raise TypeError("the plan's arrays must be torch tensors (ops.place_operator)")
        same_device(x, seg.lidx, seg.ctrl, seg.windows.step_win, seg.windows.units)


def _selections(plan, seg, slots: torch.Tensor):
    """Decode the real lanes of group slots ``slots`` (int64) of a
    segment: ``(i, lrow, step, src, scale)`` per selection, with ``i`` the
    index into ``slots``, ``lrow`` the lane's row, ``src`` the X row its
    window row resolves to and ``scale`` the multiplier (col_scale of the
    row, times the lane's value on one-hot plans)."""
    G = plan.T // _L
    sent = geometry(plan)[4]
    lrow = seg.lrow[slots].long()
    real = lrow < sent
    val = None
    if plan.multihot:
        shifts = torch.arange(32, dtype=torch.int32, device=slots.device).view(1, 1, 32, 1)
        bits = (seg.lidx[slots].unsqueeze(2) >> shifts) & 1  # (S, 4, 32, 128)
        i, k, b, lane = (bits.bool() & real[:, None, None, :]).nonzero(as_tuple=True)
        w = k * 32 + b
    else:
        i, lane = real.nonzero(as_tuple=True)
        w = seg.lidx[slots][i, lane].long()
        if seg.val_hi is not None:
            val = seg.val_hi[slots][i, lane] + seg.val_lo[slots][i, lane]
    step = slots[i] // G
    pos = seg.blk[:, 0, :].long()[step, slots[i] % G] * _L + w
    src, scale, bad = resolve_window_rows(plan, seg, step, pos)
    if bool(bad.any()):
        raise IndexError("a lane reads a window row that resolves to no row of x")
    return i, lrow[i, lane], step, src, scale if val is None else scale * val


def staged_spmm_torch(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of both kernels on the same placed plan: decode each
    chunk of steps' lanes into (window row, output row, value)
    selections, resolve the window rows to X rows (resolve_window_rows),
    and ``index_add_`` the scaled rows into the output."""
    n, _m = plan.shape
    d = x.shape[1]
    G, R = plan.T // _L, plan.R
    n_tiles = sum(seg.n_tiles for seg in plan.segments)
    out = torch.zeros((n_tiles * R, d), dtype=torch.float32, device=x.device)
    max_rows = max(int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS")), 1)
    window = getattr(plan, "window", False)
    tile0 = 0
    for seg in plan.segments:
        ctrl = seg.ctrl[:, 0, :].long()
        steps_per = max(_PLAIN_SLOTS // G, 1)
        for s0 in range(0, seg.n_steps, steps_per):
            slots = torch.arange(s0 * G, min(s0 + steps_per, seg.n_steps) * G, device=x.device)
            _i, lrow, step, src, scale = _selections(plan, seg, slots)
            dst0 = ctrl[step, C_WIN] * _L if window else 0
            orow = (tile0 + ctrl[step, C_TILE]) * R + dst0 + lrow
            for e0 in range(0, src.shape[0], max_rows):
                e1 = e0 + max_rows
                out.index_add_(0, orow[e0:e1], x.index_select(0, src[e0:e1]) * scale[e0:e1, None])
        tile0 += seg.n_tiles
    y = out[:n]
    return y * plan.row_scale[:, None] if plan.row_scale is not None else y


def staged_spmm_units_torch(plan, x: torch.Tensor) -> torch.Tensor:
    """The kernel's work split in plain PyTorch, on the same placed plan:
    each work unit's partial sum over its group slots (StagedWindows.units
    and unit_slots), times row_scale, added into its key's output rows.
    Equal to ``staged_spmm_torch`` up to the order of the sums."""
    n, _m = plan.shape
    d = x.shape[1]
    R = plan.R
    dev = x.device
    nwb, height = unit_geometry(plan)
    n_tiles = sum(seg.n_tiles for seg in plan.segments)
    # one block of slack: a window block's rows past its tile get zeros
    out = torch.zeros((n_tiles * R + _L, d), dtype=torch.float32, device=dev)
    row_scale = torch.zeros(n_tiles * R + _L, dtype=torch.float32, device=dev)
    row_scale[:n] = 1.0 if plan.row_scale is None else plan.row_scale
    tile0 = 0
    for seg in plan.segments:
        units = seg.windows.units.long()
        slots = seg.windows.unit_slots.long()
        # the unit of each listed slot: units by first slot tile the list
        order = torch.argsort(units[:, 1], stable=True)
        unit_of = torch.repeat_interleave(order, (units[:, 2] - units[:, 1])[order])
        partial = torch.zeros((units.shape[0] * height, d), dtype=torch.float32, device=dev)
        for i0 in range(0, slots.shape[0], _PLAIN_SLOTS):
            i, lrow, _step, src, scale = _selections(plan, seg, slots[i0:i0 + _PLAIN_SLOTS])
            partial.index_add_(0, unit_of[i0 + i] * height + lrow,
                               x.index_select(0, src) * scale[:, None])
        key = torch.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
        row0 = (tile0 + key // nwb) * R + (key % nwb) * _L
        rows = (row0[:, None] + torch.arange(height, device=dev)).reshape(-1)
        out.index_add_(0, rows, partial * row_scale[rows, None])
        tile0 += seg.n_tiles
    return out[:n]


def launch_segments(plan, x: torch.Tensor, lib, fn, name: str) -> torch.Tensor:
    """Launch ``fn`` (a bound ofs_*_spmm of ``lib``) once per segment with
    output tiles; each launch writes its segment's rows of Y."""
    n, m = plan.shape
    d = x.shape[1]
    dev = x.device
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    H, RC, RQ, xs_rows, _sent = geometry(plan)

    def ptr(t):
        return None if t is None else t.data_ptr()

    row0 = 0
    for seg in plan.segments:
        if seg.n_tiles:
            win = seg.windows
            rc = fn(ptr(seg.blk), ptr(seg.lidx), ptr(seg.lrow),
                    ptr(seg.val_hi), ptr(seg.val_lo), ptr(win.step_win),
                    ptr(win.range_rows) if RC else None, ptr(win.staged_rows),
                    ptr(plan.hot_ids), ptr(plan.col_scale), ptr(plan.row_scale),
                    ptr(win.unit_slots), ptr(win.units), ptr(win.split_tiles),
                    x.data_ptr(), out.data_ptr(), m, xs_rows, n, d, row0,
                    int(win.units.shape[0]), int(win.split_tiles.shape[0]),
                    plan.T // _L, plan.R, H, RC, RQ, int(plan.multihot),
                    int(getattr(plan, "window", False)), dev.index or 0, stream(dev))
            raise_if(lib, rc, name)
            LAUNCHES[name] += 1
        row0 += seg.n_tiles * plan.R
    return out



def define_op(name: str, int_names: Tuple[str, ...],
              kernel: Callable[[], tuple]) -> Callable:
    """Register ``ofs::<name>`` for one staged engine
    (``library.plan_op``): ``int_names`` are the plan's ints the engine
    reads (ranges: RC, RQ; fused: window), ``kernel()`` gives (library,
    bound launch function). Returns ``run(plan, x)``."""
    def launch(plan, x):
        lib, fn = kernel()
        return launch_segments(plan, x, lib, fn, name)

    return library.plan_op(
        name, arrays=("hot_ids", "col_scale", "row_scale"), ints=int_names, items="segments",
        item_arrays=("ctrl", "blk", "lidx", "lrow", "val_hi", "val_lo", "windows.step_win",
                     "windows.range_rows", "windows.staged_rows", "windows.unit_slots",
                     "windows.units", "windows.split_tiles"),
        item_ints=("n_steps", "n_tiles"),
        derived=lambda plan: {"n_hot": int(plan.hot_ids.shape[0])},
        plain=staged_spmm_torch, launch=launch)
