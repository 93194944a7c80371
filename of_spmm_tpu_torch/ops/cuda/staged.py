"""What the fused and the ranges kernels share: the plain version, the
plan checks and the per-segment launcher.

Both kernels (csrc/fused.cu, csrc/ranges.cu, built on
csrc/staged_spmm.cuh) take a placed FusedPlan or RangesPlan: its arrays
as tensors on the card and, per segment, the window provenance
(sparse/staged_windows.py StagedWindows) that placement derives.
"""

from __future__ import annotations

import ctypes

import torch

from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream
from of_spmm_tpu_torch.sparse.staged_windows import _L, geometry, resolve_window_rows
from of_spmm_tpu_torch.utils.config import FLAGS

# group slots the plain version decodes at once: slots x 16384 bits
_PLAIN_SLOTS = 1024
C_TILE, C_WIN = 0, 10


def bind(fn) -> None:
    """argtypes of ofs_fused_spmm / ofs_ranges_spmm (same signature)."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p] * 14 + [i64] * 6 + [i32] * 8 + [p]
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
        same_device(x, seg.lidx, seg.ctrl, seg.windows.step_win)


def staged_spmm_torch(plan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of both kernels on the same placed plan: decode each
    chunk of steps' lanes into (window row, output row, value)
    selections, resolve the window rows to X rows (resolve_window_rows),
    and ``index_add_`` the scaled rows into the output."""
    n, _m = plan.shape
    d = x.shape[1]
    G, R = plan.T // _L, plan.R
    _H, _RC, _RQ, _xs, sent = geometry(plan)
    n_tiles = sum(seg.n_tiles for seg in plan.segments)
    out = torch.zeros((n_tiles * R, d), dtype=torch.float32, device=x.device)
    shifts = torch.arange(32, dtype=torch.int32, device=x.device).view(1, 1, 32, 1)
    max_rows = max(int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS")), 1)
    tile0 = 0
    for seg in plan.segments:
        ctrl = seg.ctrl[:, 0, :].long()
        blk = seg.blk[:, 0, :].long()
        steps_per = max(_PLAIN_SLOTS // G, 1)
        for s0 in range(0, seg.n_steps, steps_per):
            s1 = min(s0 + steps_per, seg.n_steps)
            lrow = seg.lrow[s0 * G:s1 * G].long()
            real = lrow < sent
            val = None
            if plan.multihot:
                bits = (seg.lidx[s0 * G:s1 * G].unsqueeze(2) >> shifts) & 1  # (S, 4, 32, 128)
                slot, k, b, lane = (bits.bool() & real[:, None, None, :]).nonzero(as_tuple=True)
                w = k * 32 + b
            else:
                slot, lane = real.nonzero(as_tuple=True)
                w = seg.lidx[s0 * G:s1 * G][slot, lane].long()
                if seg.val_hi is not None:
                    val = (seg.val_hi[s0 * G:s1 * G][slot, lane]
                           + seg.val_lo[s0 * G:s1 * G][slot, lane])
            step = s0 + slot // G
            pos = blk[step, slot % G] * _L + w
            src, scale, bad = resolve_window_rows(plan, seg, step, pos)
            if bool(bad.any()):
                raise IndexError("a lane reads a window row that resolves to no row of x")
            if val is not None:
                scale = scale * val
            dst0 = ctrl[step, C_WIN] * _L if getattr(plan, "window", False) else 0
            orow = (tile0 + ctrl[step, C_TILE]) * R + dst0 + lrow[slot, lane]
            for e0 in range(0, src.shape[0], max_rows):
                e1 = e0 + max_rows
                out.index_add_(0, orow[e0:e1], x.index_select(0, src[e0:e1]) * scale[e0:e1, None])
        tile0 += seg.n_tiles
    y = out[:n]
    return y * plan.row_scale[:, None] if plan.row_scale is not None else y


def launch_segments(plan, x: torch.Tensor, lib, fn, name: str) -> torch.Tensor:
    """Zero Y and launch ``fn`` (a bound ofs_*_spmm of ``lib``) once per
    segment."""
    n, m = plan.shape
    d = x.shape[1]
    dev = x.device
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    H, RC, RQ, xs_rows, _sent = geometry(plan)

    def ptr(t):
        return None if t is None else t.data_ptr()

    row0 = 0
    for seg in plan.segments:
        if seg.n_steps:
            win = seg.windows
            rc = fn(ptr(seg.ctrl), ptr(seg.blk), ptr(seg.lidx), ptr(seg.lrow),
                    ptr(seg.val_hi), ptr(seg.val_lo), ptr(win.step_win),
                    ptr(win.range_rows) if RC else None, ptr(win.staged_rows),
                    ptr(plan.hot_ids), ptr(plan.col_scale), ptr(plan.row_scale),
                    x.data_ptr(), out.data_ptr(), m, xs_rows, n, d, row0, seg.n_steps,
                    plan.T // _L, plan.R, H, RC, RQ, int(plan.multihot),
                    int(getattr(plan, "window", False)), dev.index or 0, stream(dev))
            raise_if(lib, rc, name)
            LAUNCHES[name] += 1
        row0 += seg.n_tiles * plan.R
    return out
