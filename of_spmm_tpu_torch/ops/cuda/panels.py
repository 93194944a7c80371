"""The panel engine's CUDA kernel, its plain version and its launcher.

``panel_spmm(plan, x)`` computes Y = A @ X for a placed PanelPlan
(sparse/panels.py): one launch of the kernel in ``csrc/panels.cu`` per
plan segment, one block per work unit of the segment's work list
(PanelWindows.units). It replaces the TPU kernel
``of_spmm_tpu/ops/pallas/panels.py::_kernel`` together with its host
wrapper's column scaling, take table and row scaling; design notes are in
the CUDA source. ``panel_spmm_units_torch`` repeats the kernel's split
into units (partial sums, row-scaled, added per tile) in plain PyTorch.

The wrapper flattens the plan into ``torch.ops.ofs.panel_spmm``
(ops/cuda/library.py), which dispatches on the device of ``x``: on the
CPU it runs ``panel_spmm_torch`` (what the CPU tests hold against the JAX
package); on the card it launches the kernel or raises, and never falls
back.
Each launch adds one to ``LAUNCHES["panel_spmm"]`` (ops/cuda/build.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda import library
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream
from of_spmm_tpu_torch.sparse.panels import (
    _L, C_GCNT, C_TILE, PanelPlan, resolve_window_rows, xs_rows)
from of_spmm_tpu_torch.utils.config import FLAGS

SOURCE = "panels.cu"
# group slots the plain version decodes at once: slots x 16384 bits
_PLAIN_SLOTS = 1024


def build() -> Dict[str, object]:
    """Compile csrc/panels.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_panel_spmm.argtypes = [p] * 15 + [i64] * 7 + [i32] * 5 + [p]
    lib.ofs_panel_spmm.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_plan(plan: PanelPlan, x: torch.Tensor) -> None:
    require(x, "x", torch.float32, 2)
    if x.shape[0] != plan.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows, the plan {plan.shape[1]} columns")
    for seg in plan.segments:
        if seg.windows is None or seg.masks is None:
            raise ValueError("the plan is not placed: run ops.place_operator (it "
                             "attaches the window provenance and expands the masks)")
        if not isinstance(seg.masks, torch.Tensor):
            raise TypeError("the plan's arrays must be torch tensors (ops.place_operator)")
        same_device(x, seg.masks, seg.ctrl, seg.windows.step_win, seg.windows.units)


def panel_spmm_torch(plan: PanelPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on the same placed plan: decode each
    step's masks into (window row, tile row) pairs, resolve the window rows
    to X rows (resolve_window_rows), and ``index_add_`` the scaled rows
    into the output, in chunks of steps."""
    n, _m = plan.shape
    d = x.shape[1]
    G = plan.T // _L
    n_tiles = sum(seg.n_tiles for seg in plan.segments)
    out = torch.zeros((n_tiles * _L, d), dtype=torch.float32, device=x.device)
    shifts = torch.arange(32, dtype=torch.int32, device=x.device).view(1, 1, 32, 1)
    max_rows = max(int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS")), 1)
    tile0 = 0
    for seg in plan.segments:
        ctrl = seg.ctrl[:, 0, :].long()
        blk = seg.blk[:, 0, :].long()
        steps_per = max(_PLAIN_SLOTS // G, 1)
        for s0 in range(0, seg.n_steps, steps_per):
            s1 = min(s0 + steps_per, seg.n_steps)
            bits = (seg.masks[s0 * G:s1 * G].unsqueeze(2) >> shifts) & 1  # (S, 4, 32, 128)
            slot, k, b, r = bits.nonzero(as_tuple=True)
            step = s0 + slot // G
            g = slot % G
            g1 = ctrl[step, C_GCNT]
            live = (ctrl[step, C_TILE] >= 0) & (g1 != 1) & ((g1 == 0) | (g < g1 - 1))
            step, g, r, w = step[live], g[live], r[live], (k * 32 + b)[live]
            pos = blk[step, g] * _L + w
            src, scale, bad = resolve_window_rows(plan, seg, step, pos)
            if bool(bad.any()):
                raise IndexError("a mask bit names a window row that resolves to no row of x")
            orow = (tile0 + ctrl[step, C_TILE]) * _L + r
            for e0 in range(0, src.shape[0], max_rows):
                e1 = e0 + max_rows
                out.index_add_(0, orow[e0:e1],
                               x.index_select(0, src[e0:e1]) * scale[e0:e1, None])
        tile0 += seg.n_tiles
    return out[:n] * plan.row_scale[:, None]


def panel_spmm_units_torch(plan: PanelPlan, x: torch.Tensor) -> torch.Tensor:
    """The kernel's work split in plain PyTorch, on the same placed plan:
    each work unit's partial sum over its group slots (PanelWindows.units
    and unit_slots), times row_scale, added into its tile's rows. Equal to
    ``panel_spmm_torch`` up to the order of the sums."""
    n, _m = plan.shape
    d = x.shape[1]
    G = plan.T // _L
    dev = x.device
    n_tiles = sum(seg.n_tiles for seg in plan.segments)
    out = torch.zeros((n_tiles * _L, d), dtype=torch.float32, device=dev)
    row_scale = torch.zeros(n_tiles * _L, dtype=torch.float32, device=dev)
    row_scale[:n] = plan.row_scale
    shifts = torch.arange(32, dtype=torch.int32, device=dev).view(1, 1, 32, 1)
    tile0 = 0
    for seg in plan.segments:
        units = seg.windows.units.long()
        slots = seg.windows.unit_slots.long()
        blk = seg.blk[:, 0, :].long()
        n_units = units.shape[0]
        lengths = units[:, 2] - units[:, 1]
        unit_of = torch.empty_like(slots)  # the unit of each listed slot
        at = torch.repeat_interleave(units[:, 1], lengths) + torch.arange(
            int(lengths.sum()), device=dev) - torch.repeat_interleave(
                torch.cumsum(lengths, 0) - lengths, lengths)
        unit_of[at] = torch.repeat_interleave(torch.arange(n_units, device=dev), lengths)
        partial = torch.zeros((n_units * _L, d), dtype=torch.float32, device=dev)
        for i0 in range(0, slots.shape[0], _PLAIN_SLOTS):
            chunk = slots[i0:i0 + _PLAIN_SLOTS]
            bits = (seg.masks[chunk].unsqueeze(2) >> shifts) & 1  # (S, 4, 32, 128)
            si, k, b, r = bits.nonzero(as_tuple=True)
            step, g = chunk[si] // G, chunk[si] % G
            src, scale, bad = resolve_window_rows(plan, seg, step, blk[step, g] * _L + k * 32 + b)
            if bool(bad.any()):
                raise IndexError("a mask bit names a window row that resolves to no row of x")
            partial.index_add_(0, unit_of[i0 + si] * _L + r,
                               x.index_select(0, src) * scale[:, None])
        tile = torch.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
        rows = ((tile0 + tile) * _L)[:, None] + torch.arange(_L, device=dev)
        out.index_add_(0, rows.reshape(-1), partial * row_scale[rows.reshape(-1), None])
        tile0 += seg.n_tiles
    return out[:n]


def _panel_launch(plan, x: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel per segment with tiles (the op's CUDA
    implementation, on the plan ``library.plan_op`` rebuilt)."""
    n, m = plan.shape
    d = x.shape[1]
    dev = x.device
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    lib = _lib()
    tile0 = 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    for seg in plan.segments:
        if seg.n_tiles == 0:  # nothing to launch
            continue
        win = seg.windows
        rc = lib.ofs_panel_spmm(
            ptr(seg.blk), ptr(seg.masks), ptr(win.step_win), ptr(win.range_rows),
            ptr(win.direct_rows), ptr(seg.stage_take), ptr(seg.stage_scale),
            ptr(plan.hot_ids), ptr(plan.col_scale), ptr(plan.row_scale),
            ptr(win.unit_slots), ptr(win.units), ptr(win.split_tiles), x.data_ptr(),
            out.data_ptr(), m, xs_rows(plan), n, d, tile0, int(win.units.shape[0]),
            int(win.split_tiles.shape[0]), plan.T // _L, plan.n_hot, plan.RC, plan.RQ,
            dev.index or 0, stream(dev))
        raise_if(lib, rc, "panel_spmm")
        LAUNCHES["panel_spmm"] += 1
        tile0 += seg.n_tiles
    return out


# ofs::panel_spmm: what the launcher and the plain version read of a placed
# PanelPlan and of each of its segments
_run = library.plan_op(
    "panel_spmm", arrays=("hot_ids", "col_scale", "row_scale"), ints=("T", "RC", "RQ"),
    items="segments",
    item_arrays=("ctrl", "blk", "masks", "stage_take", "stage_scale", "windows.step_win",
                 "windows.range_rows", "windows.direct_rows", "windows.unit_slots",
                 "windows.units", "windows.split_tiles"),
    item_ints=("n_steps", "n_tiles"),
    derived=lambda plan: {"n_hot": int(plan.hot_ids.shape[0])},
    plain=panel_spmm_torch, launch=_panel_launch)


def panel_spmm(plan: PanelPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (float32, (n, d)) for a placed PanelPlan of A and float32
    ``x`` (m, d), through ``torch.ops.ofs.panel_spmm``. On the card this
    launches the kernel once per segment; on the CPU it runs
    ``panel_spmm_torch``. A window row that resolves outside x is an error
    on both: the plain version raises, and the kernel stops with a
    device-side assertion that the next synchronization raises."""
    _check_plan(plan, x)
    return _run(plan, x)
