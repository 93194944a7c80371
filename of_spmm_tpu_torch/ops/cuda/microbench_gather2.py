"""The second-round gather microbenchmark's CUDA kernels, their plain
versions and their launchers (tools/microbench_gather2.py).

One wrapper per TPU kernel of tools/microbench_gather2.py, each computing
its function with the kernels in ``csrc/microbench_gather2.cu`` (the
one-hot product in ``csrc/gather.cuh``; design notes there), except
take_fused and dma_deep, which launch microbench_gather's ELL kernels
(``csrc/microbench_gather.cu``) under their own counters:

- ``onehot_pair(cols, hi, lo)``: out[t] = f32(hi[c]) + f32(lo[c]), c =
  cols.flat[t], by one-hot products over the C rows (c outside [0, C): a
  zero row);
- ``take_fused(cols, vals, tier)``: out[n] = sum_k vals[n, k] tier[cols[n, k]];
- ``dma_deep(cols, table, W)``: out[o] = sum_{m < 128} table[cols.flat[128 o + m]],
  W rows in flight per warp;
- ``window_pair(bases, lidx, hi, lo, CW)``: out[t] = f32(hi[b + l]) + f32(lo[b + l]),
  l = lidx.flat[t], b the base of step t // TILE (TILE = T / len(bases)), by
  one-hot products over the CW-row window at b (l outside [0, CW): zero);
- ``twosided(bases, lidx, rows, vals, hi, lo, CW, R)``: out (R, 128) = the
  sum over every lane t of f32(c_hi) + f32(c_lo) into row rows.flat[t], c =
  window_pair's row t times vals.flat[t], c_hi = bf16(c), c_lo =
  bf16(c - f32(c_hi)), each rounded to nearest even.

On the CPU they run the plain versions; on the card they launch the kernel
or raise, and never fall back. Each launch adds one to its
``LAUNCHES["gather2_<name>"]`` (ops/cuda/build.py). An index outside its
table (or a row outside [0, R), or a window past the table's end) stops
the kernel with a device-side assertion; the plain versions raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream
from of_spmm_tpu_torch.ops.cuda.microbench_gather import (
    D, ROW_BLOCK, card, check_lanes, check_row_sum, check_table, ell_launch, ell_torch,
    onehot_rows_torch, row_sum_launch, vmem_loop_torch)

SOURCE = "microbench_gather2.cu"
DEEP_GROUP = 128  # rows summed per output row of dma_deep


def build() -> Dict[str, object]:
    """Compile csrc/microbench_gather2.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_gather2_onehot_pair.argtypes = [p, p, p, p, i64, i32, i32, p]
    lib.ofs_gather2_window_pair.argtypes = [p, p, p, p, p, i64, i64, i32, i64, i32, p]
    lib.ofs_gather2_twosided.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i64, i32, i32, p]
    for fn in (lib.ofs_gather2_onehot_pair, lib.ofs_gather2_window_pair,
               lib.ofs_gather2_twosided):
        fn.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_pair(hi: torch.Tensor, lo: torch.Tensor) -> None:
    check_table(hi, "hi", torch.bfloat16)
    check_table(lo, "lo", torch.bfloat16)
    if hi.shape != lo.shape:
        raise ValueError(f"hi and lo must have one shape, got {tuple(hi.shape)} and "
                         f"{tuple(lo.shape)}")


def _check_window(bases: torch.Tensor, lidx: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                  CW: int) -> int:
    """TILE after checking types and shapes."""
    T = check_lanes(lidx, "lidx")
    require(bases, "bases", torch.int32, 2)
    _check_pair(hi, lo)
    same_device(bases, lidx, hi, lo)
    steps = bases.numel()
    if bases.shape[1] != 1 or steps == 0 or T % steps != 0 or (T // steps) % ROW_BLOCK != 0:
        raise ValueError(f"bases must be (steps, 1) with T / steps a multiple of {ROW_BLOCK}; "
                         f"got {tuple(bases.shape)} for T={T}")
    if not 0 < CW <= hi.shape[0]:
        raise ValueError(f"need 0 < CW <= {hi.shape[0]} table rows, got CW={CW}")
    return T // steps


def onehot_pair_torch(cols: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Plain version of onehot_pair (float32 (T, 128))."""
    check_lanes(cols, "cols")
    _check_pair(hi, lo)
    C = hi.shape[0]
    return onehot_rows_torch(cols, hi, C) + onehot_rows_torch(cols, lo, C)


def take_fused_torch(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of take_fused (float32 (cols.shape[0], 128))."""
    return vmem_loop_torch(cols, vals, tier)


def dma_deep_torch(cols: torch.Tensor, table: torch.Tensor, W: int = 32) -> torch.Tensor:
    """Plain version of dma_deep (float32 (T / 128, 128)); W changes nothing."""
    check_row_sum(cols, table, W, DEEP_GROUP)
    return ell_torch(cols, DEEP_GROUP, table)


def _window_base(bases: torch.Tensor, tile: int, CW: int, n_rows: int) -> torch.Tensor:
    """Each lane's window base (int64, flat), after checking every window
    lies inside the table."""
    b = bases.reshape(-1).long()
    if bool(((b < 0) | (b + CW > n_rows)).any()):
        raise IndexError(f"a window base puts its {CW} rows outside the {n_rows}-row table")
    return b.repeat_interleave(tile)


def window_pair_torch(bases: torch.Tensor, lidx: torch.Tensor, hi: torch.Tensor,
                      lo: torch.Tensor, CW: int) -> torch.Tensor:
    """Plain version of window_pair (float32 (T, 128))."""
    tile = _check_window(bases, lidx, hi, lo, CW)
    base = _window_base(bases, tile, CW, hi.shape[0])
    return onehot_rows_torch(lidx, hi, CW, base) + onehot_rows_torch(lidx, lo, CW, base)


def twosided_torch(bases: torch.Tensor, lidx: torch.Tensor, rows: torch.Tensor,
                   vals: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, CW: int,
                   R: int) -> torch.Tensor:
    """Plain version of twosided (float32 (R, 128))."""
    _check_twosided(rows, vals, lidx, R)
    c = window_pair_torch(bases, lidx, hi, lo, CW) * vals.reshape(-1, 1)
    c_hi = c.to(torch.bfloat16).float()
    c_lo = (c - c_hi).to(torch.bfloat16).float()
    out = torch.zeros((R, D), dtype=torch.float32, device=c.device)
    return out.index_add_(0, rows.reshape(-1).long(), c_hi + c_lo)


def _check_twosided(rows: torch.Tensor, vals: torch.Tensor, lidx: torch.Tensor, R: int) -> None:
    check_lanes(rows, "rows")
    check_lanes(vals, "vals", torch.float32)
    same_device(rows, vals, lidx)
    if rows.shape != lidx.shape or vals.shape != lidx.shape or R <= 0:
        raise ValueError(f"rows and vals must be shaped like lidx {tuple(lidx.shape)} and R > 0; "
                         f"got {tuple(rows.shape)}, {tuple(vals.shape)}, R={R}")


def onehot_pair(cols: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """bench_onehot_pair's function: the kernel on the card, the plain
    version on the CPU."""
    if cols.device.type == "cpu":
        return onehot_pair_torch(cols, hi, lo)
    T = check_lanes(cols, "cols")
    _check_pair(hi, lo)
    same_device(cols, hi, lo)
    card(cols.device, "onehot_pair")
    lib, dev = _lib(), cols.device
    out = torch.empty((T, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather2_onehot_pair(cols.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                     out.data_ptr(), T, hi.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather2_onehot_pair")
    LAUNCHES["gather2_onehot_pair"] += 1
    return out


def take_fused(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_take_fused's function: the kernel on the card, the plain
    version on the CPU."""
    if cols.device.type == "cpu":
        return take_fused_torch(cols, vals, tier)
    return ell_launch("gather2_take_fused", cols, vals, tier)


def dma_deep(cols: torch.Tensor, table: torch.Tensor, W: int = 32) -> torch.Tensor:
    """bench_dma_deep's function (float32 (T / 128, 128)): the kernel on the
    card with W rows in flight per warp, the plain version on the CPU."""
    if cols.device.type == "cpu":
        return dma_deep_torch(cols, table, W)
    return row_sum_launch("gather2_dma_deep", cols, table, W, DEEP_GROUP)


def window_pair(bases: torch.Tensor, lidx: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                CW: int) -> torch.Tensor:
    """bench_window_pair's function: the kernel on the card, the plain
    version on the CPU."""
    if lidx.device.type == "cpu":
        return window_pair_torch(bases, lidx, hi, lo, CW)
    tile = _check_window(bases, lidx, hi, lo, CW)
    card(lidx.device, "window_pair")
    lib, dev = _lib(), lidx.device
    out = torch.empty((lidx.numel(), D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather2_window_pair(bases.data_ptr(), lidx.data_ptr(), hi.data_ptr(),
                                     lo.data_ptr(), out.data_ptr(), lidx.numel(), tile, CW,
                                     hi.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather2_window_pair")
    LAUNCHES["gather2_window_pair"] += 1
    return out


def twosided(bases: torch.Tensor, lidx: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
             hi: torch.Tensor, lo: torch.Tensor, CW: int, R: int) -> torch.Tensor:
    """bench_twosided's function (float32 (R, 128)): the kernel on the card
    (lanes added with atomics, in no fixed order), the plain version on the
    CPU."""
    if lidx.device.type == "cpu":
        return twosided_torch(bases, lidx, rows, vals, hi, lo, CW, R)
    tile = _check_window(bases, lidx, hi, lo, CW)
    _check_twosided(rows, vals, lidx, R)
    card(lidx.device, "twosided")
    lib, dev = _lib(), lidx.device
    out = torch.zeros((R, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather2_twosided(bases.data_ptr(), lidx.data_ptr(), rows.data_ptr(),
                                  vals.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(),
                                  lidx.numel(), tile, CW, hi.shape[0], R, dev.index or 0,
                                  stream(dev))
    raise_if(lib, rc, "gather2_twosided")
    LAUNCHES["gather2_twosided"] += 1
    return out
