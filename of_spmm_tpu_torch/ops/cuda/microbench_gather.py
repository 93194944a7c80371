"""The gather microbenchmark's CUDA kernels, their plain versions and their
launchers (tools/microbench_gather.py).

One wrapper per TPU kernel of tools/microbench_gather.py, each computing
its function with the kernels in ``csrc/microbench_gather.cu`` (device
templates in ``csrc/gather.cuh``; design notes there):

- ``vmem_loop(cols, vals, tier)``: out[o] = sum_k vals[o, k] tier[cols[o, k]];
- ``vmem_take(cols, tier)``: out[t] = tier[cols.flat[t]];
- ``onehot(cols, tier)``: out[t] = float32(tier[cols.flat[t]]) by a one-hot
  product over the tier's C rows (float32 or bfloat16), an index outside
  [0, C) giving a zero row;
- ``block_slice(starts, tier)``: out[8i + j] = sum over the 8 K starts s of
  step i of tier[s + j];
- ``row_dma(cols, table, W)``: out[o] = sum_{m < 16} table[cols.flat[16 o + m]],
  W rows in flight per warp.

On the CPU they run the plain versions; on the card they launch the kernel
or raise, and never fall back. Each launch adds one to its
``LAUNCHES["gather_<name>"]`` (ops/cuda/build.py). An index outside the
table stops every kernel but the one-hot product with a device-side
assertion; the plain versions raise IndexError.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_gather.cu"
D = 128           # row width
GROUP = 16        # rows summed per output row of row_dma
ROW_BLOCK = 128   # the one-hot kernels take whole blocks of 128 indices
CHUNK_ROWS = 2048  # output rows per chunk of the plain ELL version (134 MB at K = 128)
CHUNK_STEPS = 16   # steps per chunk of the plain block_slice (67 MB at K = 128)


def build() -> Dict[str, object]:
    """Compile csrc/microbench_gather.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_gather_ell_reduce.argtypes = [p, p, p, p, i64, i32, i64, i32, p]
    lib.ofs_gather_vmem_take.argtypes = [p, p, p, i64, i64, i32, p]
    lib.ofs_gather_onehot.argtypes = [i32, p, p, p, i64, i64, i32, p]
    lib.ofs_gather_block_slice.argtypes = [p, p, p, i64, i32, i64, i32, p]
    lib.ofs_gather_row_sum.argtypes = [p, p, p, i64, i32, i32, i64, i32, p]
    for fn in (lib.ofs_gather_ell_reduce, lib.ofs_gather_vmem_take, lib.ofs_gather_onehot,
               lib.ofs_gather_block_slice, lib.ofs_gather_row_sum):
        fn.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def check_table(t: torch.Tensor, name: str, *dtypes: torch.dtype) -> None:
    """A contiguous (rows, 128) table of one of ``dtypes``, 16-byte aligned."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    require(t, name, t.dtype, 2)
    if t.shape[1] != D or t.shape[0] == 0:
        raise ValueError(f"{name} must be (rows > 0, {D}), got {tuple(t.shape)}")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_lanes(t: torch.Tensor, name: str, dtype: torch.dtype = torch.int32) -> int:
    """A contiguous (T / 128, 128) array of lanes; returns T."""
    require(t, name, dtype, 2)
    if t.shape[1] != ROW_BLOCK:
        raise ValueError(f"{name} must be (T / {ROW_BLOCK}, {ROW_BLOCK}), got {tuple(t.shape)}")
    return t.numel()


def check_ell(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> None:
    require(cols, "cols", torch.int32, 2)
    require(vals, "vals", torch.float32, 2)
    check_table(tier, "tier", torch.float32)
    same_device(cols, vals, tier)
    if vals.shape != cols.shape:
        raise ValueError(f"vals must be shaped like cols {tuple(cols.shape)}, got "
                         f"{tuple(vals.shape)}")


def card(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")


def ell_torch(cols: torch.Tensor, K: int, table: torch.Tensor,
              vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain ELL gather-reduce: out[o] = sum_k (vals[o, k] *) table[c], c
    the flat cols[K o + k] (float32 (cols.numel() / K, 128))."""
    idx = cols.reshape(-1, K).long()
    w = None if vals is None else vals.reshape(-1, K)
    out = torch.empty((idx.shape[0], D), dtype=torch.float32, device=table.device)
    for a in range(0, idx.shape[0], CHUNK_ROWS):
        rows = table[idx[a:a + CHUNK_ROWS]]
        if w is not None:
            rows = rows * w[a:a + CHUNK_ROWS, :, None]
        out[a:a + CHUNK_ROWS] = rows.sum(1)
    return out


def onehot_rows_torch(idx: torch.Tensor, table: torch.Tensor, window: int,
                      base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32(table[base + idx]) where 0 <= idx < window, else a zero row:
    a one-hot product's result (idx and base flat, one base per index)."""
    idx = idx.reshape(-1).long()
    inside = (idx >= 0) & (idx < window)
    src = idx.clamp(0, window - 1) + (0 if base is None else base)
    rows = table[src].float()
    rows[~inside] = 0.0
    return rows


def vmem_loop_torch(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of vmem_loop (float32 (cols.shape[0], 128))."""
    check_ell(cols, vals, tier)
    return ell_torch(cols, cols.shape[1], tier, vals)


def vmem_take_torch(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of vmem_take (float32 (T, 128))."""
    check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32)
    return tier[cols.reshape(-1).long()]


def onehot_torch(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of onehot (float32 (T, 128))."""
    check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32, torch.bfloat16)
    return onehot_rows_torch(cols, tier, tier.shape[0])


def _check_starts(starts: torch.Tensor, tier: torch.Tensor) -> int:
    """The steps R after checking types and shapes."""
    require(starts, "starts", torch.int32, 2)
    check_table(tier, "tier", torch.float32)
    same_device(starts, tier)
    if starts.shape[0] % 8 != 0 or tier.shape[0] < 8:
        raise ValueError(f"starts must have 8R rows and tier 8 rows or more, got "
                         f"{tuple(starts.shape)} and {tuple(tier.shape)}")
    return starts.shape[0] // 8


def block_slice_torch(starts: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of block_slice (float32 (8R, 128))."""
    R = _check_starts(starts, tier)
    s = starts.view(R, 8 * starts.shape[1]).long()
    j = torch.arange(8, device=tier.device)
    out = torch.empty((R * 8, D), dtype=torch.float32, device=tier.device)
    for a in range(0, R, CHUNK_STEPS):
        blocks = tier[s[a:a + CHUNK_STEPS, :, None] + j]  # (r, 8K, 8, D)
        out[a * 8:(a + CHUNK_STEPS) * 8] = blocks.sum(1).reshape(-1, D)
    return out


def check_row_sum(cols: torch.Tensor, table: torch.Tensor, W: int, group: int) -> None:
    """Lanes of ``group`` indices per output row into a float32 table, W
    rows in flight (row_dma, dma_deep)."""
    T = check_lanes(cols, "cols")
    check_table(table, "table", torch.float32)
    same_device(cols, table)
    if T % group != 0 or not 1 <= W <= 256:
        raise ValueError(f"need T a multiple of {group} and 1 <= W <= 256, got T={T} W={W}")


def row_dma_torch(cols: torch.Tensor, table: torch.Tensor, W: int = 16) -> torch.Tensor:
    """Plain version of row_dma (float32 (T / 16, 128)); W changes nothing."""
    check_row_sum(cols, table, W, GROUP)
    return ell_torch(cols, GROUP, table)


def ell_launch(name: str, cols: torch.Tensor, vals: torch.Tensor,
               tier: torch.Tensor) -> torch.Tensor:
    """Launch the weighted ELL gather-reduce (vmem_loop, take_fused),
    counted as ``name``."""
    check_ell(cols, vals, tier)
    card(cols.device, name)
    lib, dev = _lib(), cols.device
    out = torch.empty((cols.shape[0], D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_ell_reduce(cols.data_ptr(), vals.data_ptr(), tier.data_ptr(),
                                   out.data_ptr(), cols.shape[0], cols.shape[1], tier.shape[0],
                                   dev.index or 0, stream(dev))
    raise_if(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def vmem_loop(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_vmem_loop's function: the kernel on the card, the plain version
    on the CPU."""
    if cols.device.type == "cpu":
        return vmem_loop_torch(cols, vals, tier)
    return ell_launch("gather_vmem_loop", cols, vals, tier)


def vmem_take(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_vmem_take's function: the kernel on the card, the plain version
    on the CPU."""
    if cols.device.type == "cpu":
        return vmem_take_torch(cols, tier)
    T = check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32)
    same_device(cols, tier)
    card(cols.device, "vmem_take")
    lib, dev = _lib(), cols.device
    out = torch.empty((T, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_vmem_take(cols.data_ptr(), tier.data_ptr(), out.data_ptr(), T,
                                  tier.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_vmem_take")
    LAUNCHES["gather_vmem_take"] += 1
    return out


def onehot(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_onehot_mxu's function (float32 (T, 128)): the kernel on the
    card (tensor cores for a bfloat16 tier, CUDA cores for float32), the
    plain version on the CPU."""
    if cols.device.type == "cpu":
        return onehot_torch(cols, tier)
    T = check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32, torch.bfloat16)
    same_device(cols, tier)
    card(cols.device, "onehot")
    lib, dev = _lib(), cols.device
    out = torch.empty((T, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_onehot(int(tier.dtype == torch.bfloat16), cols.data_ptr(),
                               tier.data_ptr(), out.data_ptr(), T, tier.shape[0],
                               dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_onehot")
    LAUNCHES["gather_onehot"] += 1
    return out


def block_slice(starts: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_block_slice's function (float32 (8R, 128)): the kernel on the
    card, the plain version on the CPU. A start with s + 8 > C stops the
    kernel with a device-side assertion."""
    if starts.device.type == "cpu":
        return block_slice_torch(starts, tier)
    R = _check_starts(starts, tier)
    card(starts.device, "block_slice")
    lib, dev = _lib(), starts.device
    out = torch.empty((R * 8, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_block_slice(starts.data_ptr(), tier.data_ptr(), out.data_ptr(), R,
                                    starts.shape[1], tier.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_block_slice")
    LAUNCHES["gather_block_slice"] += 1
    return out


def row_sum_launch(name: str, cols: torch.Tensor, table: torch.Tensor, W: int,
                   group: int) -> torch.Tensor:
    """Launch the ELL row sum of ``group`` rows per output row with W rows
    in flight per warp (row_dma, dma_deep), counted as ``name``."""
    check_row_sum(cols, table, W, group)
    card(cols.device, name)
    lib, dev = _lib(), cols.device
    n_out = cols.numel() // group
    out = torch.empty((n_out, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_row_sum(cols.data_ptr(), table.data_ptr(), out.data_ptr(), n_out, group,
                                W, table.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def row_dma(cols: torch.Tensor, table: torch.Tensor, W: int = 16) -> torch.Tensor:
    """bench_row_dma's function (float32 (T / 16, 128)): the kernel on the
    card with W rows in flight per warp, the plain version on the CPU."""
    if cols.device.type == "cpu":
        return row_dma_torch(cols, table, W)
    return row_sum_launch("gather_row_dma", cols, table, W, GROUP)
