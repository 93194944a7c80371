"""The dynamic-gather probe's CUDA kernels, their plain versions and their
launchers (tools/microbench_dyngather.py).

- ``take_along(idx, table, steps)``: out[t, l] = table[idx[t, l], l] for
  every lane l (take_along_axis on axis 0), computed ``steps`` times in one
  launch as the TPU grid computes it: the passes are the work (the TPU
  tool's rate counts each pass's gather out of VMEM). On the card each
  block stages a slice of ``slice_lanes(C, optin)`` lanes of the table in
  shared memory and runs the passes out of it; a table too tall for one
  lane a slice takes the direct kernel, whose passes read L2;
- ``smem_cap(x, nbytes)``: x (8, 128) float32 copied through a dynamic
  shared-memory buffer of ``nbytes`` and back; on the card a buffer above
  the opt-in limit (``smem_optin()``) raises, as cudaFuncSetAttribute
  refuses it.

The kernels are in ``csrc/microbench_dyngather.cu`` (design notes there).
On the CPU the wrappers run the plain versions; on the card they launch the
kernel or raise, and never fall back. Each launch adds one to
``LAUNCHES["dyngather_take_along"]`` or ``["dyngather_smem_cap"]``
(ops/cuda/build.py). An index outside the table stops take_along's kernel
with a device-side assertion; the plain version raises IndexError.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream
from of_spmm_tpu_torch.ops.cuda.microbench_gather import D, card, check_lanes, check_table

SOURCE = "microbench_dyngather.cu"
TILE_BYTES = 8 * D * 4  # x: one (8, 128) float32 tile
MAX_SLICE_LANES = 16  # a warp's 32 threads on 2 rows of 16 lanes: at most 2-way bank conflicts
_OPTIN: Dict[int, int] = {}  # the cards' opt-in shared memory per block, by device index


def slice_lanes(C: int, optin: int) -> int:
    """Lanes of the table a take_along block stages in shared memory: as
    many as fit ``optin`` bytes (C x lanes x 4), at most 16, a multiple of
    4 from 4 on (a row's lanes then stage as whole 16-byte copies); 0 where
    not one lane fits (the direct kernel, whose passes read L2)."""
    lanes = min(MAX_SLICE_LANES, optin // (4 * C))
    return lanes - lanes % 4 if lanes >= 4 else lanes


def build() -> Dict[str, object]:
    """Compile csrc/microbench_dyngather.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_take_along.argtypes = [p, p, p, i64, i64, i32, i32, i32, p]
    lib.ofs_take_along.restype = i32
    lib.ofs_smem_cap.argtypes = [p, p, i32, i32, p]
    lib.ofs_smem_cap.restype = i32
    lib.ofs_empty_launch.argtypes = [i32, p]
    lib.ofs_empty_launch.restype = i32
    lib.ofs_smem_optin.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.ofs_smem_optin.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_take(idx: torch.Tensor, table: torch.Tensor, steps: int) -> None:
    check_lanes(idx, "idx")
    check_table(table, "table", torch.float32)
    same_device(idx, table)
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")


def _check_cap(x: torch.Tensor, nbytes: int) -> None:
    require(x, "x", torch.float32, 2)
    if tuple(x.shape) != (8, D):
        raise ValueError(f"x must be (8, {D}), got {tuple(x.shape)}")
    if nbytes < TILE_BYTES or nbytes % 16 != 0:
        raise ValueError(f"nbytes must be a multiple of 16 and at least {TILE_BYTES}, "
                         f"got {nbytes}")


def take_along_torch(idx: torch.Tensor, table: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Plain version of take_along (float32, idx's shape): the pass
    repeated ``steps`` times, as the kernel runs it."""
    _check_take(idx, table, steps)
    rows, lanes = idx.long(), torch.arange(D, device=idx.device)
    for _ in range(steps):
        out = table[rows, lanes]
    return out


def smem_cap_torch(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain version of smem_cap: x itself (a copy); the host has no limit
    to probe."""
    _check_cap(x, nbytes)
    return x.clone()


def smem_optin(device: torch.device) -> Optional[int]:
    """The card's opt-in shared memory per block in bytes
    (cudaDevAttrMaxSharedMemoryPerBlockOptin); None on the CPU."""
    if device.type == "cpu":
        return None
    card(device, "smem_optin")
    lib, value = _lib(), ctypes.c_int(0)
    raise_if(lib, lib.ofs_smem_optin(device.index or 0, ctypes.byref(value)), "smem_optin")
    return value.value


def take_along(idx: torch.Tensor, table: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """_run's function (float32, idx's shape), ``steps`` passes in one
    launch: the kernel on the card (out of shared memory, or out of L2
    where ``slice_lanes`` gives 0), the plain version on the CPU."""
    if idx.device.type == "cpu":
        return take_along_torch(idx, table, steps)
    _check_take(idx, table, steps)
    card(idx.device, "take_along")
    lib, dev = _lib(), idx.device
    index = dev.index or 0
    if index not in _OPTIN:
        _OPTIN[index] = smem_optin(dev)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    rc = lib.ofs_take_along(idx.data_ptr(), table.data_ptr(), out.data_ptr(), idx.numel(),
                            table.shape[0], steps, slice_lanes(table.shape[0], _OPTIN[index]),
                            index, stream(dev))
    raise_if(lib, rc, "dyngather_take_along")
    LAUNCHES["dyngather_take_along"] += 1
    return out


def smem_cap(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """vmem_cap's probe: x through ``nbytes`` of dynamic shared memory. On
    the card a size the card refuses raises RuntimeError (and launches
    nothing); on the CPU the plain version."""
    if x.device.type == "cpu":
        return smem_cap_torch(x, nbytes)
    _check_cap(x, nbytes)
    card(x.device, "smem_cap")
    lib, dev = _lib(), x.device
    out = torch.empty_like(x)
    raise_if(lib, lib.ofs_smem_cap(x.data_ptr(), out.data_ptr(), nbytes, dev.index or 0,
                                   stream(dev)), "dyngather_smem_cap")
    LAUNCHES["dyngather_smem_cap"] += 1
    return out


def empty_launch(dev: torch.device) -> None:
    """Launch one warp that does nothing on ``dev``'s current stream: the
    launch floor under smem_cap, timed beside it. It replaces no TPU kernel
    and counts in no LAUNCHES entry."""
    card(dev, "empty_launch")
    lib = _lib()
    raise_if(lib, lib.ofs_empty_launch(dev.index or 0, stream(dev)), "empty_launch")
