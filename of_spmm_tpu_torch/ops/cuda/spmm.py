"""The SpMM path's two CUDA kernels, their plain versions and launchers.

- ``bucket_spmm``: one padded-ELL bucket's partial rows,
  ``out[r] = sum_k vals[r, k] * x[row_offset + cols[r, k]]``. Replaces the
  TPU kernel ``of_spmm_tpu/ops/pallas/spmm.py::_bucket_kernel``.
- ``gather_rows``: ``out[i] = table[idx[i]]``, zero rows for indices
  outside the table. Replaces ``::_gather_kernel``.

Both kernels live in ``csrc/spmm.cu`` (design notes there). They are
compiled with ``nvcc -arch=sm_90a`` into a shared library at first use and
bound with ctypes (ops/cuda/build.py); the build goes to ``_build/``
beside the package, keyed by the source hash.

Each wrapper dispatches on the device of the tensors it is given: on the
CPU it runs the plain PyTorch version beside it (what the CPU tests
check against the JAX package); on the card it launches the kernel or
raises. It never falls back. ``LAUNCHES`` (ops/cuda/build.py) counts
kernel launches per wrapper, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from of_spmm_tpu_torch.ops.cuda.build import (  # noqa: F401  (LAUNCHES, reset: re-exported)
    LAUNCHES, raise_if, require, reset_launch_counts, same_device, stream)
from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.utils.config import FLAGS

SOURCE = "spmm.cu"


def build() -> Dict[str, object]:
    """Compile csrc/spmm.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_bucket_spmm.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i32, p]
    lib.ofs_bucket_spmm.restype = i32
    lib.ofs_gather_rows.argtypes = [p, p, p, i64, i64, i64, i32, p]
    lib.ofs_gather_rows.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


# ---------------------------------------------------------------------------
# bucket_spmm
# ---------------------------------------------------------------------------


def bucket_spmm_torch(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                      row_offset: int = 0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the bucket kernel: gather (r, K, d), weight, sum
    over K, in row chunks of at most OFS_SPMM_MAX_GATHER_SLOTS slots."""
    R, K = cols.shape
    if out is None:
        out = torch.empty((R, x.shape[1]), dtype=torch.float32, device=x.device)
    rows_per = max(int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS")) // max(K, 1), 8)
    for r0 in range(0, R, rows_per):
        c = cols[r0:r0 + rows_per]
        g = x.index_select(0, c.reshape(-1).long() + row_offset)
        torch.sum(vals[r0:r0 + rows_per].unsqueeze(-1) * g.reshape(c.shape[0], K, -1),
                  dim=1, out=out[r0:r0 + rows_per])
    return out


def bucket_spmm(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                row_offset: int = 0,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partial rows (R, d) float32 of one ELL bucket against ``x``.

    ``cols`` int32 (R, K) index rows ``row_offset + cols`` of ``x``; ``vals``
    float32 (R, K); ``x`` float32 (n, d). ``out``, if given, is a
    contiguous float32 (R, d) view to write into (a slice of a
    preallocated concatenation buffer). On the card this launches the
    kernel; on the CPU it runs ``bucket_spmm_torch``. A column that points
    outside ``x`` is an error on both: ``index_select`` raises on the CPU,
    and the kernel stops with a device-side assertion that the next
    synchronization raises.
    """
    require(cols, "cols", torch.int32, 2)
    require(vals, "vals", torch.float32, 2)
    require(x, "x", torch.float32, 2)
    if vals.shape != cols.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != cols {tuple(cols.shape)}")
    R, K = cols.shape
    d = x.shape[1]
    dev = same_device(cols, vals, x)
    if out is None:
        out = torch.empty((R, d), dtype=torch.float32, device=dev)
    else:
        require(out, "out", torch.float32, 2)
        same_device(x, out)
        if tuple(out.shape) != (R, d):
            raise ValueError(f"out must be {(R, d)}, got {tuple(out.shape)}")
    if dev.type == "cpu":
        return bucket_spmm_torch(cols, vals, x, row_offset, out)
    if dev.type != "cuda":
        raise ValueError(f"bucket_spmm runs on cuda or cpu tensors, got {dev}")
    if R == 0 or d == 0:
        return out
    lib = _lib()
    rc = lib.ofs_bucket_spmm(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                             out.data_ptr(), R, K, d, int(row_offset),
                             x.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, "bucket_spmm")
    LAUNCHES["bucket_spmm"] += 1
    return out


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------


def gather_rows_torch(table: torch.Tensor, idx: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the gather kernel: rows of ``table``, zero rows for
    out-of-range indices."""
    valid = (idx >= 0) & (idx < table.shape[0])
    rows = table.index_select(0, torch.where(valid, idx, 0).long())
    res = torch.where(valid.unsqueeze(-1), rows, 0.0)
    if out is None:
        return res
    return out.copy_(res)


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` for float32 ``table`` (rows, d) and int32
    ``idx`` (M,); an index outside [0, rows) gives a zero row. On the card
    this launches the kernel; on the CPU it runs ``gather_rows_torch``."""
    require(table, "table", torch.float32, 2)
    require(idx, "idx", torch.int32, 1)
    dev = same_device(table, idx)
    M, d = idx.shape[0], table.shape[1]
    if out is None:
        out = torch.empty((M, d), dtype=torch.float32, device=dev)
    else:
        require(out, "out", torch.float32, 2)
        same_device(table, out)
        if tuple(out.shape) != (M, d):
            raise ValueError(f"out must be {(M, d)}, got {tuple(out.shape)}")
    if dev.type == "cpu":
        return gather_rows_torch(table, idx, out)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu tensors, got {dev}")
    if M == 0 or d == 0:
        return out
    lib = _lib()
    rc = lib.ofs_gather_rows(idx.data_ptr(), table.data_ptr(), out.data_ptr(),
                             M, table.shape[0], d, dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out
