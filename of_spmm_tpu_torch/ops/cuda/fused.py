"""The fused engine's CUDA kernel, its plain version and its launcher.

``fused_spmm(plan, x)`` computes Y = A @ X for a placed FusedPlan
(sparse/fused.py): one launch of the kernel in ``csrc/fused.cu`` per plan
segment. It replaces the TPU kernel
``of_spmm_tpu/ops/pallas/fused.py::_kernel`` together with its host
wrapper's column scaling, staging tables and row scaling; design notes are
in csrc/staged_spmm.cuh, which the fused and the ranges kernels share.

The wrapper flattens the plan into ``torch.ops.ofs.fused_spmm``
(ops/cuda/staged.py define_op), which dispatches on the device of
``x``: on the CPU it runs
``fused_spmm_torch`` (what the CPU tests hold against the JAX package);
on the card it launches the kernel or raises, and never falls back.
Each launch adds one to ``LAUNCHES["fused_spmm"]`` (ops/cuda/build.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.staged import bind, check_plan, define_op, staged_spmm_torch
from of_spmm_tpu_torch.sparse.fused import FusedPlan

SOURCE = "fused.cu"


def build() -> Dict[str, object]:
    """Compile csrc/fused.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    bind(lib.ofs_fused_spmm)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def fused_spmm_torch(plan: FusedPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on the same placed plan
    (ops/cuda/staged.py staged_spmm_torch)."""
    check_plan(plan, x, FusedPlan, "fused_spmm_torch")
    return staged_spmm_torch(plan, x)


# ofs::fused_spmm: one launch per segment with output tiles
_run = define_op("fused_spmm", ("T", "R", "multihot", "window"),
                 lambda: (_lib(), _lib().ofs_fused_spmm))


def fused_spmm(plan: FusedPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (float32, (n, d)) for a placed FusedPlan of A and float32
    ``x`` (m, d), through ``torch.ops.ofs.fused_spmm``. On the card this
    launches the kernel once per segment; on the CPU it runs
    ``fused_spmm_torch``. A window row that resolves outside x is an error
    on both: the plain version raises, and the kernel stops with a
    device-side assertion that the next synchronization raises."""
    check_plan(plan, x, FusedPlan, "fused_spmm")
    return _run(plan, x)
