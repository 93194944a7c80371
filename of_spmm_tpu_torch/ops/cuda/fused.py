"""The fused engine's CUDA kernel, its plain version and its launcher.

``fused_spmm(plan, x)`` computes Y = A @ X for a placed FusedPlan
(sparse/fused.py): one launch of the kernel in ``csrc/fused.cu`` per plan
segment. It replaces the TPU kernel
``of_spmm_tpu/ops/pallas/fused.py::_kernel`` together with its host
wrapper's column scaling, staging tables and row scaling; design notes are
in csrc/staged_spmm.cuh, which the fused and the ranges kernels share.

The wrapper dispatches on the device of ``x``: on the CPU it runs
``fused_spmm_torch`` (what the CPU tests hold against the JAX package);
on the card it launches the kernel or raises, and never falls back.
Each launch adds one to ``LAUNCHES["fused_spmm"]`` (ops/cuda/build.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.staged import bind, check_plan, launch_segments, staged_spmm_torch
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


def fused_spmm(plan: FusedPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (float32, (n, d)) for a placed FusedPlan of A and float32
    ``x`` (m, d). On the card this launches the kernel once per segment;
    on the CPU it runs ``fused_spmm_torch``. A window row that resolves
    outside x is an error on both: the plain version raises, and the
    kernel stops with a device-side assertion that the next
    synchronization raises."""
    check_plan(plan, x, FusedPlan, "fused_spmm")
    dev = x.device
    if dev.type == "cpu":
        return staged_spmm_torch(plan, x)
    if dev.type != "cuda":
        raise ValueError(f"fused_spmm runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    return launch_segments(plan, x, lib, lib.ofs_fused_spmm, "fused_spmm")
