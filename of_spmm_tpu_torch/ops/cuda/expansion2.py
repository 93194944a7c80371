"""The one-hot expansion engine v2's CUDA kernel, its plain version and
its launcher.

``spmm_expansion2(plan, x)`` computes Y = A @ X for an Expansion2Plan
(sparse/expansion2.py), with the JAX package's name and result
(of_spmm_tpu/ops/pallas/expansion2.py::spmm_expansion2):
``expansion2_spmm`` launches the kernel in ``csrc/expansion2.cu`` once per
SpMM, one block per work unit of the plan's work list. It replaces the
TPU kernel ``_kernel`` together with its wrapper's column-scaled
tier-major staging and row scaling; design notes are in
csrc/expansion.cuh, shared with the v1 engine (ops/cuda/expansion.py,
which also holds the launcher and the unit-by-unit plain version,
``expansion_units_torch``, both use).

The wrappers flatten the plan into ``torch.ops.ofs.expansion2_spmm``
(ops/cuda/expansion.py define_op), which dispatches on the device of
``x``: on the CPU it runs the plain version; on the card it launches the
kernel or raises, and never falls back. Each launch adds one to ``LAUNCHES["expansion2_spmm"]``
(ops/cuda/build.py). fp32 throughout, as for v1.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.expansion import (
    bf16_tensor_value, bind, check_plan, define_op, is_placed, place_plan, scatter_lanes)
from of_spmm_tpu_torch.sparse.expansion2 import Expansion2Plan

SOURCE = "expansion2.cu"
_L = 128


def build() -> Dict[str, object]:
    """Compile csrc/expansion2.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    bind(lib.ofs_expansion2_spmm)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def expansion2_spmm_torch(plan: Expansion2Plan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on the same placed plan, following the
    TPU kernel's function step by step per group: stage (staged row u
    holds X[stage_row[u]] * stage_scale[u] on rank-1 plans), select each
    lane's staged row from its group's block, scale it by the lane's value
    (general plans), and scatter-add it into row lrow of the step's tile;
    the output is the groups' tiles concatenated, cut to n rows and scaled
    by row_scale (rank-1 plans). Lanes on the sentinel row R, or of value
    0, add nothing and are skipped."""
    check_plan(plan, x, Expansion2Plan, "expansion2_spmm_torch")
    return _expansion2_plain(plan, x)


def _expansion2_plain(plan, x: torch.Tensor) -> torch.Tensor:
    n, d = plan.n_rows, x.shape[1]
    out = torch.zeros((plan.n_tiles * plan.R, d), dtype=torch.float32, device=x.device)
    tile0 = 0
    for g in plan.groups:
        lrow = g.lrow.reshape(-1).long()
        slot = torch.arange(lrow.shape[0], device=x.device) // _L
        real = lrow < plan.R
        val = None
        if g.val_hi is not None:
            val = (bf16_tensor_value(g.val_hi) + bf16_tensor_value(g.val_lo)).reshape(-1)
            real &= val != 0
            val = val[real]
        slot, lrow = slot[real], lrow[real]
        u = g.blk_of.long()[slot] * _L + g.lidx.reshape(-1)[real].long()
        scale = g.stage_scale[u] if val is None else val
        orow = (tile0 + g.tile_of.long()[slot // plan.G]) * plan.R + lrow
        scatter_lanes(out, x, g.stage_row.long()[u], orow, scale)
        tile0 += g.n_tiles
    y = out[:n]
    return y * plan.row_scale[:, None] if plan.row_scale is not None else y


# ofs::expansion2_spmm: one launch per SpMM
_run = define_op("expansion2_spmm", True, ("row_scale",), ("R", "G"),
                 ("lidx", "lrow", "val_hi", "val_lo", "blk_of", "tile_of", "stage_row",
                  "stage_scale"),
                 _expansion2_plain, lambda: (_lib(), _lib().ofs_expansion2_spmm),
                 lambda plan: (plan.G * _L, 0))


def expansion2_spmm(plan: Expansion2Plan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (float32, (n, d)) for a placed Expansion2Plan of A and
    float32 ``x`` (m, d), through ``torch.ops.ofs.expansion2_spmm``. On the
    card this launches the kernel once (row_scale folded into each output
    row once); on the CPU it runs ``expansion2_spmm_torch``. A staged row
    that names a row outside x stops the kernel with a device-side
    assertion that the next synchronization raises."""
    check_plan(plan, x, Expansion2Plan, "expansion2_spmm")
    return _run(plan, x)


def spmm_expansion2(plan: Expansion2Plan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with the v2 one-hot expansion engine, in x's dtype.

    A plan not yet placed on x's device is placed for this call (once
    with ``ops.place_plan`` saves the copy on every call). X is computed
    in float32 whatever its dtype."""
    if not is_placed(plan, x.device):
        plan = place_plan(plan, x.device)
    return expansion2_spmm(plan, x.to(torch.float32).contiguous()).to(x.dtype)
