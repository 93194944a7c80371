"""The one-hot expansion engine's CUDA kernel, its plain version and its
launcher (layout="expansion").

``spmm_expansion(plan, x)`` computes Y = A @ X for an ExpansionPlan
(sparse/expansion.py), with the JAX package's name and result
(of_spmm_tpu/ops/pallas/expansion.py::spmm_expansion): ``expansion_spmm``
launches the kernel in ``csrc/expansion.cu`` once per plan group. It
replaces the TPU kernel ``_expansion_kernel`` together with its wrapper's
tier-major staging; design notes are in csrc/expansion.cuh, which this
engine and expansion2 (ops/cuda/expansion2.py) share.

The wrappers dispatch on the device of ``x``: on the CPU they run the
plain version (what the CPU tests hold against the JAX package); on the
card they launch the kernel or raise, and never fall back. Each launch
adds one to ``LAUNCHES["expansion_spmm"]`` (ops/cuda/build.py).

Numerics: fp32 throughout. The TPU kernel computes in bf16 hi/lo pairs
and drops the vl * lo term (about 1.5e-5 relative); its bf16 fast mode
for bf16 X has no counterpart here: X is cast to float32 for every input
dtype and the result cast back.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream
from of_spmm_tpu_torch.sparse import expansion2
from of_spmm_tpu_torch.sparse.expansion import ExpansionPlan, attach_stage_rows
from of_spmm_tpu_torch.utils.config import FLAGS
from of_spmm_tpu_torch.utils.device import place_arrays

SOURCE = "expansion.cu"
_L = 128


def build() -> Dict[str, object]:
    """Compile csrc/expansion.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def bind(fn) -> None:
    """argtypes of ofs_expansion_spmm / ofs_expansion2_spmm (same signature)."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p] * 11 + [i64] * 6 + [i32] * 4 + [p]
    fn.restype = i32


def _bind(lib: ctypes.CDLL) -> None:
    bind(lib.ofs_expansion_spmm)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def is_placed(plan, device: torch.device) -> bool:
    """Whether every group of ``plan`` has its provenance and its arrays
    as tensors on ``device``."""
    return all(g.stage_row is not None and isinstance(g.lrow, torch.Tensor)
               and g.lrow.device == device and isinstance(g.stage_row, torch.Tensor)
               for g in plan.groups)


def place_plan(plan, device):
    """An ExpansionPlan or Expansion2Plan with each group's provenance
    (``stage_row``) attached on the host and every array a tensor on
    ``device``."""
    if isinstance(plan, ExpansionPlan):
        plan = attach_stage_rows(plan)
    elif isinstance(plan, expansion2.Expansion2Plan):
        plan = expansion2.attach_stage_rows(plan)
    else:
        raise TypeError(f"place_plan takes an ExpansionPlan or Expansion2Plan, "
                        f"got {type(plan).__name__}")
    return place_arrays(plan, torch.device(device))


def check_plan(plan, x: torch.Tensor, plan_type, what: str) -> None:
    if not isinstance(plan, plan_type):
        raise TypeError(f"{what} takes a {plan_type.__name__}, got {type(plan).__name__}")
    require(x, "x", torch.float32, 2)
    if x.shape[0] != plan.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows, the plan {plan.shape[1]} columns")
    for g in plan.groups:
        if g.stage_row is None or not isinstance(g.lrow, torch.Tensor):
            raise ValueError("the plan is not placed: run ops.place_plan (it attaches the "
                             "staged rows' provenance)")
        same_device(x, g.lrow, g.stage_row)


def bf16_tensor_value(bits: torch.Tensor) -> torch.Tensor:
    """The float32 value of a uint16 tensor of bf16 bits (exact)."""
    return bits.view(torch.bfloat16).to(torch.float32)


def scatter_lanes(out: torch.Tensor, x: torch.Tensor, src: torch.Tensor, orow: torch.Tensor,
                  scale: torch.Tensor) -> None:
    """out[orow] += scale * x[src], lane by lane, in chunks of at most
    OFS_SPMM_MAX_GATHER_SLOTS gathered rows."""
    max_rows = max(int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS")), 1)
    for e0 in range(0, src.shape[0], max_rows):
        e1 = e0 + max_rows
        out.index_add_(0, orow[e0:e1], x.index_select(0, src[e0:e1]) * scale[e0:e1, None])


def expansion_spmm_torch(plan: ExpansionPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on the same placed plan, following the
    TPU kernel's function step by step per group: stage (staged row u
    holds X[stage_row[u]]), select each lane's staged row through its
    step's window blocks, scale it by the lane's value, and scatter-add it
    into row lrow of the step's tile; the output is the groups' tiles
    concatenated, cut to n rows. Lanes of value 0 (the padding) add
    nothing and are skipped."""
    check_plan(plan, x, ExpansionPlan, "expansion_spmm_torch")
    n, d = plan.n_rows, x.shape[1]
    nblk = plan.CW // _L
    out = torch.zeros((plan.n_tiles * plan.R, d), dtype=torch.float32, device=x.device)
    tile0 = 0
    for g in plan.groups:
        li = g.win_lidx.reshape(-1).long()
        step = torch.arange(li.shape[0], device=x.device) // plan.TILE
        val = (bf16_tensor_value(g.val_hi) + bf16_tensor_value(g.val_lo)).reshape(-1)
        real = val != 0
        li, step, val = li[real], step[real], val[real]
        u = g.base_blk.long()[step * nblk + li // _L] * _L + li % _L
        orow = (tile0 + g.tile_of.long()[step]) * plan.R + g.lrow.reshape(-1)[real].long()
        scatter_lanes(out, x, g.stage_row.long()[u], orow, val)
        tile0 += g.n_tiles
    return out[:n]


def launch_groups(plan, x: torch.Tensor, lib, fn, name: str, lanes, nblk: int,
                  groups_per_step: int) -> torch.Tensor:
    """Zero Y and launch ``fn`` (a bound ofs_expansion*_spmm of ``lib``)
    once per group with steps; ``lanes(g)`` is the group's (lane index,
    staging block) arrays."""
    n, m = plan.shape
    d = x.shape[1]
    dev = x.device
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    row_scale = getattr(plan, "row_scale", None)
    row0 = 0
    for g in plan.groups:
        if g.n_steps:
            lidx, blk = lanes(g)
            rc = fn(ptr(lidx), ptr(g.lrow), ptr(g.val_hi), ptr(g.val_lo), ptr(blk),
                    ptr(g.tile_of), ptr(g.stage_row), ptr(getattr(g, "stage_scale", None)),
                    ptr(row_scale), x.data_ptr(), out.data_ptr(), m, n, d, row0, g.n_steps,
                    int(g.stage_row.shape[0]), groups_per_step, nblk, plan.R,
                    dev.index or 0, stream(dev))
            raise_if(lib, rc, name)
            LAUNCHES[name] += 1
        row0 += g.n_tiles * plan.R
    return out


def expansion_spmm(plan: ExpansionPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (float32, (n, d)) for a placed ExpansionPlan of A and
    float32 ``x`` (m, d). On the card this launches the kernel once per
    group; on the CPU it runs ``expansion_spmm_torch``. A staged row that
    names a row outside x stops the kernel with a device-side assertion
    that the next synchronization raises."""
    check_plan(plan, x, ExpansionPlan, "expansion_spmm")
    dev = x.device
    if dev.type == "cpu":
        return expansion_spmm_torch(plan, x)
    if dev.type != "cuda":
        raise ValueError(f"expansion_spmm runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    return launch_groups(plan, x, lib, lib.ofs_expansion_spmm, "expansion_spmm",
                         lambda g: (g.win_lidx, g.base_blk), plan.CW // _L, plan.TILE // _L)


def spmm_expansion(plan: ExpansionPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with the one-hot expansion engine, in x's dtype.

    A plan not yet placed on x's device is placed for this call (once
    with ``ops.place_plan`` saves the copy on every call). X is computed
    in float32 whatever its dtype."""
    if not is_placed(plan, x.device):
        plan = place_plan(plan, x.device)
    return expansion_spmm(plan, x.to(torch.float32).contiguous()).to(x.dtype)
