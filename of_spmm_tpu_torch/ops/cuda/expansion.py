"""The one-hot expansion engine's CUDA kernel, its plain version and its
launcher (layout="expansion").

``spmm_expansion(plan, x)`` computes Y = A @ X for an ExpansionPlan
(sparse/expansion.py), with the JAX package's name and result
(of_spmm_tpu/ops/pallas/expansion.py::spmm_expansion): ``expansion_spmm``
launches the kernel in ``csrc/expansion.cu`` once per SpMM, one block per
work unit of the plan's work list (LaneWork, sparse/expansion.py
lane_work). It replaces the TPU kernel ``_expansion_kernel`` together with
its wrapper's tier-major staging; design notes are in csrc/expansion.cuh,
which this engine and expansion2 (ops/cuda/expansion2.py) share.
``expansion_units_torch`` repeats the kernel's split into units (partial
sums, row-scaled, added per output block) in plain PyTorch, for both
engines.

The wrappers flatten the plan into ``torch.ops.ofs.expansion_spmm`` /
``expansion2_spmm`` (``define_op``; ops/cuda/library.py), which dispatch
on the device of ``x``: on the CPU they run the plain version (what the
CPU tests hold against the JAX package); on the card they launch the
kernel or raise, and never fall back. Each launch
adds one to ``LAUNCHES["expansion_spmm"]`` (ops/cuda/build.py).

Numerics: fp32 throughout. The TPU kernel computes in bf16 hi/lo pairs
and drops the vl * lo term (about 1.5e-5 relative); its bf16 fast mode
for bf16 X has no counterpart here: X is cast to float32 for every input
dtype and the result cast back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda import library
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
    fn.argtypes = [p] * 7 + [i64] * 5 + [i32] * 4 + [p]
    fn.restype = i32


def _bind(lib: ctypes.CDLL) -> None:
    bind(lib.ofs_expansion_spmm)


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def is_placed(plan, device: torch.device) -> bool:
    """Whether every group of ``plan`` has its provenance and its arrays
    as tensors on ``device``, and the plan its work list there."""
    return (plan.work is not None and isinstance(plan.work.table, torch.Tensor)
            and plan.work.table.device == device
            and all(g.stage_row is not None and isinstance(g.lrow, torch.Tensor)
                    and g.lrow.device == device and isinstance(g.stage_row, torch.Tensor)
                    for g in plan.groups))


def _group_rows(groups, v2: bool) -> tuple:
    """Per group: its lane index, row, value (0 without) and block arrays,
    stage_row, stage_scale (0 without) pointers and its staged rows; the
    rows of the kernel's device table (csrc/expansion.cuh Args)."""
    def ptr(t):
        return 0 if t is None else t.data_ptr()

    return tuple((ptr(g.lidx if v2 else g.win_lidx), ptr(g.lrow), ptr(g.val_hi), ptr(g.val_lo),
                  ptr(g.blk_of if v2 else g.base_blk), ptr(g.stage_row),
                  ptr(getattr(g, "stage_scale", None)), int(g.stage_row.shape[0]))
                 for g in groups)


def _group_ptrs(plan) -> tuple:
    """``_group_rows`` of a placed plan of either engine."""
    return _group_rows(plan.groups, isinstance(plan, expansion2.Expansion2Plan))


def _with_table(plan):
    """The placed plan with its work list's device table (LaneWork.table,
    .ptrs) built from its groups' arrays (and remembered for the op's
    check that they have not moved, ops/cuda/library.py check_work)."""
    rows = _group_ptrs(plan)
    dev = plan.work.lanes.device
    library.bind_work(plan.work.units, rows)
    return dataclasses.replace(plan, work=dataclasses.replace(
        plan.work, table=library.device_table(rows, 8, dev), ptrs=rows))


def _attach(plan, max_lanes: Optional[int] = None):
    """The plan's provenance and work list derived anew on the host."""
    if isinstance(plan, ExpansionPlan):
        return attach_stage_rows(dataclasses.replace(plan, work=None), max_lanes)
    if isinstance(plan, expansion2.Expansion2Plan):
        return expansion2.attach_stage_rows(dataclasses.replace(plan, work=None), max_lanes)
    raise TypeError(f"place_plan takes an ExpansionPlan or Expansion2Plan, "
                    f"got {type(plan).__name__}")


def place_plan(plan, device, max_lanes: Optional[int] = None):
    """An ExpansionPlan or Expansion2Plan with each group's provenance
    (``stage_row``) and the plan's work list (units of at most
    ``max_lanes`` lanes; sparse/expansion.py UNIT_LANES by default)
    derived on the host, and every array a tensor on ``device``."""
    return _with_table(place_arrays(_attach(plan, max_lanes), torch.device(device)))


def with_lane_cap(plan, cap: int):
    """The placed plan with its work list cut again at ``cap`` lanes per
    unit (derived on the host from a copy of its arrays)."""
    host = place_arrays(dataclasses.replace(plan, work=None), torch.device("cpu"))
    work = place_arrays(_attach(host, cap).work, plan.work.lanes.device)
    return _with_table(dataclasses.replace(plan, work=work))


def check_plan(plan, x: torch.Tensor, plan_type, what: str) -> None:
    if not isinstance(plan, plan_type):
        raise TypeError(f"{what} takes a {plan_type.__name__}, got {type(plan).__name__}")
    require(x, "x", torch.float32, 2)
    if x.shape[0] != plan.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows, the plan {plan.shape[1]} columns")
    if plan.work is None or not isinstance(plan.work.lanes, torch.Tensor):
        raise ValueError("the plan is not placed: run ops.place_plan (it attaches the "
                         "staged rows' provenance and the work list)")
    for g in plan.groups:
        if g.stage_row is None or not isinstance(g.lrow, torch.Tensor):
            raise ValueError("the plan is not placed: run ops.place_plan (it attaches the "
                             "staged rows' provenance)")
        same_device(x, g.lrow, g.stage_row)
    same_device(x, plan.work.lanes, plan.work.units)


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
    return _expansion_plain(plan, x)


def _expansion_plain(plan, x: torch.Tensor) -> torch.Tensor:
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


def resolve_lanes(plan, g, e: torch.Tensor):
    """(X row, multiplier, output row within the group's tiles) of the
    lanes ``e`` (int64 indices into group ``g``'s lane arrays), as the
    kernel resolves them: the staged row through the step's window (v1)
    or the lane group's block (v2), the value's bf16 pair or the staged
    row's column scale."""
    v2 = isinstance(plan, expansion2.Expansion2Plan)
    if v2:
        li = g.lidx.reshape(-1).long()[e]
        u = g.blk_of.long()[e // _L] * _L + li % _L
        tile = g.tile_of.long()[e // (plan.G * _L)]
    else:
        li = g.win_lidx.reshape(-1).long()[e]
        step = e // plan.TILE
        u = g.base_blk.long()[step * (plan.CW // _L) + li // _L] * _L + li % _L
        tile = g.tile_of.long()[step]
    if g.val_hi is not None:
        mul = (bf16_tensor_value(g.val_hi) + bf16_tensor_value(g.val_lo)).reshape(-1)[e]
    else:
        mul = torch.ones(e.shape, dtype=torch.float32, device=e.device)
    if getattr(g, "stage_scale", None) is not None:
        mul = mul * g.stage_scale[u]
    return g.stage_row.long()[u], mul, tile * plan.R + g.lrow.reshape(-1).long()[e]


def expansion_units_torch(plan, x: torch.Tensor) -> torch.Tensor:
    """The kernel's work split in plain PyTorch, on a placed plan of
    either engine: each work unit's partial sum over its lanes
    (LaneWork), times row_scale (v2 rank-1), added into the rows of its
    128-row output block below n. Equal to the engine's plain version up
    to the order of the sums."""
    n, d = plan.n_rows, x.shape[1]
    dev = x.device
    work = plan.work
    nwb = -(-plan.R // _L)
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    units = work.units.long()
    lanes = work.lanes.long()
    first_tile = [0]
    for g in plan.groups:
        first_tile.append(first_tile[-1] + g.n_tiles)
    row_scale = getattr(plan, "row_scale", None)
    for u, (key, a, b, gi) in enumerate(units.tolist()):
        key = ~key if key < 0 else key
        g = plan.groups[gi]
        src, mul, orow = resolve_lanes(plan, g, lanes[a:b])
        orow = orow + first_tile[gi] * plan.R
        row0 = key // nwb * plan.R + key % nwb * _L
        if bool(((orow < row0) | (orow >= row0 + _L)).any()):
            raise AssertionError(f"unit {u} holds a lane outside its output block")
        part = torch.zeros((_L, d), dtype=torch.float32, device=dev)
        scatter_lanes(part, x, src, orow - row0, mul)
        rows = torch.arange(row0, row0 + min(_L, plan.R - key % nwb * _L), device=dev)
        rows = rows[rows < n]
        part = part[:rows.shape[0]]
        if row_scale is not None:
            part = part * row_scale[rows][:, None]
        out.index_add_(0, rows, part)
    return out


def launch(plan, x: torch.Tensor, lib, fn, name: str, tile_lanes: int,
           nblk: int, v2: bool) -> torch.Tensor:
    """Y through one call of ``fn`` (a bound ofs_expansion*_spmm of
    ``lib``): the split keys' rows zeroed, then one launch over every work
    unit of the plan. Y is not zeroed as a whole. The groups' address
    table is built from the plan's arrays now (ops/cuda/library.py
    device_table)."""
    n, m = plan.shape
    d = x.shape[1]
    dev = x.device
    work = plan.work
    out = torch.empty((n, d), dtype=torch.float32, device=dev)  # every row has a unit
    if n == 0 or d == 0 or work.units.shape[0] == 0:
        return out
    rows = _group_rows(plan.groups, v2)
    library.check_work(work.units, rows, name)
    rs = getattr(plan, "row_scale", None)
    rc = fn(library.device_table(rows, 8, dev).data_ptr(), work.lanes.data_ptr(),
            work.units.data_ptr(), work.split_keys.data_ptr(),
            None if rs is None else rs.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, d,
            int(work.units.shape[0]), int(work.split_keys.shape[0]), plan.R, tile_lanes, nblk,
            dev.index or 0, stream(dev))
    raise_if(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def define_op(name: str, v2: bool, arrays: Tuple[str, ...], ints: Tuple[str, ...],
              group_arrays: Tuple[str, ...], plain: Callable, kernel: Callable[[], tuple],
              geometry: Callable) -> Callable:
    """Register ``ofs::<name>`` for one expansion engine
    (``library.plan_op``; the plan's work list among its arrays):
    ``plain(plan, x)`` its plain version, ``kernel()`` (library, bound
    launch function), ``geometry(plan)`` the launch's (tile lanes, window
    blocks). Returns ``run(plan, x)``."""
    def run_kernel(plan, x):
        lib, fn = kernel()
        return launch(plan, x, lib, fn, name, *geometry(plan), v2)

    return library.plan_op(
        name, arrays=("work.lanes", "work.units", "work.split_keys") + arrays, ints=ints,
        items="groups", item_arrays=group_arrays, item_ints=("n_tiles",),
        derived=lambda plan: {"n_rows": plan.shape[0],
                              "n_tiles": sum(g.n_tiles for g in plan.groups)},
        plain=plain, launch=run_kernel)


# ofs::expansion_spmm: one launch per SpMM
_run = define_op("expansion_spmm", False, (), ("R", "TILE", "CW"),
                 ("win_lidx", "lrow", "val_hi", "val_lo", "base_blk", "tile_of", "stage_row"),
                 _expansion_plain, lambda: (_lib(), _lib().ofs_expansion_spmm),
                 lambda plan: (plan.TILE, plan.CW // _L))


def expansion_spmm(plan: ExpansionPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (float32, (n, d)) for a placed ExpansionPlan of A and
    float32 ``x`` (m, d), through ``torch.ops.ofs.expansion_spmm``. On the
    card this launches the kernel once; on the CPU it runs
    ``expansion_spmm_torch``. A staged row that names a row outside x
    stops the kernel with a device-side assertion that the next
    synchronization raises."""
    check_plan(plan, x, ExpansionPlan, "expansion_spmm")
    return _run(plan, x)


def spmm_expansion(plan: ExpansionPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with the one-hot expansion engine, in x's dtype.

    A plan not yet placed on x's device is placed for this call (once
    with ``ops.place_plan`` saves the copy on every call). X is computed
    in float32 whatever its dtype."""
    if not is_placed(plan, x.device):
        plan = place_plan(plan, x.device)
    return expansion_spmm(plan, x.to(torch.float32).contiguous()).to(x.dtype)
