"""The SpMM path's two CUDA kernels, their plain versions and launchers.

- ``bucket_spmm``: padded-ELL buckets' partial rows,
  ``out[r] = sum_k vals[r, k] * x[row_offset + cols[r, k]]``. Replaces the
  TPU kernel ``of_spmm_tpu/ops/pallas/spmm.py::_bucket_kernel``.
  ``bucket_spmm_plan`` runs every bucket of a placed TieredEll or
  BinnedEll plan in one launch and writes their concatenation (the buffer
  the finish gathers from); ``bucket_spmm`` runs one bucket.
- ``gather_rows``: ``out[i] = table[idx[i]]``, zero rows for indices
  outside the table. Replaces ``::_gather_kernel``.

Both kernels live in ``csrc/spmm.cu`` (design notes there). They are
compiled with ``nvcc -arch=sm_90a`` into a shared library at first use and
bound with ctypes (ops/cuda/build.py); the build goes to ``_build/``
beside the package, keyed by the source hash.

The bucket kernel's work list (``BucketWork``, built at placement by
``bucket_work``): a device table of the plan's buckets and the buckets cut
into units of whole ELL rows (``bucket_units``), tier by tier, heaviest
first within a tier.
``bucket_spmm_units_torch`` repeats that split in plain PyTorch.

Each wrapper calls its op, ``torch.ops.ofs.bucket_spmm`` or
``torch.ops.ofs.gather_rows`` (ops/cuda/library.py), which dispatches on
the device of the tensors it is given: on the CPU it runs the plain
PyTorch version beside it (what the CPU tests check against the JAX
package); on the card it launches the kernel or raises. It never falls
back. The bucket op takes the buckets' arrays themselves and builds the
kernel's address table from them at each call (cached by content).
``LAUNCHES`` (ops/cuda/build.py) counts kernel launches per wrapper, so
a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda.build import (  # noqa: F401  (LAUNCHES, reset: re-exported)
    LAUNCHES, raise_if, require, reset_launch_counts, same_device, stream)
from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda import library
from of_spmm_tpu_torch.utils.config import FLAGS

SOURCE = "spmm.cu"
BUCKET_UNIT_SLOTS = 2048  # padded slots per work unit of the bucket kernel
UNIT_ROWS = 128           # ELL rows per unit at most: the kernel's accumulator tile


def build() -> Dict[str, object]:
    """Compile csrc/spmm.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_bucket_spmm.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
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


@dataclasses.dataclass(frozen=True)
class BucketWork:
    """The bucket kernel's work list for one plan (placement data, port
    only): ``table`` int64 (n_buckets, 6), per bucket its cols and vals
    pointers, K, ELL rows, row_offset and first row in the concatenation;
    ``units`` int32 (n_units, 3) [bucket, first ELL row, rows]
    (``bucket_units``); ``ptrs`` the cols and vals pointers the table
    holds. The op builds its own table from the buckets it is given (the
    placement's is the same one, from ``library.device_table``'s cache)
    and refuses these units once the arrays they were cut for have moved
    (``library.check_work``)."""

    table: torch.Tensor
    units: torch.Tensor
    ptrs: Tuple[int, ...]
    n_ell_rows: int


def bucket_units(widths, rows, cap: Optional[int] = None, tiers=None) -> np.ndarray:
    """The buckets (K = ``widths[b]``, ``rows[b]`` ELL rows, column tier
    ``tiers[b]``, all 0 by default) cut into work units of whole ELL rows:
    (n_units, 3) int32 [bucket, first row, rows]. A unit holds at most
    UNIT_ROWS rows and ``cap`` padded slots (BUCKET_UNIT_SLOTS by
    default); a row wider than ``cap`` is a unit alone. Units run tier by
    tier, the warm tiers in order and the cold tier (-1, rows of the
    whole of X) last, so that one tier's slice of X is read while its
    units run; within a tier heaviest first (by slots; stable, so ties
    keep bucket and row order), so that its wide rows start at once."""
    cap = BUCKET_UNIT_SLOTS if cap is None else int(cap)
    if cap < 1:
        raise ValueError(f"unit slot cap {cap} must be positive")
    widths = np.asarray(widths, np.int64).reshape(-1)
    tiers = np.zeros_like(widths) if tiers is None else np.asarray(tiers, np.int64).reshape(-1)
    parts = [np.zeros((0, 3), np.int64)]
    for b, (K, R) in enumerate(zip(widths, np.asarray(rows, np.int64).reshape(-1))):
        per = max(1, min(UNIT_ROWS, cap // max(int(K), 1)))
        r0 = np.arange(0, int(R), per, dtype=np.int64)
        parts.append(np.stack([np.full_like(r0, b), r0, np.minimum(per, R - r0)], 1))
    units = np.concatenate(parts)
    tier = tiers[units[:, 0]]
    order = np.lexsort((-(units[:, 2] * widths[units[:, 0]]),
                        np.where(tier < 0, np.iinfo(np.int64).max, tier)))
    return units[order].astype(np.int32)


def plan_buckets(plan) -> Tuple[tuple, ...]:
    """(cols, vals, row_offset) of every bucket of a TieredEll (tier order;
    row_offset 0 for tier -1, tier * tier_size otherwise) or a BinnedEll
    (row_offset 0), in the order of the concatenation buffer."""
    if hasattr(plan, "tiers"):
        return tuple((b.cols, b.vals, 0 if t.tier < 0 else t.tier * plan.tier_size)
                     for t in plan.tiers for b in t.buckets)
    return tuple((b.cols, b.vals, 0) for b in plan.buckets)


def plan_tiers(plan) -> Tuple[int, ...]:
    """The column tier of every bucket in ``plan_buckets`` order (-1: the
    cold tier; 0 for every bucket of a BinnedEll)."""
    if hasattr(plan, "tiers"):
        return tuple(t.tier for t in plan.tiers for _b in t.buckets)
    return (0,) * len(plan.buckets)


def _table_rows(cols, vals, row_offsets) -> Tuple[Tuple[int, ...], ...]:
    """The kernel's device table of these buckets, one row each: cols
    and vals pointers, K, ELL rows, row_offset and first row in the
    concatenation."""
    rows, first = [], 0
    for c, v, o in zip(cols, vals, row_offsets):
        rows.append((c.data_ptr(), v.data_ptr(), int(c.shape[1]), int(c.shape[0]), int(o), first))
        first += int(c.shape[0])
    return tuple(rows)


def _work_for(buckets, device, cap: Optional[int] = None, tiers=None) -> BucketWork:
    rows = [int(c.shape[0]) for c, _, _ in buckets]
    widths = [int(c.shape[1]) for c, _, _ in buckets]
    table = _table_rows(*zip(*buckets)) if buckets else ()
    units = torch.from_numpy(bucket_units(widths, rows, cap, tiers)).to(device)
    library.bind_work(units, table)
    return BucketWork(
        table=library.device_table(table, 6, device), units=units,
        ptrs=tuple(p for r in table for p in r[:2]), n_ell_rows=sum(rows))


def bucket_work(plan, cap: Optional[int] = None) -> BucketWork:
    """The work list of a placed TieredEll or BinnedEll plan, on its
    arrays' device (``cap``: the unit slot cap, BUCKET_UNIT_SLOTS by
    default)."""
    buckets = plan_buckets(plan)
    for c, v, _ in buckets:
        if not isinstance(c, torch.Tensor) or not isinstance(v, torch.Tensor):
            raise TypeError("the plan's arrays must be torch tensors (ops.place_operator)")
    dev = buckets[0][0].device if buckets else torch.device("cpu")
    return _work_for(buckets, dev, cap, plan_tiers(plan))


def _check_bucket(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> None:
    require(cols, "cols", torch.int32, 2)
    require(vals, "vals", torch.float32, 2)
    if vals.shape != cols.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != cols {tuple(cols.shape)}")
    same_device(cols, vals, x)


def _out_buffer(out: Optional[torch.Tensor], rows: int, x: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty((rows, x.shape[1]), dtype=torch.float32, device=x.device)
    require(out, "out", torch.float32, 2)
    same_device(x, out)
    if tuple(out.shape) != (rows, x.shape[1]):
        raise ValueError(f"out must be {(rows, x.shape[1])}, got {tuple(out.shape)}")
    return out


def _bucket_cpu(cols: List[torch.Tensor], vals: List[torch.Tensor], row_offsets: List[int],
                units: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    r0 = 0
    for c, v, o in zip(cols, vals, row_offsets):
        bucket_spmm_torch(c, v, x, o, out[r0:r0 + c.shape[0]])
        r0 += c.shape[0]


def _bucket_cuda(cols, vals, row_offsets, units, x, out) -> None:
    dev = x.device
    require(units, "units", torch.int32, 2)
    same_device(x, out, units, *cols, *vals)
    if out.shape[0] == 0 or x.shape[1] == 0:
        return
    rows = _table_rows(cols, vals, row_offsets)
    library.check_work(units, rows, "bucket_spmm")
    lib = _lib()
    rc = lib.ofs_bucket_spmm(library.device_table(rows, 6, dev).data_ptr(), units.data_ptr(),
                             x.data_ptr(), out.data_ptr(), int(units.shape[0]), x.shape[0],
                             x.shape[1], dev.index or 0, stream(dev))
    raise_if(lib, rc, "bucket_spmm")
    LAUNCHES["bucket_spmm"] += 1


def _bucket_fake(cols, vals, row_offsets, units, x, out) -> None:
    return None


# ofs::bucket_spmm(Tensor[] cols, Tensor[] vals, int[] row_offsets, Tensor units,
#                  Tensor x, Tensor(a!) out) -> ()
_bucket_op = library.define("bucket_spmm", _bucket_cpu, _bucket_cuda, _bucket_fake,
                            mutates_args=("out",))


def _run_buckets(buckets, x: torch.Tensor, units: Optional[torch.Tensor],
                 out: torch.Tensor, tiers=None) -> torch.Tensor:
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bucket_spmm runs on cuda or cpu tensors, got {dev}")
    if units is None:
        units = torch.from_numpy(bucket_units([int(c.shape[1]) for c, _, _ in buckets],
                                              [int(c.shape[0]) for c, _, _ in buckets],
                                              tiers=tiers)).to(dev)
    cols, vals, offs = (list(t) for t in zip(*buckets)) if buckets else ([], [], [])
    _bucket_op(cols, vals, [int(o) for o in offs], units, x, out)
    return out


def bucket_spmm(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                row_offset: int = 0,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partial rows (R, d) float32 of one ELL bucket against ``x``.

    ``cols`` int32 (R, K) index rows ``row_offset + cols`` of ``x``; ``vals``
    float32 (R, K); ``x`` float32 (n, d). ``out``, if given, is a
    contiguous float32 (R, d) view to write into (a slice of a
    preallocated concatenation buffer). On the card this launches the
    kernel on a one-bucket plan; on the CPU it runs ``bucket_spmm_torch``
    (both through ``torch.ops.ofs.bucket_spmm``).
    A column that points outside ``x`` is an error on both:
    ``index_select`` raises on the CPU, and the kernel stops with a
    device-side assertion that the next synchronization raises.
    """
    require(x, "x", torch.float32, 2)
    _check_bucket(cols, vals, x)
    out = _out_buffer(out, cols.shape[0], x)
    return _run_buckets(((cols, vals, int(row_offset)),), x, None, out)


def bucket_spmm_plan(plan, x: torch.Tensor, work: Optional[BucketWork] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The concatenation (total ELL rows, d) float32 of every bucket's
    partial rows of a placed TieredEll or BinnedEll plan against float32
    ``x``, in ``plan_buckets`` order, through ``torch.ops.ofs.bucket_spmm``.
    On the card this is one launch of the kernel over ``work`` (the plan's
    work list from placement, or built here for this call); on the CPU it
    runs ``bucket_spmm_torch`` bucket by bucket. ``out``, if given, is the
    buffer to write."""
    require(x, "x", torch.float32, 2)
    buckets = plan_buckets(plan)
    for c, v, _ in buckets:
        _check_bucket(c, v, x)
    out = _out_buffer(out, sum(int(c.shape[0]) for c, _, _ in buckets), x)
    if work is not None and work.units.device != x.device:
        raise ValueError("the work list was built for other arrays: place the operator "
                         "again (ops.place_operator)")
    return _run_buckets(buckets, x, None if work is None else work.units, out,
                        tiers=plan_tiers(plan))


def bucket_spmm_units_torch(plan, x: torch.Tensor, work: BucketWork) -> torch.Tensor:
    """The kernel's work split in plain PyTorch: each unit of ``work``
    computes its ELL rows (padding slots skipped) and writes them once
    into the concatenation, which starts as NaN, so a row no unit writes,
    or a unit that writes outside its rows, shows. Equal to
    ``bucket_spmm_plan``'s plain version up to the order of the sums."""
    buckets = plan_buckets(plan)
    table = work.table.cpu().numpy()
    out = torch.full((work.n_ell_rows, x.shape[1]), float("nan"), dtype=torch.float32,
                     device=x.device)
    for b, r0, n in work.units.cpu().numpy().tolist():
        cols, vals, off = buckets[b]
        c, v = cols[r0:r0 + n].long(), vals[r0:r0 + n]
        keep = v != 0
        rows = torch.arange(n, device=x.device)[:, None].expand_as(c)[keep]
        part = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
        part.index_add_(0, rows, x.index_select(0, c[keep] + off) * v[keep][:, None])
        dst = int(table[b, 5]) + r0
        if not bool(torch.isnan(out[dst:dst + n]).all()):
            raise AssertionError(f"unit ({b}, {r0}, {n}) writes a row twice")
        out[dst:dst + n] = part
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


def _gather_cpu(table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    gather_rows_torch(table, idx, out)


def _gather_cuda(table, idx, out) -> None:
    dev = same_device(table, idx, out)
    M, d = idx.shape[0], table.shape[1]
    if M == 0 or d == 0:
        return
    lib = _lib()
    rc = lib.ofs_gather_rows(idx.data_ptr(), table.data_ptr(), out.data_ptr(),
                             M, table.shape[0], d, dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1


def _gather_fake(table, idx, out) -> None:
    return None


# ofs::gather_rows(Tensor table, Tensor idx, Tensor(a!) out) -> ()
_gather_op = library.define("gather_rows", _gather_cpu, _gather_cuda, _gather_fake,
                            mutates_args=("out",))


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` for float32 ``table`` (rows, d) and int32
    ``idx`` (M,); an index outside [0, rows) gives a zero row. Through
    ``torch.ops.ofs.gather_rows``: on the card this launches the kernel;
    on the CPU it runs ``gather_rows_torch``."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows runs on cuda or cpu tensors, got {dev}")
    _gather_op(table, idx, out)
    return out
