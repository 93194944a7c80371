"""The SpMM operator and the differentiable sparse ops.

``make_operator`` builds the plan of A (and of A^T, aliased when A is
symmetric) on the host and places it on a device; ``spmm`` runs Y = A @ X
through it. ``impl`` picks the engine: ``"cuda"`` the hand-written kernels
(ops/cuda/spmm.py for the binned and tiered layouts, ops/cuda/panels.py,
ops/cuda/fused.py, ops/cuda/ranges.py and ops/cuda/expansion.py for the
panel, fused, ranges and expansion engines), ``"torch"`` the plain
versions (ops/reference.py, ``panel_spmm_torch``, ``fused_spmm_torch``,
``ranges_spmm_torch``, ``expansion_spmm_torch``), ``"auto"`` the kernels
for tensors on the card and the plain versions for tensors on the CPU.

Autograd follows the JAX package's pairing:

- ``gather`` / ``segment_sum`` differentiate into each other (indices get
  no gradient);
- ``spmm(op, x)`` differentiates into the *same* engine run on the
  transpose plan built at plan time (``op.binned_t`` with its work list
  ``op.work_t``): no runtime transposition, no atomics beyond the
  forward kernel's own. The plan arrays get no gradient; edge-weight
  training goes through ``sddmm`` / ``spmm_coo`` on the operator's COO
  pattern instead.

SpGEMM (C = A @ B) is two-phase: ``spgemm_symbolic`` (and its padded and
product forms) fixes C's pattern on the host; ``spgemm_numeric`` (and its
forms) computes the values on the device in differentiable PyTorch ops;
``spgemm_device`` runs both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from of_spmm_tpu_torch.ops import reference as ref
from of_spmm_tpu_torch.ops.cuda.expansion import expansion_spmm, expansion_spmm_torch, place_plan
from of_spmm_tpu_torch.ops.cuda.fused import fused_spmm, fused_spmm_torch
from of_spmm_tpu_torch.ops.cuda.panels import panel_spmm, panel_spmm_torch
from of_spmm_tpu_torch.ops.cuda.ranges import ranges_spmm, ranges_spmm_torch
from of_spmm_tpu_torch.ops.cuda.spmm import bucket_spmm_plan, bucket_work, gather_rows
from of_spmm_tpu_torch.sparse.binned import BinnedEll, bin_rows, bin_rows_relabeled
from of_spmm_tpu_torch.sparse.expansion import ExpansionPlan, build_expansion_plan
from of_spmm_tpu_torch.sparse import staged_windows
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.fused import FusedPlan, build_fused_plan
from of_spmm_tpu_torch.sparse.panels import PanelPlan, attach_windows, build_panels_plan, ensure_masks
from of_spmm_tpu_torch.sparse.ranges import RangesPlan, build_ranges_plan
from of_spmm_tpu_torch.sparse.reorder import reorder_locality
from of_spmm_tpu_torch.sparse.tiled import DEFAULT_TIER_SIZE, TieredEll, bin_rows_tiered
from of_spmm_tpu_torch.utils.config import FLAGS
from of_spmm_tpu_torch.utils.device import place_arrays, resolve_device


# ---------------------------------------------------------------------------
# The differentiable gather / segment_sum pair.
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, indices):
        ctx.save_for_backward(indices)
        ctx.n = params.shape[0]
        return ref.gather(params, indices)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return ref.segment_sum(g, indices, ctx.n), None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return ref.segment_sum(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return ref.gather(g, segment_ids), None, None


def gather(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Differentiable row gather (axis 0; out of range -> a zero row); its
    backward is segment_sum of the cotangent over ``indices``."""
    return _Gather.apply(params, torch.as_tensor(indices, device=params.device))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """Differentiable unsorted segment sum (out-of-range ids dropped); its
    backward is gather."""
    return _SegmentSum.apply(data, torch.as_tensor(segment_ids, device=data.device),
                             int(num_segments))


# ---------------------------------------------------------------------------
# SpmmOperator: the plan object bundling forward and transpose layouts.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpmmOperator:
    """A sparse matrix prepared for repeated (differentiable) SpMM.

    Holds the forward plan (``binned``: a BinnedEll, TieredEll,
    PanelPlan, FusedPlan, RangesPlan or ExpansionPlan), the transpose
    plan built once at plan time, and the COO pattern in node space and
    CSR order (for ``spmv``, ``sddmm`` and GAT's ``spmm_coo``; empty
    with ``keep_coo=False``). ``op @ x`` computes A @ x in node space;
    its backward runs A^T @ g through the same engine on ``binned_t``.
    """

    binned: Any  # BinnedEll | TieredEll | PanelPlan | FusedPlan | RangesPlan | ExpansionPlan
    binned_t: Any
    shape: Tuple[int, int]
    coo_rows: Any = None  # (nnz,) int32
    coo_cols: Any = None  # (nnz,) int32
    coo_vals: Any = None  # (nnz,) float32
    nnz: int = 0
    # relabeling (square binned plans): the plans live in an internal row
    # order chosen for a slice-concat finish; None = identity.
    old_from_new: Any = None  # x_int = x[old_from_new]
    new_from_old: Any = None  # y = y_int[new_from_old]
    # binned and tiered plans: the bucket kernel's work list of each plan
    # (ops/cuda/spmm.py BucketWork), built by place_operator; None = built
    # per call
    work: Any = None
    work_t: Any = None

    @property
    def relabeled(self) -> bool:
        return self.old_from_new is not None

    @property
    def transpose_aliased(self) -> bool:
        """True when the transpose plan shares the forward plan's arrays
        (symmetric matrices)."""
        if self.binned_t is self.binned:
            return True
        a = next(_arrays(self.binned), None)
        b = next(_arrays(self.binned_t), None)
        return a is not None and a is b

    def to_internal(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Map node-space data into the operator's internal row order."""
        if self.old_from_new is None:
            return a
        return a.index_select(axis, self.old_from_new)

    def from_internal(self, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Map internal-order results back to node space."""
        if self.new_from_old is None:
            return a
        return a.index_select(axis, self.new_from_old)

    @property
    def T(self) -> "SpmmOperator":
        return dataclasses.replace(
            self, binned=self.binned_t, binned_t=self.binned,
            shape=(self.shape[1], self.shape[0]),
            coo_rows=self.coo_cols, coo_cols=self.coo_rows,
            work=self.work_t, work_t=self.work,
        )

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return spmm(self, x)


def _arrays(obj):
    """The array leaves of a plan, depth first."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _arrays(getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for o in obj:
            yield from _arrays(o)


def _is_symmetric(csr: CSR) -> bool:
    """Exact pattern and value symmetry (host-side, plan time)."""
    t = csr.transpose()
    if t.nnz != csr.nnz:
        return False
    return (
        np.array_equal(np.asarray(t.indptr), np.asarray(csr.indptr))
        and np.array_equal(t.cols, csr.cols)
        and np.array_equal(t.vals, csr.vals)
    )


def make_operator(
    a: CSR | COO,
    ladder="auto",
    relabel: Optional[bool] = None,
    layout: str = "auto",
    tier_size: Optional[int] = None,
    device=None,
    reorder=None,
    keep_coo: bool = True,
) -> SpmmOperator:
    """Build the plan of A and A^T on the host and place it on ``device``.

    ``layout``: "binned" (row-binned ELL; square matrices are relabeled so
    the finish is a slice-concat), "tiered" (column-tiered ELL,
    sparse/tiled.py), "panels" (the panel engine, sparse/panels.py: the
    rank-1 plan, or the per-edge plan when the values do not factor),
    "fused" (sparse/fused.py), "ranges" (sparse/ranges.py), "expansion"
    (sparse/expansion.py), or "auto"
    (tiered iff n_cols > tier_size, as in the JAX package). Engine layouts
    alias the transpose plan for symmetric matrices.
    ``device=None`` means the card, and raises when there is none.
    ``reorder`` ("match", "lp", "bfs", "identity"; True means "match"):
    on the panels, fused and ranges layouts, plan the locality-relabeled
    P A P^T (sparse/reorder.py) and carry the permutation on the operator
    (``old_from_new`` / ``new_from_old``), so ``spmm`` and the models stay
    in node space. Other layouts raise ``ValueError`` (the JAX package
    ignores ``reorder`` there).
    ``keep_coo=False`` keeps empty COO arrays (spmm-only use: the edge-list
    ops then raise).
    """
    device = resolve_device(device)
    if layout not in ("auto", "binned", "tiered", *_ENGINES):
        raise ValueError(f"layout must be auto|binned|tiered|{'|'.join(_ENGINES)}, "
                         f"got {layout!r}")
    if reorder and layout not in _REORDER_LAYOUTS:
        raise ValueError(f"reorder={reorder!r} applies to layout "
                         f"{'|'.join(_REORDER_LAYOUTS)}, got layout={layout!r}")
    csr = CSR.from_coo(a) if isinstance(a, COO) else a
    coo = csr.to_coo()
    if not keep_coo:
        coo = COO.from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.float32), csr.shape)
    pattern = dict(coo_rows=coo.rows, coo_cols=coo.cols, coo_vals=coo.vals, nnz=csr.nnz)
    if layout in _ENGINES:
        build = _ENGINES[layout]
        pcsr, ofn, nfo = csr, None, None
        if reorder:
            # the plans live in cluster-contiguous internal ids; the
            # operator maps node-space tensors at its boundary
            pcsr, ofn, nfo = reorder_locality(csr, method=reorder)
        plan = build(pcsr)
        if pcsr.shape[0] == pcsr.shape[1] and _is_symmetric(pcsr):
            plan_t = plan
        else:
            plan_t = build(pcsr.transpose())
        return place_operator(SpmmOperator(binned=plan, binned_t=plan_t, shape=csr.shape,
                                           old_from_new=ofn, new_from_old=nfo, **pattern),
                              device)
    max_width = int(FLAGS.get("OFS_MAX_ELL_WIDTH"))
    ts = tier_size or DEFAULT_TIER_SIZE
    if layout == "auto":
        layout = "tiered" if csr.shape[1] > ts else "binned"
    square = csr.shape[0] == csr.shape[1]
    ofn = nfo = None

    if layout == "tiered":
        plan = bin_rows_tiered(csr, tier_size=ts, ladder=ladder, max_width=max_width)
        if square and _is_symmetric(csr):
            plan_t = plan
        else:
            plan_t = bin_rows_tiered(csr.transpose(), tier_size=ts, ladder=ladder,
                                     max_width=max_width)
    else:
        if relabel is None:
            relabel = square
        if relabel and not square:
            raise ValueError("relabel=True requires a square matrix")
        if relabel:
            plan, ofn, nfo = bin_rows_relabeled(csr, ladder=ladder, max_width=max_width)
            if _is_symmetric(csr):
                plan_t = plan
            else:
                # transpose of the relabeled matrix, so the spaces line up
                rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
                relabeled_t = CSR.from_coo(
                    COO.from_arrays(nfo[csr.cols], nfo[rows], csr.vals, csr.shape))
                plan_t = bin_rows(relabeled_t, ladder=ladder, max_width=max_width)
        else:
            plan = bin_rows(csr, ladder=ladder, max_width=max_width)
            plan_t = bin_rows(csr.transpose(), ladder=ladder, max_width=max_width)
    return place_operator(SpmmOperator(
        binned=plan, binned_t=plan_t, shape=csr.shape, old_from_new=ofn, new_from_old=nfo,
        **pattern), device)


def _build_panels(csr: CSR) -> PanelPlan:
    """The rank-1 panel plan, or the per-edge plan when the values do not
    factor (as the JAX package's make_operator falls back)."""
    try:
        return build_panels_plan(csr)
    except ValueError:
        return build_panels_plan(csr, per_edge=True)


# layouts whose plan is the engine: the builder of each
_ENGINES = {"panels": _build_panels, "fused": build_fused_plan, "ranges": build_ranges_plan,
            "expansion": build_expansion_plan}
# layouts that take make_operator(reorder=...)
_REORDER_LAYOUTS = ("panels", "fused", "ranges")


def place_operator(op: SpmmOperator, device) -> SpmmOperator:
    """Move every array of an operator to ``device`` as a torch tensor,
    preserving sharing: an aliased transpose plan (symmetric matrices)
    and any array referenced twice are copied once.

    Engine plans first get their provenance on the host (panels:
    sparse/panels.py attach_windows, which panel plans follow by expanding
    their compact masks on ``device`` with one scatter-add; fused and
    ranges: sparse/staged_windows.py attach_windows; expansion:
    ops/cuda/expansion.py place_plan, each group's ``stage_row`` and the
    plan's work list). Binned and tiered plans get the bucket kernel's
    work list once their arrays are on ``device`` (ops/cuda/spmm.py
    bucket_work)."""
    device = torch.device(device)
    if isinstance(op.binned, (PanelPlan, FusedPlan, RangesPlan, ExpansionPlan)):
        ready = {}
        for p in (op.binned, op.binned_t):
            if id(p) in ready:
                continue
            if isinstance(p, PanelPlan):
                ready[id(p)] = ensure_masks(attach_windows(p), device)
            elif isinstance(p, ExpansionPlan):
                ready[id(p)] = place_plan(p, device)
            else:
                ready[id(p)] = staged_windows.attach_windows(p)
        op = dataclasses.replace(op, binned=ready[id(op.binned)],
                                 binned_t=ready[id(op.binned_t)])
    op = place_arrays(dataclasses.replace(op, work=None, work_t=None), device)
    if isinstance(op.binned, (BinnedEll, TieredEll)):
        work = bucket_work(op.binned)
        op = dataclasses.replace(op, work=work, work_t=work if op.binned_t is op.binned
                                 else bucket_work(op.binned_t))
    return op


def _select_impl(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown spmm impl {impl!r} (want auto|torch|cuda)")
    return impl


def _spmm_binned_kernels(binned: BinnedEll, x: torch.Tensor, work=None) -> torch.Tensor:
    """Every bucket through one launch of the bucket kernel, then the
    plan's finish (its gather through the gather kernel)."""
    if not binned.buckets:
        return torch.zeros((binned.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    xa = x.to(torch.float32).contiguous()
    cat = bucket_spmm_plan(binned, xa, work)
    bounds = np.cumsum([0] + [b.n_ell_rows for b in binned.buckets]).tolist()
    contribs = [cat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    out = ref.combine_contribs(binned, contribs, torch.float32, gather_fn=gather_rows, cat=cat)
    return out.to(x.dtype)


def _spmm_impl(plan, x: torch.Tensor, impl: str, work=None) -> torch.Tensor:
    for plan_type, kernel, plain in ((PanelPlan, panel_spmm, panel_spmm_torch),
                                     (FusedPlan, fused_spmm, fused_spmm_torch),
                                     (RangesPlan, ranges_spmm, ranges_spmm_torch),
                                     (ExpansionPlan, expansion_spmm, expansion_spmm_torch)):
        if isinstance(plan, plan_type):
            xa = x.to(torch.float32).contiguous()
            return (kernel if impl == "cuda" else plain)(plan, xa).to(x.dtype)
    if isinstance(plan, TieredEll):
        if impl == "cuda":
            return ref.spmm_tiered(plan, x, buckets_fn=lambda p, xa: bucket_spmm_plan(p, xa, work),
                                   gather_fn=gather_rows)
        return ref.spmm_tiered(plan, x)
    if impl == "cuda":
        return _spmm_binned_kernels(plan, x, work)
    return ref.spmm_binned(plan, x)


class _SpmmFunction(torch.autograd.Function):
    """Y = A @ X through the forward plan; dX = A^T @ dY through the same
    engine on the transpose plan. The plan is data, not an input: it gets
    no gradient (the JAX package's zero cotangents)."""

    @staticmethod
    def forward(ctx, x, op, impl):
        ctx.op, ctx.impl = op, impl
        return _spmm_impl(op.binned, x, impl, op.work)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        op = ctx.op
        return _spmm_impl(op.binned_t, g.contiguous(), ctx.impl, op.work_t), None, None


def spmm_internal(op: SpmmOperator, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Y = A @ X in the operator's internal row order (no conversions).

    For relabeled operators the caller supplies x = op.to_internal(x0) and
    maps results back with op.from_internal; models do this once per
    forward instead of once per SpMM. Differentiable in x: the backward
    is A^T @ dY on ``op.binned_t``.
    """
    return _SpmmFunction.apply(x, op, _select_impl(impl, x))


def spmm(op: SpmmOperator, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Differentiable Y = A @ X in node space (relabeled operators map x in
    and y out with index_select, whose own backward carries the
    permutation)."""
    if op.relabeled:
        return op.from_internal(spmm_internal(op, op.to_internal(x), impl))
    return spmm_internal(op, x, impl)


# ---------------------------------------------------------------------------
# Edge-list ops over the operator's COO pattern (plain PyTorch, as the JAX
# package's are plain XLA).
# ---------------------------------------------------------------------------


def _require_coo(op: SpmmOperator, what: str) -> None:
    if op.coo_rows is None or (op.coo_rows.shape[0] == 0 and op.nnz > 0):
        raise ValueError(f"{what} needs the COO pattern, but this operator was built "
                         "with keep_coo=False (spmm-only)")


def spmv(op: SpmmOperator, x: torch.Tensor) -> torch.Tensor:
    """Differentiable y = A @ x for a vector x, through the gather /
    segment_sum pair."""
    _require_coo(op, "spmv")
    contrib = op.coo_vals * gather(x, op.coo_cols)
    return segment_sum(contrib, op.coo_rows, op.shape[0])


def sddmm(op: SpmmOperator, lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Pattern-restricted lhs @ rhs^T: out[e] = lhs[rows[e]] . rhs[cols[e]];
    differentiable in lhs and rhs."""
    _require_coo(op, "sddmm")
    return torch.sum(gather(lhs, op.coo_rows) * gather(rhs, op.coo_cols), dim=-1)


def spmm_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """Y = A @ X for a COO pattern whose values are computed at run time
    (GAT's attention weights): differentiable in both vals and x."""
    return segment_sum(vals[:, None] * gather(x, cols), rows, n_rows)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                    ) -> torch.Tensor:
    """Softmax over each segment (per destination row of an edge list),
    stabilised by the per-segment max taken without gradient. An empty
    segment's max is 0; the sum gets 1e-16, as in the JAX package."""
    ids = torch.as_tensor(segment_ids, device=scores.device).long()
    s = scores.detach()
    valid = (ids >= 0) & (ids < num_segments)
    idx = ids[valid].reshape((-1,) + (1,) * (s.dim() - 1)).expand_as(s[valid])
    seg_max = torch.full((num_segments,) + tuple(s.shape[1:]), float("-inf"), dtype=s.dtype,
                         device=s.device)
    seg_max.scatter_reduce_(0, idx, s[valid], "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros((), dtype=s.dtype,
                                                                         device=s.device))
    ex = torch.exp(scores - ref.gather(seg_max, ids))
    denom = segment_sum(ex, ids, num_segments)
    return ex / (gather(denom, ids) + 1e-16)


# ---------------------------------------------------------------------------
# SpGEMM: the symbolic phase on the host, the numeric phase on the device.
# C's pattern is fixed before any value is computed; the numeric phase is
# then gathers, a multiply and a sum over fixed slots, in differentiable
# PyTorch ops (as the JAX package's are XLA ops).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Symbolic phase of C = A @ B: C's pattern and, per scalar product
    a_ik * b_kj, the positions of its operands and its output slot.

    ``a_pos`` / ``b_pos`` / ``out_slot`` are numpy int32 from
    ``spgemm_symbolic`` and tensors after ``place_spgemm_plan``; C's
    pattern (``indptr``, ``cols``) stays on the host."""

    a_pos: Any             # (P,) int32 index into A.vals
    b_pos: Any             # (P,) int32 index into B.vals
    out_slot: Any          # (P,) int32 index into C.vals (row-major)
    indptr: np.ndarray     # (n+1,) C row pointers
    cols: np.ndarray       # (out_nnz,) C column indices
    shape: Tuple[int, int]
    out_nnz: int


def spgemm_symbolic(a: CSR, b: CSR) -> SpgemmPlan:
    """Expand the product structure and fix C's pattern (host, numpy)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {a.shape} @ {b.shape}")
    a_indptr = np.asarray(a.indptr).astype(np.int64)
    a_cols = np.asarray(a.cols).astype(np.int64)
    b_indptr = np.asarray(b.indptr).astype(np.int64)
    b_cols = np.asarray(b.cols).astype(np.int64)

    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a_indptr))
    exp_counts = (b_indptr[a_cols + 1] - b_indptr[a_cols]).astype(np.int64)
    total = int(exp_counts.sum())
    if total == 0:
        return SpgemmPlan(
            a_pos=np.zeros(0, np.int32), b_pos=np.zeros(0, np.int32),
            out_slot=np.zeros(0, np.int32), indptr=np.zeros(a.shape[0] + 1, np.int64),
            cols=np.zeros(0, np.int32), shape=(a.shape[0], b.shape[1]), out_nnz=0)
    e_ids = np.repeat(np.arange(a_cols.shape[0], dtype=np.int64), exp_counts)
    cum = np.zeros(a_cols.shape[0] + 1, dtype=np.int64)
    np.cumsum(exp_counts, out=cum[1:])
    intra = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], exp_counts)
    b_pos = b_indptr[a_cols[e_ids]] + intra
    out_rows = a_rows[e_ids]
    out_cols = b_cols[b_pos]

    key = out_rows * b.shape[1] + out_cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    boundary[1:] = key_s[1:] != key_s[:-1]
    slot_sorted = np.cumsum(boundary) - 1
    out_nnz = int(slot_sorted[-1]) + 1
    out_slot = np.empty(total, np.int64)
    out_slot[order] = slot_sorted

    red_rows = out_rows[order][boundary]
    red_cols = out_cols[order][boundary]
    counts = np.bincount(red_rows, minlength=a.shape[0])
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return SpgemmPlan(
        a_pos=e_ids.astype(np.int32), b_pos=b_pos.astype(np.int32),
        out_slot=out_slot.astype(np.int32), indptr=indptr, cols=red_cols.astype(np.int32),
        shape=(a.shape[0], b.shape[1]), out_nnz=out_nnz)


def _plan_index(idx, vals: torch.Tensor) -> torch.Tensor:
    """A plan's index array as a tensor beside ``vals``; a numpy array is
    taken as a CPU tensor, and a plan on another device raises."""
    t = torch.as_tensor(idx)
    if t.device != vals.device:
        raise ValueError(f"the SpGEMM plan is on {t.device} and the values on {vals.device}: "
                         "place the plan with place_spgemm_plan")
    return t


def _no_products(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """The empty result of a product without terms, still a function of
    both value arrays (their gradients are zeros, not missing)."""
    return a_vals[:0] * b_vals[:0].sum()


def spgemm_numeric(a_pos, b_pos, out_slot, a_vals: torch.Tensor, b_vals: torch.Tensor,
                   out_nnz: int) -> torch.Tensor:
    """Numeric phase over a SpgemmPlan: gather both operand values,
    multiply, and sum into C's fixed slots (``index_add``). Differentiable
    in both value arrays."""
    prod = (a_vals.index_select(0, _plan_index(a_pos, a_vals))
            * b_vals.index_select(0, _plan_index(b_pos, b_vals)))
    out = torch.zeros(int(out_nnz), dtype=prod.dtype, device=prod.device)
    return out.index_add(0, _plan_index(out_slot, prod), prod)


@dataclasses.dataclass(frozen=True)
class PaddedSpgemmPlan:
    """Bucket-padded numeric plan: each output slot's products laid out as
    one row of a (n_b, w) index matrix of its width bucket, so the device
    phase is gathers from the two value tables and one sum along the
    padded width, with no scatter. Pads point at a zero appended to each
    value table.

    C's pattern is COO in bucket-major order (``rows`` / ``cols``, host);
    a slot wider than ``max_width`` is split into several rows with the
    same (row, col), which a consumer sums."""

    buckets: Tuple         # ((w, pa (n_b, w) int32, pb (n_b, w) int32), ...)
    rows: np.ndarray       # (out_nnz,) bucket-major COO rows
    cols: np.ndarray       # (out_nnz,) bucket-major COO cols
    shape: Tuple[int, int]
    out_nnz: int
    n_products: int


def spgemm_symbolic_padded(a: CSR, b: CSR, max_width: int = 512) -> PaddedSpgemmPlan:
    """Bucket-padded symbolic phase on spgemm_symbolic's expansion.

    Slots are bucketed by the next power of two of their product count;
    slots wider than ``max_width`` (a power of two) are split into
    max_width-wide partial rows."""
    if max_width < 1 or max_width & (max_width - 1):
        # the doubling ladder ends at the largest power of two <= max_width:
        # any other cap would leave some slots in no bucket
        raise ValueError(f"max_width must be a power of two, got {max_width}")
    base = spgemm_symbolic(a, b)
    P = int(base.a_pos.shape[0])
    slot = np.asarray(base.out_slot, np.int64)
    order = np.argsort(slot, kind="stable")
    pa_s = np.asarray(base.a_pos, np.int64)[order]
    pb_s = np.asarray(base.b_pos, np.int64)[order]
    slot_s = slot[order]
    counts = np.bincount(slot_s, minlength=base.out_nnz)
    starts = np.zeros(base.out_nnz + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rows_of_slot = np.repeat(np.arange(base.shape[0], dtype=np.int64), np.diff(base.indptr))
    pad_a = int(np.asarray(a.vals).shape[0])  # the appended zero's position
    pad_b = int(np.asarray(b.vals).shape[0])
    buckets = []
    all_rows = []
    all_cols = []
    w = 1
    while w <= max_width:
        sel = np.nonzero((counts <= w) & (counts > w // 2))[0]
        if sel.shape[0]:
            idx = starts[sel][:, None] + np.arange(w)[None, :]
            valid = np.arange(w)[None, :] < counts[sel][:, None]
            pa = np.where(valid, pa_s[np.minimum(idx, P - 1)], pad_a)
            pb = np.where(valid, pb_s[np.minimum(idx, P - 1)], pad_b)
            buckets.append((w, pa.astype(np.int32), pb.astype(np.int32)))
            all_rows.append(rows_of_slot[sel])
            all_cols.append(np.asarray(base.cols, np.int64)[sel])
        w *= 2
    # giant slots (> max_width): split into max_width-wide partial rows
    big = np.nonzero(counts > max_width)[0]
    if big.shape[0]:
        pa_rows, pb_rows, r_rows, c_rows = [], [], [], []
        for s in big:
            cnt = int(counts[s])
            n_part = -(-cnt // max_width)
            idx = (starts[s] + np.arange(n_part * max_width)).reshape(n_part, max_width)
            valid = idx < starts[s] + cnt
            pa_rows.append(np.where(valid, pa_s[np.minimum(idx, P - 1)], pad_a))
            pb_rows.append(np.where(valid, pb_s[np.minimum(idx, P - 1)], pad_b))
            r_rows.append(np.full(n_part, rows_of_slot[s]))
            c_rows.append(np.full(n_part, base.cols[s]))
        buckets.append((max_width, np.concatenate(pa_rows).astype(np.int32),
                        np.concatenate(pb_rows).astype(np.int32)))
        all_rows.append(np.concatenate(r_rows))
        all_cols.append(np.concatenate(c_rows))
    rows = (np.concatenate(all_rows) if all_rows else np.zeros(0, np.int64)).astype(np.int32)
    cols = (np.concatenate(all_cols) if all_cols else np.zeros(0, np.int64)).astype(np.int32)
    return PaddedSpgemmPlan(buckets=tuple(buckets), rows=rows, cols=cols, shape=base.shape,
                            out_nnz=int(rows.shape[0]), n_products=P)


def spgemm_numeric_padded(buckets, a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """Numeric phase over a PaddedSpgemmPlan's buckets: per bucket, gather
    both operands from the value tables (a zero appended to each), multiply
    and sum along the padded width. Differentiable in both value arrays."""
    av = torch.cat([a_vals, a_vals.new_zeros(1)])
    bv = torch.cat([b_vals, b_vals.new_zeros(1)])
    parts = []
    for (_w, pa, pb) in buckets:
        pa, pb = _plan_index(pa, av), _plan_index(pb, bv)
        prod = (av.index_select(0, pa.reshape(-1)) * bv.index_select(0, pb.reshape(-1)))
        parts.append(prod.reshape(pa.shape).sum(dim=1))
    if not parts:  # A @ B with no products
        return _no_products(a_vals, b_vals)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


@dataclasses.dataclass(frozen=True)
class ProductSpgemmPlan:
    """Product-form numeric plan: C in product order, as COO with
    duplicates (the merge moves to the consumer; the SpMM plans accept
    duplicate entries).

      per B-width bucket c:  prod_c = a_stream[lo:hi, None] * b_ell_c[brow_ids]

    The A side is one nnz_A-element permutation gather and contiguous
    slices; the B side is row gathers from B's ELL-padded value table.
    Pad products are explicit zeros at (the edge's row, a valid column).
    """

    a_perm: Any                    # (nnz_A + split repeats,) int32: A edges in stream order
    ell_idx: Any                   # (ell elements,) int32 into b_vals (+ the pad)
    ell_ptr: Tuple[int, ...]       # each bucket's offset into the ell table
    buckets: Tuple                 # ((W, e_lo, e_hi, brow_ids), ...)
    rows: np.ndarray               # (n_out,) int32 COO rows (with duplicates)
    cols: np.ndarray               # (n_out,) int32 COO cols (with duplicates)
    shape: Tuple[int, int]
    n_products: int                # true (unpadded) product count
    n_out: int                     # emitted entries, pad zeros included


def spgemm_symbolic_products(a: CSR, b: CSR, ladder=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
                             ) -> ProductSpgemmPlan:
    """Host symbolic phase of the product form: B's rows bucketed by the
    next ladder width, each A edge (i, k) in the bucket of B's row k; rows
    wider than the ladder's top are split into top-wide slabs, the A edge
    repeated once per slab."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {a.shape} @ {b.shape}")
    a_indptr = np.asarray(a.indptr, np.int64)
    a_cols = np.asarray(a.cols, np.int64)
    b_indptr = np.asarray(b.indptr, np.int64)
    b_cols = np.asarray(b.cols, np.int64)
    nnz_b = b_cols.shape[0]
    m = b.shape[0]
    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a_indptr))
    b_deg = np.diff(b_indptr)
    ladder = tuple(sorted(set(int(w) for w in ladder)))
    wmax = ladder[-1]
    # width class per B row (rows of degree 0 make no products); rows
    # wider than wmax get class len(ladder)
    wclass = np.searchsorted(ladder, np.minimum(np.maximum(b_deg, 1), wmax))
    wclass[b_deg > wmax] = len(ladder)
    a_perm_parts, bucket_descs = [], []
    ell_parts, ell_ptr = [], [0]
    rows_parts, cols_parts = [], []
    e_lo = 0
    n_products = 0
    for c, W in enumerate(ladder):
        rows_c = np.nonzero((wclass == c) & (b_deg > 0))[0]
        edges_c = np.nonzero((wclass[a_cols] == c) & (b_deg[a_cols] > 0))[0]
        if rows_c.shape[0] == 0 or edges_c.shape[0] == 0:
            continue  # rows no edge references need no table
        # this bucket's ELL slab: (len(rows_c), W) positions into b_vals,
        # padded with nnz_b (the appended zero)
        base = b_indptr[rows_c][:, None] + np.arange(W)[None, :]
        valid = np.arange(W)[None, :] < b_deg[rows_c][:, None]
        ell = np.where(valid, np.minimum(base, nnz_b - 1), nnz_b)
        ell_parts.append(ell.astype(np.int32).ravel())
        # each B row's rank within the slab
        rank = np.full(m, -1, np.int64)
        rank[rows_c] = np.arange(rows_c.shape[0])
        a_perm_parts.append(edges_c.astype(np.int32))
        brow_ids = rank[a_cols[edges_c]].astype(np.int32)
        e_hi = e_lo + edges_c.shape[0]
        bucket_descs.append((W, e_lo, e_hi, brow_ids))
        # output coordinates in product order; pads at (the edge's row,
        # a valid column) with an explicit zero value
        pos = ell[brow_ids].reshape(-1)
        oc = b_cols[np.minimum(pos, max(nnz_b - 1, 0))]
        orow = np.repeat(a_rows[edges_c], W)
        rows_parts.append(orow.astype(np.int32))
        cols_parts.append(oc.astype(np.int32))
        n_products += int(b_deg[a_cols[edges_c]].sum())
        e_lo = e_hi
        ell_ptr.append(ell_ptr[-1] + rows_c.shape[0] * W)
    # the big class: B rows wider than wmax, split into wmax-wide parts
    big_rows = np.nonzero(b_deg > wmax)[0]
    edges_big = np.nonzero(b_deg[a_cols] > wmax)[0]
    if big_rows.shape[0] and edges_big.shape[0]:
        W = wmax
        n_part = (-(-b_deg[big_rows] // W)).astype(np.int64)
        tot_parts = int(n_part.sum())
        part_owner = np.repeat(big_rows, n_part)
        part_first = np.cumsum(n_part) - n_part
        within = np.arange(tot_parts, dtype=np.int64) - np.repeat(part_first, n_part)
        off = within[:, None] * W + np.arange(W)[None, :]
        base = b_indptr[part_owner][:, None] + off
        valid = off < b_deg[part_owner][:, None]
        ell = np.where(valid, np.minimum(base, nnz_b - 1), nnz_b)
        ell_parts.append(ell.astype(np.int32).ravel())
        part_base = np.full(m, -1, np.int64)
        part_base[big_rows] = part_first
        n_part_of = np.zeros(m, np.int64)
        n_part_of[big_rows] = n_part
        rep = n_part_of[a_cols[edges_big]]  # parts per edge
        a_perm_big = np.repeat(edges_big, rep)
        e_first = np.cumsum(rep) - rep
        within_e = np.arange(int(rep.sum()), dtype=np.int64) - np.repeat(e_first, rep)
        brow_ids = (np.repeat(part_base[a_cols[edges_big]], rep) + within_e).astype(np.int32)
        a_perm_parts.append(a_perm_big.astype(np.int32))
        e_hi = e_lo + a_perm_big.shape[0]
        bucket_descs.append((W, e_lo, e_hi, brow_ids))
        pos = ell[brow_ids].reshape(-1)
        oc = b_cols[np.minimum(pos, max(nnz_b - 1, 0))]
        orow = np.repeat(a_rows[a_perm_big], W)
        rows_parts.append(orow.astype(np.int32))
        cols_parts.append(oc.astype(np.int32))
        n_products += int(b_deg[a_cols[edges_big]].sum())
        e_lo = e_hi
        ell_ptr.append(ell_ptr[-1] + tot_parts * W)
    a_perm = np.concatenate(a_perm_parts) if a_perm_parts else np.zeros(0, np.int32)
    return ProductSpgemmPlan(
        a_perm=a_perm,
        ell_idx=np.concatenate(ell_parts) if ell_parts else np.zeros(0, np.int32),
        ell_ptr=tuple(ell_ptr),
        buckets=tuple(bucket_descs),
        rows=np.concatenate(rows_parts) if rows_parts else np.zeros(0, np.int32),
        cols=np.concatenate(cols_parts) if cols_parts else np.zeros(0, np.int32),
        shape=(a.shape[0], b.shape[1]),
        n_products=int(n_products),
        n_out=int(sum((hi - lo) * W for (W, lo, hi, _) in bucket_descs)),
    )


def spgemm_numeric_products(plan: ProductSpgemmPlan, a_vals: torch.Tensor,
                            b_vals: torch.Tensor) -> torch.Tensor:
    """Numeric phase in product order: values aligned with ``plan.rows`` /
    ``plan.cols`` (duplicates unmerged, pads exact zeros). Differentiable
    in both value arrays."""
    bv = torch.cat([b_vals, b_vals.new_zeros(1)])
    b_ell_flat = bv.index_select(0, _plan_index(plan.ell_idx, bv))
    a_stream = a_vals.index_select(0, _plan_index(plan.a_perm, a_vals))
    outs = []
    for c, (W, lo, hi, brows) in enumerate(plan.buckets):
        slab = b_ell_flat[plan.ell_ptr[c]:plan.ell_ptr[c + 1]].reshape(-1, W)
        prod = a_stream[lo:hi, None] * slab.index_select(0, _plan_index(brows, slab))
        outs.append(prod.reshape(-1))
    if not outs:
        return _no_products(a_vals, b_vals)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


_SPGEMM_HOST_FIELDS = ("indptr", "rows", "cols")  # C's pattern: host data


def place_spgemm_plan(plan, device):
    """``plan`` (any of the three forms) with its index arrays as tensors
    on ``device``; C's pattern stays on the host. A plan already on
    ``device`` comes back without a copy."""
    host = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if f.name in _SPGEMM_HOST_FIELDS}
    placed = place_arrays(dataclasses.replace(plan, **{k: None for k in host}),
                          torch.device(device))
    return dataclasses.replace(placed, **host)


def spgemm_device(a: CSR, b: CSR, plan: Optional[SpgemmPlan] = None,
                  device=None) -> Tuple[CSR, SpgemmPlan]:
    """C = A @ B with the numeric phase on ``device`` (the card unless the
    caller names another; without a card and without a device it raises).

    Returns (C, plan), the plan placed on ``device``: pass it back to
    recompute C's values for new A / B values on the same patterns.
    C is host data, like every CSR; its values are copied back from the
    device. For values that stay on the device (and carry gradients),
    call ``spgemm_numeric`` on the placed plan."""
    device = resolve_device(device)
    if plan is None:
        plan = spgemm_symbolic(a, b)
    plan = place_spgemm_plan(plan, device)
    vals = spgemm_numeric(plan.a_pos, plan.b_pos, plan.out_slot,
                          torch.as_tensor(np.asarray(a.vals, np.float32), device=device),
                          torch.as_tensor(np.asarray(b.vals, np.float32), device=device),
                          plan.out_nnz)
    c = CSR.from_arrays(plan.indptr.astype(np.int64), plan.cols, vals.cpu().numpy(), plan.shape)
    return c, plan
