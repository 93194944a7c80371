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
    ``reorder`` (the JAX package's locality relabeling) is not ported yet.
    ``keep_coo=False`` keeps empty COO arrays (spmm-only use: the edge-list
    ops then raise).
    """
    device = resolve_device(device)
    if reorder:
        raise NotImplementedError(
            "make_operator(reorder=...) is not ported yet: ROADMAP.md Queue 1 item 7 "
            "(locality reorder)")
    if layout not in ("auto", "binned", "tiered", *_ENGINES):
        raise ValueError(f"layout must be auto|binned|tiered|{'|'.join(_ENGINES)}, "
                         f"got {layout!r}")
    csr = CSR.from_coo(a) if isinstance(a, COO) else a
    coo = csr.to_coo()
    if not keep_coo:
        coo = COO.from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.float32), csr.shape)
    pattern = dict(coo_rows=coo.rows, coo_cols=coo.cols, coo_vals=coo.vals, nnz=csr.nnz)
    if layout in _ENGINES:
        build = _ENGINES[layout]
        plan = build(csr)
        if csr.shape[0] == csr.shape[1] and _is_symmetric(csr):
            plan_t = plan
        else:
            plan_t = build(csr.transpose())
        return place_operator(SpmmOperator(binned=plan, binned_t=plan_t, shape=csr.shape,
                                           **pattern), device)
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
