"""Plain PyTorch reference implementations: the numeric oracles.

They define the semantics the kernels are held to, the same as the JAX
package's ``of_spmm_tpu.ops.reference``:

- ``gather``: out[i, ...] = params[indices[i], ...]; an index outside
  [0, n) yields a zero row.
- ``segment_sum``: out[seg_ids[i], ...] += data[i, ...] with a fixed
  ``num_segments``; out-of-range segment ids are dropped.
- ``spmv`` / ``spmm`` over COO are segment_sum(vals * gather(x)).
- bf16 / fp16 inputs accumulate in float32.

Plans may hold numpy arrays (unplaced) or torch tensors (placed); every
function moves what it reads to the device of its dense operand.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from of_spmm_tpu_torch.sparse.binned import BinnedEll, BucketExtras, Finish
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.utils.config import FLAGS

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: float32 for low-precision inputs."""
    return torch.float32 if dtype in _LOW_PRECISION else dtype


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


# ---------------------------------------------------------------------------
# gather / segment_sum: the primitive pair.
# ---------------------------------------------------------------------------


def gather(params: torch.Tensor, indices, axis: int = 0) -> torch.Tensor:
    """Gather along ``axis`` with out-of-range -> 0 semantics (negative
    indices included: they neither wrap nor clamp)."""
    indices = _t(indices, params.device)
    n = params.shape[axis]
    valid = (indices >= 0) & (indices < n)
    safe = torch.where(valid, indices, torch.zeros_like(indices)).long()
    out = params.index_select(axis, safe.reshape(-1))
    out = out.reshape(params.shape[:axis] + indices.shape + params.shape[axis + 1:])
    mask_shape = [1] * out.dim()
    for i, s in enumerate(indices.shape):
        mask_shape[axis + i] = s
    return torch.where(valid.reshape(mask_shape), out, torch.zeros((), dtype=out.dtype,
                                                                  device=out.device))


def segment_sum(data: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """Unsorted segment sum: out[seg_ids[i], ...] += data[i, ...]; ids
    outside [0, num_segments) are dropped. float32 accumulation for
    bf16/fp16 data."""
    acc = _acc_dtype(data.dtype)
    ids = _t(segment_ids, data.device).long()
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc,
                      device=data.device)
    out.index_add_(0, ids[valid], data[valid].to(acc))
    return out.to(data.dtype)


def segment_sum_like(data: torch.Tensor, segment_ids, like: torch.Tensor) -> torch.Tensor:
    """segment_sum with the segment count taken from ``like`` (gather's
    backward)."""
    return segment_sum(data, segment_ids, like.shape[0]).to(like.dtype)


# ---------------------------------------------------------------------------
# SpMV / SpMM / SDDMM over COO and BinnedEll.
# ---------------------------------------------------------------------------

Sparse = Union[COO, CSR, BinnedEll]


def _coerce_coo(a: Sparse) -> COO:
    if isinstance(a, COO):
        return a
    if isinstance(a, CSR):
        return a.to_coo()
    raise TypeError(f"expected COO/CSR, got {type(a)}")


def _coo_on(coo: COO, device):
    return (_t(coo.rows, device).long(), _t(coo.cols, device),
            _t(coo.vals, device))


def spmv(a: Sparse, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a sparse A and a dense vector x."""
    coo = _coerce_coo(a)
    rows, cols, vals = _coo_on(coo, x.device)
    acc = _acc_dtype(torch.promote_types(vals.dtype, x.dtype))
    contrib = vals.to(acc) * gather(x.to(acc), cols)
    y = torch.zeros(coo.shape[0], dtype=acc, device=x.device).index_add_(0, rows, contrib)
    return y.to(x.dtype)


def spmm(a: Sparse, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for sparse A (n x m) and dense X (m x d): per-edge gather
    of the source row, scale by the edge value, segment-sum into the
    destination row."""
    if isinstance(a, BinnedEll):
        return spmm_binned(a, x)
    coo = _coerce_coo(a)
    rows, cols, vals = _coo_on(coo, x.device)
    acc = _acc_dtype(torch.promote_types(vals.dtype, x.dtype))
    contrib = vals.to(acc)[:, None] * gather(x.to(acc), cols)
    y = torch.zeros((coo.shape[0], x.shape[1]), dtype=acc, device=x.device)
    return y.index_add_(0, rows, contrib).to(x.dtype)


def sddmm(lhs: torch.Tensor, rhs: torch.Tensor, rows, cols) -> torch.Tensor:
    """Sampled dense-dense product: out[e] = lhs[rows[e]] . rhs[cols[e]]."""
    acc = _acc_dtype(torch.promote_types(lhs.dtype, rhs.dtype))
    le = gather(lhs.to(acc), rows)
    re = gather(rhs.to(acc), cols)
    return torch.sum(le * re, dim=-1).to(lhs.dtype)


def spmm_binned(binned: BinnedEll, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X over the binned-ELL layout: per bucket, gather (R, K, d),
    contract K against the values, then the plan's finish (the counterpart
    of the JAX package's ``spmm_binned_xla``)."""
    d = x.shape[1]
    if not binned.buckets:
        return torch.zeros((binned.n_rows, d), dtype=x.dtype, device=x.device)
    dev = x.device
    acc = _acc_dtype(torch.promote_types(x.dtype, _t(binned.buckets[0].vals, dev).dtype))
    xa = x.to(acc)
    contribs = []
    for b in binned.buckets:
        cols = _t(b.cols, dev).long()
        g = xa.index_select(0, cols.reshape(-1)).reshape(cols.shape + (d,))
        contribs.append(torch.einsum("rk,rkd->rd", _t(b.vals, dev).to(acc), g))
    return combine_contribs(binned, contribs, acc).to(x.dtype)


def combine_contribs(binned: BinnedEll, contribs, acc: torch.dtype,
                     gather_fn: Optional[Callable] = None,
                     cat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Turn per-bucket ELL-row partial results into output rows.

    Relabeled layout: slice each bucket's first-chunk rows into place,
    then scatter-add the split-row leftovers. Finish plan: concatenate and
    apply the plan-time permutation (one gather; empty rows hit the
    sentinel and become zeros) plus a scatter-add for split-row extras.
    Neither: per-bucket scatter-add. ``gather_fn(table, idx)`` replaces
    the finish gather (the port's gather kernel). ``cat``, if given, is
    the contribs' concatenation already (the bucket kernel writes one
    buffer), which the finish gathers from without copying.
    """
    if not contribs:
        return torch.zeros((binned.n_rows, 0), dtype=acc)
    d = contribs[0].shape[1]
    dev = contribs[0].device
    fin = binned.finish
    if binned.slice_counts is not None:
        parts = [c[:nf] for c, nf in zip(contribs, binned.slice_counts)]
        n_first = sum(binned.slice_counts)
        if n_first < binned.n_rows:  # empty rows sorted to the tail
            parts.append(torch.zeros((binned.n_rows - n_first, d), dtype=acc, device=dev))
        out = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0].clone()
        if not isinstance(fin, BucketExtras):
            raise TypeError("a relabeled plan carries BucketExtras")
        for contrib, rids, idx in zip(contribs, fin.rids, fin.idx):
            if rids.shape[0]:
                out.index_add_(0, _t(rids, dev), contrib.index_select(0, _t(idx, dev)))
        return out
    if isinstance(fin, Finish):
        g = gather_fn or gather
        if cat is None:
            cat = contribs[0] if len(contribs) == 1 else torch.cat(contribs, dim=0)
        out = g(cat, _t(fin.pos, dev))
        if fin.extra_rids.shape[0]:
            out.index_add_(0, _t(fin.extra_rids, dev), g(cat, _t(fin.extra_idx, dev)))
        return out
    out = torch.zeros((binned.n_rows, d), dtype=acc, device=dev)
    for b, contrib in zip(binned.buckets, contribs):
        out.index_add_(0, _t(b.row_ids, dev), contrib)
    return out


def _tier_bucket_contrib(xt: torch.Tensor, cols, vals: torch.Tensor,
                         max_slots: int) -> torch.Tensor:
    """One tiered bucket against its tier's table slice, in row chunks of
    at most ``max_slots`` gathered slots. Narrow buckets accumulate one
    column of the ELL row at a time, wide ones gather (r, K, d) at once
    (the two forms of the JAX package's tiered oracle)."""
    R, K = cols.shape
    cols = cols.long()

    def one(c, v):
        if K <= 32:
            acc = torch.zeros((c.shape[0], xt.shape[1]), dtype=xt.dtype, device=xt.device)
            for k in range(K):
                acc += v[:, k:k + 1] * xt.index_select(0, c[:, k])
            return acc
        g = xt.index_select(0, c.reshape(-1)).reshape(c.shape + (xt.shape[1],))
        return (v.unsqueeze(-1) * g).sum(dim=1)

    if R * K <= max_slots:
        return one(cols, vals)
    rows_per = max(max_slots // K, 8)
    return torch.cat([one(cols[r0:r0 + rows_per], vals[r0:r0 + rows_per])
                      for r0 in range(0, R, rows_per)], dim=0)


def spmm_tiered(tiled, x: torch.Tensor, buckets_fn: Optional[Callable] = None,
                gather_fn: Optional[Callable] = None) -> torch.Tensor:
    """Column-tiered SpMM (see sparse/tiled.py): each bucket gathers from
    its tier's slice of X (tier -1: all of X), and the plan-time Finish
    assembles output rows from the concatenated bucket results.

    ``buckets_fn(tiled, x)``: optional engine for every bucket at once
    (the port's bucket kernel, one launch). It reads float32 ``x`` at rows
    ``row_offset + cols`` of each bucket and returns the float32
    concatenation of every bucket's partial rows, in tier order.
    ``gather_fn(table, idx)``: optional engine for the finish gathers,
    with out-of-range -> 0 semantics (the port's gather kernel).
    """
    d = x.shape[1]
    dev = x.device
    if not tiled.tiers:
        return torch.zeros((tiled.n_rows, d), dtype=x.dtype, device=dev)
    ts = tiled.tier_size
    buckets = [(t.tier, b) for t in tiled.tiers for b in t.buckets]
    if buckets_fn is not None:
        cat = buckets_fn(tiled, x.to(torch.float32).contiguous())
    else:
        total_ell_rows = sum(b.n_ell_rows for _, b in buckets)
        acc = _acc_dtype(torch.promote_types(x.dtype, _t(buckets[0][1].vals, dev).dtype))
        xa = x.to(acc)
        max_slots = int(FLAGS.get("OFS_SPMM_MAX_GATHER_SLOTS"))
        # large plans fill one preallocated buffer bucket by bucket instead
        # of holding every bucket's result and their concatenation at once
        big = total_ell_rows * d * acc.itemsize > int(FLAGS.get("OFS_TIERED_SCATTER_BYTES"))
        cat = torch.empty((total_ell_rows, d), dtype=acc, device=dev) if big else None
        contribs = []
        off = 0
        for tier, b in buckets:
            xt = xa if tier < 0 else xa[tier * ts:(tier + 1) * ts]
            c = _tier_bucket_contrib(xt, _t(b.cols, dev), _t(b.vals, dev).to(acc),
                                     max_slots)
            if big:
                cat[off:off + c.shape[0]] = c
                off += c.shape[0]
            else:
                contribs.append(c)
        if not big:
            cat = contribs[0] if len(contribs) == 1 else torch.cat(contribs, dim=0)
    fin = tiled.finish
    g = gather_fn or gather
    out = g(cat, _t(fin.pos, dev))
    if fin.extra_rids.shape[0]:
        out.index_add_(0, _t(fin.extra_rids, dev), g(cat, _t(fin.extra_idx, dev)))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SpGEMM: the host expand / sort / reduce (a plan-time op).
# ---------------------------------------------------------------------------


def spgemm(a: CSR, b: CSR) -> CSR:
    """C = A @ B for CSR operands, on the host (plan time).

    C's nonzero count is unknown until it is computed, so this is host
    work: graph preprocessing such as the 2-hop product A @ A. The native
    Gustavson kernel (``native.spgemm``) first; without it, numpy expands
    every (i, k, v_a) against B's row k, lexsorts the (i, j) products and
    sums duplicate coordinates. C's indptr is cast to int32, as in the
    JAX package.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {a.shape} @ {b.shape}")
    from of_spmm_tpu_torch import native

    nat = native.spgemm(
        np.asarray(a.indptr), np.asarray(a.cols), np.asarray(a.vals),
        np.asarray(b.indptr), np.asarray(b.cols), np.asarray(b.vals),
        a.shape[0], b.shape[1],
    )
    if nat is not None:
        indptr, cols, vals = nat
        return CSR.from_arrays(indptr.astype(np.int32), cols, vals,
                               (a.shape[0], b.shape[1]))
    a_indptr = np.asarray(a.indptr).astype(np.int64)
    a_cols = np.asarray(a.cols)
    a_vals = np.asarray(a.vals)
    b_indptr = np.asarray(b.indptr).astype(np.int64)
    b_cols = np.asarray(b.cols)
    b_vals = np.asarray(b.vals)

    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a_indptr))
    # expansion size of each A nonzero: the nnz of B's row a_cols[e]
    exp_counts = (b_indptr[a_cols + 1] - b_indptr[a_cols]).astype(np.int64)
    total = int(exp_counts.sum())
    if total == 0:
        return CSR.from_arrays(np.zeros(a.shape[0] + 1, np.int32), np.zeros(0, np.int32),
                               np.zeros(0, a_vals.dtype), (a.shape[0], b.shape[1]))
    e_ids = np.repeat(np.arange(a_cols.shape[0], dtype=np.int64), exp_counts)
    cum = np.zeros(a_cols.shape[0] + 1, dtype=np.int64)
    np.cumsum(exp_counts, out=cum[1:])
    intra = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], exp_counts)
    b_pos = b_indptr[a_cols[e_ids]] + intra

    out_rows = a_rows[e_ids]
    out_cols = b_cols[b_pos].astype(np.int64)
    out_vals = a_vals[e_ids] * b_vals[b_pos]

    # sum duplicates: lexsort by (row, col), a segment where either changes
    order = np.lexsort((out_cols, out_rows))
    out_rows, out_cols, out_vals = out_rows[order], out_cols[order], out_vals[order]
    key = out_rows * b.shape[1] + out_cols
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    boundary[1:] = key[1:] != key[:-1]
    group = np.cumsum(boundary) - 1
    n_out = int(group[-1]) + 1
    red_vals = np.zeros(n_out, dtype=out_vals.dtype)
    np.add.at(red_vals, group, out_vals)
    red_rows = out_rows[boundary]
    red_cols = out_cols[boundary]

    counts = np.bincount(red_rows, minlength=a.shape[0])
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR.from_arrays(indptr.astype(np.int32), red_cols.astype(np.int32), red_vals,
                           (a.shape[0], b.shape[1]))
