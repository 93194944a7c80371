"""Row-sparse (indexed-slices) gradients and lazy sparse updates, the
counterpart of the JAX package's optim/indexed_slices.py.

- ``IndexedSlices``: (indices, values) of an (n_rows, D) parameter's
  gradient; ``dense()`` is their segment sum.
- ``reduce_ids``: duplicate ids summed. The result keeps the input's
  length, as the JAX function's static shape does: the surplus slots
  hold the sentinel id ``n_rows`` and zero values.
- ``sparse_lookup``: the embedding gather as a ``torch.autograd.Function``
  whose backward is the dense segment sum of the cotangent.
- ``sparse_value_and_grad``: the loss and the gradient of the gathered
  rows as IndexedSlices; the (n_rows, D) gradient is never formed.
- ``sparse_sgd_update`` / ``sparse_adam_update``: updates of the touched
  rows only. Adam is lazy: an untouched row's moments do not decay.

JAX scatters with ``mode="drop"``, so a sentinel slot changes nothing
there; torch's index ops raise on an index out of range, so these
updates drop the ids outside [0, n_rows) themselves. The updates return
new tensors, as the JAX functions do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import torch

from of_spmm_tpu_torch.ops.autograd import gather, segment_sum
from of_spmm_tpu_torch.ops import reference as ref


@dataclasses.dataclass(frozen=True)
class IndexedSlices:
    """Row-sparse gradient: dense equivalent zeros((n_rows, D)) with
    ``values`` added at ``indices``."""

    indices: torch.Tensor  # (k,) integer
    values: torch.Tensor  # (k, D)
    n_rows: int

    def dense(self) -> torch.Tensor:
        return segment_sum(self.values, self.indices, self.n_rows)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n_rows,) + tuple(self.values.shape[1:])


def reduce_ids(slices: IndexedSlices) -> IndexedSlices:
    """Ids made unique (sorted), duplicate rows summed; the surplus slots
    hold the sentinel ``n_rows`` and zero values."""
    idx = slices.indices.reshape(-1)
    k = idx.shape[0]
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    fill = torch.full((k - uniq.shape[0],), slices.n_rows, dtype=idx.dtype, device=idx.device)
    summed = segment_sum(slices.values, inv.reshape(-1), k)
    return IndexedSlices(indices=torch.cat([uniq, fill]), values=summed, n_rows=slices.n_rows)


class _SparseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.n = weight.shape[0]
        return ref.gather(weight, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1])
        return ref.segment_sum(flat, ids.reshape(-1), ctx.n), None


def sparse_lookup(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """weight[ids] (a row per id, zero for an id out of range). Its
    backward forms the dense (n_rows, D) gradient; differentiate through
    ``sparse_value_and_grad`` to keep it row-sparse."""
    return _SparseLookup.apply(weight, torch.as_tensor(ids, device=weight.device))


def sparse_value_and_grad(loss_fn: Callable, embedding_name: str = "weight") -> Callable:
    """``fn(weight, ids, *args) -> (loss, IndexedSlices)`` for
    ``loss_fn(rows, *args)``, which takes the gathered rows (one per id
    of ``ids`` flattened) as its first argument."""

    def fn(weight: torch.Tensor, ids: torch.Tensor, *args):
        flat = torch.as_tensor(ids, device=weight.device).reshape(-1)
        rows = gather(weight.detach(), flat).requires_grad_()
        loss = loss_fn(rows, *args)
        (g_rows,) = torch.autograd.grad(loss, rows)
        return loss.detach(), IndexedSlices(indices=flat, values=g_rows,
                                            n_rows=weight.shape[0])

    return fn


def _in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n)


def sparse_sgd_update(param: torch.Tensor, g: IndexedSlices, lr: float) -> torch.Tensor:
    """param with ``lr * values`` subtracted at ``indices`` (duplicates
    accumulate)."""
    keep = _in_range(g.indices, param.shape[0])
    return param.index_add(0, g.indices[keep].long(), (-lr * g.values[keep]).to(param.dtype))


def sparse_adam_update(param: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       step: Union[int, torch.Tensor], g: IndexedSlices, lr: float = 1e-3,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lazy Adam on the touched rows (``step`` is this update's, from 1):
    returns the new (param, m, v); untouched rows are unchanged."""
    r = reduce_ids(g)
    keep = _in_range(r.indices, param.shape[0])
    ids, vals = r.indices[keep].long(), r.values[keep]
    m_rows = b1 * m[ids] + (1 - b1) * vals
    v_rows = b2 * v[ids] + (1 - b2) * vals * vals
    t = torch.as_tensor(step, dtype=torch.float32)
    c1 = (1 - b1 ** t).to(param.device)
    c2 = (1 - b2 ** t).to(param.device)
    upd = lr * (m_rows / c1) / (torch.sqrt(v_rows / c2) + eps)
    return (param.index_add(0, ids, -upd), m.index_copy(0, ids, m_rows),
            v.index_copy(0, ids, v_rows))


__all__ = ["IndexedSlices", "reduce_ids", "sparse_lookup", "sparse_value_and_grad",
           "sparse_sgd_update", "sparse_adam_update"]
