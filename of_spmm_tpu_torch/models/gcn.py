"""GCN: sparse aggregation followed by a dense transform.

A layer is H' = act(A_hat @ H @ W + b) with A_hat the symmetrically
normalized adjacency; A_hat @ H is the package's SpMM. Weights are
(fan_in, fan_out), as in the JAX package, so a layer is
``spmm(A_hat, h) @ w + b`` and parameters carry over unchanged
(interop.gcn_params_from_numpy).

The model trains: each SpMM's backward is the same engine on the
operator's transpose plan (ops/autograd.py). ``forward(..., train=True,
generator=g)`` applies dropout after each hidden activation;
``loss_fn`` is the masked mean negative log-likelihood and, like the JAX
package's, runs the model without dropout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from of_spmm_tpu_torch.nn.gnn import glorot
from of_spmm_tpu_torch.nn.layers import Dropout
from of_spmm_tpu_torch.ops.autograd import SpmmOperator, spmm_internal
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.utils.device import resolve_device


def normalized_adjacency(csr: CSR, add_self_loops: bool = True) -> CSR:
    """A_hat = D^-1/2 (A + I) D^-1/2, host-side graph preprocessing."""
    coo = csr.to_coo()
    rows, cols, vals = coo.rows, coo.cols, coo.vals
    n = csr.shape[0]
    if add_self_loops:
        rows = np.concatenate([rows, np.arange(n, dtype=rows.dtype)])
        cols = np.concatenate([cols, np.arange(n, dtype=cols.dtype)])
        vals = np.concatenate([vals, np.ones(n, dtype=vals.dtype)])
    # bincount is buffered; np.add.at takes minutes at 10^8 nnz
    deg = np.bincount(rows, weights=vals.astype(np.float64), minlength=n)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vals = (vals * dinv[rows] * dinv[cols]).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows, cols, vals, csr.shape))


class GCNLayer(nn.Module):
    """Weight (fan_in, fan_out), Glorot-uniform; bias zeros."""

    def __init__(self, fan_in: int, fan_out: int, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = glorot((fan_in, fan_out), device, generator)
        self.b = nn.Parameter(torch.zeros(fan_out, dtype=torch.float32, device=device))


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under softmax(logits);
    with ``mask``, sum(nll * m) / max(sum(m), 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


class GCN(nn.Module):
    """An L-layer GCN over ``feature_dims = (in, hidden..., out)``: ReLU
    after every layer but the last, then (``train=True`` only) dropout
    at rate ``dropout``.

    ``device=None`` places the parameters on the card and raises when
    there is none. ``generator`` (a CPU ``torch.Generator``) seeds the
    weights.
    """

    def __init__(self, feature_dims: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None, dropout: float = 0.0):
        super().__init__()
        dev = resolve_device(device)
        self.feature_dims = tuple(int(d) for d in feature_dims)
        self.layers = nn.ModuleList(
            GCNLayer(fi, fo, dev, generator)
            for fi, fo in zip(self.feature_dims[:-1], self.feature_dims[1:])
        )
        self.drop = Dropout(dropout)

    def forward(self, op: SpmmOperator, x: torch.Tensor, impl: str = "auto",
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        # convert once into the operator's internal row order (free for
        # non-relabeled operators); the dense transforms are row-order
        # agnostic
        h = op.to_internal(x)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = spmm_internal(op, h, impl=impl) @ layer.w + layer.b
            if i < last:
                h = self.drop(torch.relu(h), train=train, generator=generator)
        return op.from_internal(h)

    def loss_fn(self, op: SpmmOperator, x: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None, impl: str = "auto") -> torch.Tensor:
        """Masked softmax cross-entropy of full-batch node classification.
        Runs the model without dropout, as the JAX package's loss_fn does."""
        return masked_nll(self(op, x, impl=impl), labels, mask)
