"""GraphSAGE (mean aggregator): the second model family over the same SpMM.

A layer is h' = act(h @ w_self + mean_agg(h) @ w_neigh + b), mean
aggregation being the SpMM with the row-normalised adjacency D^-1 A.
That operator is not symmetric, so its backward runs on a transpose plan
built on its own (``not op.transpose_aliased``). Counterpart of the JAX
package's ``of_spmm_tpu/models/sage.py``; parameters carry over with
interop.sage_params_from_numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from of_spmm_tpu_torch.models.gcn import masked_nll
from of_spmm_tpu_torch.nn.gnn import SAGEConv
from of_spmm_tpu_torch.ops.autograd import SpmmOperator, spmm_internal
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.utils.device import resolve_device


def mean_adjacency(csr: CSR) -> CSR:
    """D^-1 A, the row-mean aggregation operator (host-side)."""
    coo = csr.to_coo()
    deg = np.bincount(coo.rows, minlength=csr.shape[0]).astype(np.float64)
    scale = 1.0 / np.maximum(deg, 1.0)
    vals = (coo.vals.astype(np.float64) * scale[coo.rows]).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(coo.rows, coo.cols, vals, csr.shape))


class GraphSAGE(nn.Module):
    """An L-layer GraphSAGE over ``feature_dims = (in, hidden..., out)``:
    ReLU after every layer but the last. ``device=None`` places the
    parameters on the card; ``generator`` seeds them."""

    def __init__(self, feature_dims: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.feature_dims = tuple(int(d) for d in feature_dims)
        self.layers = nn.ModuleList(
            SAGEConv(fi, fo, device=dev, generator=generator)
            for fi, fo in zip(self.feature_dims[:-1], self.feature_dims[1:]))

    def forward(self, op: SpmmOperator, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        h = op.to_internal(x)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = h @ layer.w_self + spmm_internal(op, h, impl=impl) @ layer.w_neigh + layer.b
            if i < last:
                h = torch.relu(h)
        return op.from_internal(h)

    def loss_fn(self, op: SpmmOperator, x: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None, impl: str = "auto") -> torch.Tensor:
        """Masked softmax cross-entropy, as ``GCN.loss_fn``."""
        return masked_nll(self(op, x, impl=impl), labels, mask)
