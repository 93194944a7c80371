"""GCN: sparse aggregation followed by a dense transform.

A layer is H' = act(A_hat @ H @ W + b) with A_hat the symmetrically
normalized adjacency; A_hat @ H is the package's SpMM. Weights are
(fan_in, fan_out), as in the JAX package, so a layer is
``spmm(A_hat, h) @ w + b`` and parameters carry over unchanged
(interop.gcn_params_from_numpy).

Inference only in this slice: the SpMM has no backward yet, so run
``forward`` under ``torch.no_grad()`` or ``torch.inference_mode()``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

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
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = torch.rand((fan_in, fan_out), generator=generator, dtype=torch.float32)
        self.w = nn.Parameter(((w * 2 - 1) * limit).to(device))
        self.b = nn.Parameter(torch.zeros(fan_out, dtype=torch.float32, device=device))


class GCN(nn.Module):
    """An L-layer GCN over ``feature_dims = (in, hidden..., out)``: ReLU
    after every layer but the last.

    ``device=None`` places the parameters on the card and raises when
    there is none. ``generator`` (a CPU ``torch.Generator``) seeds the
    weights.
    """

    def __init__(self, feature_dims: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.feature_dims = tuple(int(d) for d in feature_dims)
        self.layers = nn.ModuleList(
            GCNLayer(fi, fo, dev, generator)
            for fi, fo in zip(self.feature_dims[:-1], self.feature_dims[1:])
        )

    def forward(self, op: SpmmOperator, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        # convert once into the operator's internal row order (free for
        # non-relabeled operators); the dense transforms are row-order
        # agnostic
        h = op.to_internal(x)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = spmm_internal(op, h, impl=impl) @ layer.w + layer.b
            if i < last:
                h = torch.relu(h)
        return op.from_internal(h)
