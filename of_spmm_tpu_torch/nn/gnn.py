"""GNN convolution layers over the package's sparse ops, as
``torch.nn.Module``s.

Counterparts of the JAX package's ``of_spmm_tpu/nn/gnn.py``, with the
same parameter names and shapes (weights (fan_in, fan_out), Glorot
uniform), so a JAX parameter dict carries over unchanged
(interop.py ``*_conv_params_from_numpy``). Two aggregation shapes:

- ``GCNConv`` / ``SAGEConv`` / ``GINConv``: plan-valued aggregation,
  ``spmm`` over a prepared ``SpmmOperator`` (values fixed at plan time;
  the backward is the same engine on the transpose plan);
- ``GATConv``: runtime-valued aggregation, attention scores per edge
  through the gather path, normalised with ``segment_softmax`` and
  aggregated per head with ``spmm_coo`` over the operator's COO pattern
  (differentiable in the weights and the features).

Each module takes ``device`` (None: the card, raising without one) and an
optional CPU ``generator`` for its initial values.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.ops.autograd import (
    SpmmOperator, gather, segment_softmax, spmm, spmm_coo)
from of_spmm_tpu_torch.utils.device import resolve_device


def glorot(shape: Sequence[int], device, generator: Optional[torch.Generator]
           ) -> torch.nn.Parameter:
    """Uniform in +-sqrt(6 / (shape[0] + shape[-1]))."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return torch.nn.Parameter(((u * 2 - 1) * limit).to(device))


def _zeros(n: int, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device))


class GCNConv(torch.nn.Module):
    """h' = A_hat @ h @ w + b (aggregate, then transform)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.w = glorot((in_features, out_features), dev, generator)
        self.b = _zeros(out_features, dev) if use_bias else None

    def forward(self, op: SpmmOperator, h: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        y = spmm(op, h, impl=impl) @ self.w
        return y if self.b is None else y + self.b


class SAGEConv(torch.nn.Module):
    """h' = h @ w_self + mean_agg(h) @ w_neigh + b (GraphSAGE, mean
    aggregator: ``op`` is D^-1 A, models/sage.py ``mean_adjacency``)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.w_self = glorot((in_features, out_features), dev, generator)
        self.w_neigh = glorot((in_features, out_features), dev, generator)
        self.b = _zeros(out_features, dev) if use_bias else None

    def forward(self, op: SpmmOperator, h: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        y = h @ self.w_self + spmm(op, h, impl=impl) @ self.w_neigh
        return y if self.b is None else y + self.b


class GATConv(torch.nn.Module):
    """Graph attention over the operator's COO pattern (row = target):

    score[e] = LeakyReLU(a_src . (h w)[cols[e]] + a_dst . (h w)[rows[e]])
    alpha    = segment_softmax(score, rows)
    h'[i]    = sum_e alpha[e] (h w)[cols[e]]   (heads concatenated or meaned)
    """

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 concat_heads: bool = True, negative_slope: float = 0.2,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.heads, self.out_features = int(heads), int(out_features)
        self.concat_heads, self.negative_slope = bool(concat_heads), float(negative_slope)
        H, Fo = self.heads, self.out_features
        self.w = glorot((in_features, H * Fo), dev, generator)
        self.a_src = glorot((H, Fo), dev, generator)
        self.a_dst = glorot((H, Fo), dev, generator)
        self.b = _zeros(H * Fo if concat_heads else Fo, dev) if use_bias else None

    def forward(self, op: SpmmOperator, h: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        H, Fo = self.heads, self.out_features
        n = op.shape[0]
        rows, cols = op.coo_rows, op.coo_cols
        hw = (h @ self.w).reshape(-1, H, Fo)
        s_src = torch.einsum("nhf,hf->nh", hw, self.a_src)
        s_dst = torch.einsum("nhf,hf->nh", hw, self.a_dst)
        score = F.leaky_relu(gather(s_src, cols) + gather(s_dst, rows), self.negative_slope)
        alpha = segment_softmax(score, rows, n)
        y = torch.stack([spmm_coo(rows, cols, alpha[:, k], hw[:, k, :], n) for k in range(H)],
                        dim=1)
        y = y.reshape(n, H * Fo) if self.concat_heads else y.mean(dim=1)
        return y if self.b is None else y + self.b


class GINConv(torch.nn.Module):
    """h' = MLP((1 + eps) h + sum_agg(h)), the MLP two layers with a ReLU
    between; ``op`` is the unnormalised adjacency and ``eps`` learnable."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.eps = torch.nn.Parameter(torch.zeros((), dtype=torch.float32, device=dev))
        self.w1 = glorot((in_features, hidden_features), dev, generator)
        self.b1 = _zeros(hidden_features, dev)
        self.w2 = glorot((hidden_features, out_features), dev, generator)
        self.b2 = _zeros(out_features, dev)

    def forward(self, op: SpmmOperator, h: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        z = (1.0 + self.eps) * h + spmm(op, h, impl=impl)
        return torch.relu(z @ self.w1 + self.b1) @ self.w2 + self.b2
