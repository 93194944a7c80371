"""GAT: attention-weighted aggregation, the third model family.

Stacks ``nn.GATConv`` layers: per-edge attention computed in the forward
through the gather / segment_softmax path and aggregated with the
runtime-valued ``spmm_coo`` over the operator's COO pattern (node space;
the plan itself is not used). Hidden layers concatenate their heads and
apply ELU; the output layer means them. Counterpart of the JAX package's
``of_spmm_tpu/models/gat.py``; parameters carry over with
interop.gat_params_from_numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from of_spmm_tpu_torch.models.gcn import masked_nll
from of_spmm_tpu_torch.nn.gnn import GATConv
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.utils.device import resolve_device


class GAT(nn.Module):
    """An L-layer GAT over ``feature_dims = (in, hidden..., out)`` with
    ``heads`` heads a layer. ``device=None`` places the parameters on the
    card; ``generator`` seeds them."""

    def __init__(self, feature_dims: Sequence[int], heads: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dims = self.feature_dims = tuple(int(d) for d in feature_dims)
        self.heads = int(heads)
        last = len(dims) - 2
        self.convs = nn.ModuleList(
            GATConv(fi if i == 0 else dims[i] * self.heads, fo, heads=self.heads,
                    concat_heads=i != last, device=dev, generator=generator)
            for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])))

    def forward(self, op: SpmmOperator, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """``impl`` is taken for the models' common signature and unused:
        GAT aggregates with spmm_coo, not through the plan."""
        h = x
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            h = conv(op, h)
            if i < last:
                h = F.elu(h)
        return h

    def loss_fn(self, op: SpmmOperator, x: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None, impl: str = "auto") -> torch.Tensor:
        """Masked softmax cross-entropy, as ``GCN.loss_fn``."""
        return masked_nll(self(op, x), labels, mask)
