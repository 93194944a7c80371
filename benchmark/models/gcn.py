"""The system under test for GCN configurations: the port's own graph
preprocessing (``normalized_adjacency``) and model (``models.GCN``)."""

from __future__ import annotations

import torch

from of_spmm_tpu_torch.models import GCN, normalized_adjacency


def adjacency(csr):
    return normalized_adjacency(csr)


def model(dims, device) -> torch.nn.Module:
    return GCN(tuple(dims), device=device, generator=torch.Generator().manual_seed(0))
