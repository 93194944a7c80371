"""The system under test for GraphSAGE configurations: the port's own
graph preprocessing (``mean_adjacency``) and model (``models.GraphSAGE``)."""

from __future__ import annotations

import torch

from of_spmm_tpu_torch.models.sage import GraphSAGE, mean_adjacency


def adjacency(csr):
    return mean_adjacency(csr)


def model(dims, device) -> torch.nn.Module:
    return GraphSAGE(tuple(dims), device=device, generator=torch.Generator().manual_seed(0))
