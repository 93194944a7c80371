"""Distributed full-batch GCN training over a row-partitioned graph.

The port of the JAX package's train.py: ``dist_spmm`` (parallel/
dist_spmm.py) for the aggregations, dense matmuls for the transforms,
autograd through the whole (the reverse halo exchange included), and an
SGD update. Parameters are replicated; the graph, features and
activations are row-partitioned.

On a ShardMesh the step takes the global X and labels, as the JAX
package's does. On a RankGroup each rank passes its padded X block and
labels block; the loss is the mean over the real rows of all ranks, and
the parameter gradients are summed over the ranks (one all-reduce each)
before the update, so every rank keeps the same parameters.
"""

from __future__ import annotations

from typing import Callable

import torch

from of_spmm_tpu_torch import comm
from of_spmm_tpu_torch.models.gcn import GCN, masked_nll
from of_spmm_tpu_torch.parallel.dist_spmm import RankGroup, dist_spmm
from of_spmm_tpu_torch.parallel.partition import RowPartitionPlan


def dist_gcn_apply(model: GCN, plan: RowPartitionPlan, x: torch.Tensor, mesh,
                   impl: str = "auto") -> torch.Tensor:
    """The GCN forward over the partitioned operator: each layer
    aggregates, then ``@ w + b``, ReLU between layers. On a ShardMesh the
    global logits; on a RankGroup this rank's block (rows_per_shard rows;
    the first ``plan.shard_rows(rank)`` are real)."""
    if isinstance(mesh, RankGroup) and plan.rows_per_shard != plan.cols_per_shard:
        raise ValueError("a GCN over rank blocks needs a square partition "
                         "(rows_per_shard == cols_per_shard)")
    h = x
    last = len(model.layers) - 1
    for i, layer in enumerate(model.layers):
        h = dist_spmm(plan, h, mesh, impl=impl) @ layer.w + layer.b
        if i < last:
            h = torch.relu(h)
    return h


def make_dist_train_step(model: GCN, plan: RowPartitionPlan, mesh, lr: float = 1e-2,
                         impl: str = "auto") -> Callable:
    """A ``step(x, labels) -> loss`` that takes one SGD step (``lr``) on
    ``model``'s parameters in place, on the mean negative log-likelihood
    over the real rows. On a RankGroup ``x`` and ``labels`` are this
    rank's blocks (rows past ``plan.shard_rows(rank)`` are padding), the
    loss is the global mean, and the gradients are all-reduced (sum)
    before the update."""
    n_real = plan.shape[0]
    params = list(model.parameters())
    ranked = isinstance(mesh, RankGroup)
    n_own = plan.shard_rows(mesh.rank) if ranked else n_real

    def step(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        for p in params:
            p.grad = None
        logits = dist_gcn_apply(model, plan, x, mesh, impl=impl)
        loss = masked_nll(logits[:n_own], labels[:n_own]) * (n_own / n_real)
        loss.backward()
        with torch.no_grad():
            if ranked:
                loss = comm.all_reduce(loss.detach(), mesh.group)
            for p in params:
                g = comm.all_reduce(p.grad, mesh.group) if ranked else p.grad
                p.sub_(lr * g)
        return loss.detach()

    return step
