"""Distributed full-batch GCN training over a row-partitioned graph: the
halo-exchange SpMM on every shard, replicated parameters, row-split
activations, SGD. Counterpart of the JAX package's
``examples/train_dist.py``.

    python -m of_spmm_tpu_torch.examples.train_dist [--graph cora] [--shards 4]
        [--steps 50] [--device cpu]
    python -m of_spmm_tpu_torch.distributed.launch --nproc_per_node 2 \\
        -m of_spmm_tpu_torch.examples.train_dist [--device cpu]

In one process the shards run on ``ShardMesh([device] * shards)``
(``--shards`` takes the place of the JAX example's simulated
``--devices``). Under the launcher each process is one rank of a
``RankGroup``, over NCCL on the card or over gloo with ``--device cpu``,
holding its padded block of the features and labels; the shards are then
the ranks. Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

import torch

from of_spmm_tpu_torch import distributed
from of_spmm_tpu_torch.data import load_graph, random_features
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.parallel import (
    RankGroup, RowPartitionPlan, ShardMesh, check_consistent, partition_rows)
from of_spmm_tpu_torch.train import make_dist_train_step
from of_spmm_tpu_torch.utils.device import resolve_device

HIDDEN, LR = 32, 1e-2


def rank_block(plan: RowPartitionPlan, a: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank ``rank``'s padded block of the global rows ``a`` (features or
    labels), as the rank form of dist_spmm takes it: the plan's
    (S * cols_per_shard) layout, zero-padded."""
    if plan.x_pack_idx is not None:
        a = a.index_select(0, torch.as_tensor(plan.x_pack_idx, device=a.device))
    else:
        pad = plan.n_shards * plan.cols_per_shard - a.shape[0]
        a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    cps = plan.cols_per_shard
    return a[rank * cps:(rank + 1) * cps]


def train(model: GCN, plan: RowPartitionPlan, mesh, x: torch.Tensor, y: torch.Tensor,
          steps: int, lr: float = LR, impl: str = "auto", log_every: int = 10,
          log: Callable[[str], None] = print) -> torch.Tensor:
    """``steps`` SGD steps of make_dist_train_step on ``mesh`` (global x
    and labels on a ShardMesh, this rank's blocks on a RankGroup); returns
    each step's loss (before its update). Logs every ``log_every``-th step
    and the last."""
    step = make_dist_train_step(model, plan, mesh, lr=lr, impl=impl)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(step(x, y))
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"step {i:4d}  loss {float(losses[-1]):.6f}  ({time.perf_counter() - t0:.1f}s)")
    return torch.stack(losses)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", default="cora")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards of the one-process mesh (the ranks under the launcher)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ranked = bool(distributed.env_spec())
    if ranked:
        dev = distributed.initialize(backend="nccl" if dev.type == "cuda" else "gloo")
        mesh = RankGroup()
    else:
        mesh = ShardMesh([dev] * args.shards)
    n = mesh.size
    print(f"rank {distributed.get_rank()}/{distributed.get_world_size()}, {n} shards on {dev}")

    csr, cfg = load_graph(args.graph, symmetrize=True)
    ahat = normalized_adjacency(csr)
    plan = partition_rows(ahat, n)
    check_consistent(plan, "row-partition plan")
    print(f"halo fraction: {plan.halo_fraction:.3f}")

    model = GCN((cfg.feature_dim, HIDDEN, cfg.n_classes), device=dev,
                generator=torch.Generator().manual_seed(0))
    x_np, y_np = random_features(cfg)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).long().to(dev)
    if ranked:
        x, y = rank_block(plan, x, mesh.rank), rank_block(plan, y, mesh.rank)
    log = print if distributed.get_rank() == 0 else (lambda line: None)
    train(model, plan, mesh, x, y, args.steps, log=log)
    distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
