"""Data-parallel training, the port of the JAX package's parallel/ddp.py
(reference: python/oneflow/nn/parallel/ddp.py) over ``torch.optim``.

- ``broadcast_params``: the first shard's values replicated everywhere
  (the wrap-time broadcast).
- ``allreduce_gradients``: a tree-wide psum / pmean over a mesh axis
  inside a body.
- ``ddp_train_step``: ``step(*batch) -> loss``: the batch split S(0)
  over the data axis, the loss averaged over its shards, the gradients
  averaged, then the optimizer's step.

On a ShardMesh the model's parameters are one copy shared by every shard,
so one backward of the mean of the shards' losses leaves the averaged
gradient. Over ranks each rank backs its own share (its loss over the
mesh size) and the gradients are summed over the ranks (one all-reduce
each), so every rank takes the same step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from of_spmm_tpu_torch import comm
from of_spmm_tpu_torch.parallel.global_view import tree_map, sbp_for, shard, to_global


def broadcast_params(params: Any, mesh) -> Any:
    """A dict, list or tuple of parameters replicated over ``mesh``
    (GlobalTensors placed B): over ranks each tensor first takes the
    group's first rank's values in place; on a ShardMesh the one copy is
    every shard's."""
    if len(mesh.local_coords()) < mesh.size:
        def copy_first(t):
            with torch.no_grad():
                t.copy_(comm.broadcast(t.detach(), root=0, group=mesh.group))
            return t
        tree_map(copy_first, params)
    return to_global(params, sbp_for(mesh), mesh)


def allreduce_gradients(grads: Any, axis, mean: bool = True) -> Any:
    """Every gradient (body tensors) summed, or averaged, over ``axis``
    (``mesh.axis(name)``)."""
    return tree_map(axis.pmean if mean else axis.psum, grads)


def ddp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, mesh,
                   axis: str = "x") -> Callable:
    """``step(*batch) -> loss``: one data-parallel step of ``optimizer``.

    ``loss_fn(*batch_block)`` is the mean loss of a block of the batch
    (it reads the model's parameters itself). Each batch tensor is the
    global batch, split S(0) over ``axis``; the step's loss is the mean
    over the shards (the global mean for equal blocks), and every shard
    takes the step with the averaged gradient."""
    spec = sbp_for(mesh, **{axis: "S0"})
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(*batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        blocks = [shard(b, spec, mesh) for b in batch]
        losses = torch.stack([loss_fn(*(b[i] for b in blocks))
                              for i in range(blocks[0].shape[0])])
        loss = losses.sum() / mesh.size
        loss.backward()
        for p in params:
            if p.grad is not None:
                p.grad = mesh.sum_shared(p.grad)
        optimizer.step()
        return mesh.sum_shared(loss.detach())

    return step


__all__ = ["broadcast_params", "allreduce_gradients", "ddp_train_step"]
