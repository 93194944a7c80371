"""comm: collective communication over ``torch.distributed`` process groups.

The port of the JAX package's comm module. There the wrappers name a mesh
axis inside ``shard_map``; here each takes a process group (``None`` is
the default group) and runs in every rank of it, one rank per process.
Ranks are group ranks. Each wrapper is differentiable where its JAX
counterpart is: the backward of an all-gather is a reduce-scatter, of an
all-to-all the reverse all-to-all, of a permutation the inverse
permutation, of a sum-all-reduce a sum-all-reduce.

The calls used (``all_reduce``, ``all_gather``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``batch_isend_irecv``) run on NCCL and on gloo.

Collective parity with the reference's eager boxing algebra
(oneflow/core/boxing/eager_boxing_interpreter_mgr.cpp:132-165):
all_reduce == ccl-p-to-b, all_gather == ccl-s-to-b,
reduce_scatter == ccl-p-to-s, all_to_all == ccl-s-to-s.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _me(group) -> int:
    return dist.get_rank(group)


def _peer(group, rank: int) -> int:
    """The global rank of group rank ``rank`` (point-to-point ops take
    global ranks)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    S = _size(group)
    if x.shape[dim] % S:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                         f"into {S} ranks")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // S,) + src.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    S = _size(group)
    if x.shape[split_dim] % S:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"into {S} ranks")
    send = torch.stack(torch.tensor_split(x, S, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _permute(x: torch.Tensor, pairs: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """Rank dst receives rank src's ``x`` for each (src, dst) pair; a rank
    named as no dst receives zeros."""
    me = _me(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, _peer(group, dst), group=group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _peer(group, src), group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _permute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(dst, src) for src, dst in ctx.pairs], ctx.group), None, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group's ranks (ccl AllReduce; P -> B)."""
    return _AllReduce.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(x, group) / _size(group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (ccl
    AllGather; S -> B)."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Sum over the ranks, then rank r keeps chunk r along ``dim`` (ccl
    ReduceScatter; P -> S)."""
    return _ReduceScatter.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group=None, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """Chunk j of ``x`` along ``split_dim`` goes to rank j; the chunks
    received are concatenated along ``concat_dim`` in rank order (ccl S2S;
    S(i) -> S(j))."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def broadcast(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """Every rank receives ``root``'s value (ccl Broadcast), as a masked
    sum: root contributes its value, the others zeros."""
    return all_reduce(x if _me(group) == root else torch.zeros_like(x), group)


def reduce(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """The sum over the ranks on ``root``, zeros elsewhere (ccl Reduce)."""
    total = all_reduce(x, group)
    return total if _me(group) == root else torch.zeros_like(total)


def permute(x: torch.Tensor, perm: Sequence[tuple], group=None) -> torch.Tensor:
    """Point-to-point shuffle by (src, dst) pairs (ccl Send/Recv pairs);
    ranks named as no dst receive zeros."""
    return _Permute.apply(x, [tuple(p) for p in perm], group)


def send_recv_next(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Ring shift by ``shift``: each rank sends to rank + shift mod N and
    receives from rank - shift mod N."""
    n = _size(group)
    return permute(x, [(i, (i + shift) % n) for i in range(n)], group)


def send_recv(x: torch.Tensor, src: int, dst: int, group=None) -> torch.Tensor:
    """``src``'s value arrives on ``dst``; every other rank receives zeros
    (the reference's Send/Recv functor pair,
    oneflow/core/functional/impl/comm_functor.cpp:331-373)."""
    return permute(x, [(src, dst)], group)


def send_recv_pairs(x: torch.Tensor, pairs: Sequence[tuple], group=None) -> torch.Tensor:
    """A batch of disjoint (src, dst) transfers (the device-generic ccl
    Send/Recv list, collective_communication.h:44-62)."""
    return permute(x, pairs, group)


def transfer(x: torch.Tensor, dst_device) -> torch.Tensor:
    """Copy ``x`` to another device of this process (differentiable)."""
    return x.to(torch.device(dst_device))


__all__ = ["all_reduce", "all_reduce_mean", "all_gather", "reduce_scatter", "all_to_all",
           "broadcast", "reduce", "permute", "send_recv_next", "send_recv", "send_recv_pairs",
           "transfer"]

