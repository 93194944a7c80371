"""Ring attention: context parallelism, the port of the JAX package's
parallel/ring.py.

Activations stay sequence-split the whole time; the K/V blocks rotate
around the ring (``permute``: comm's send/recv pairs over ranks, a
rotation of the shard axis on a ShardMesh) while each shard attends to
the block in front of it and folds it in with an online softmax (fp32
statistics). After N - 1 rotations every query has seen every key.
Memory per shard is O(T/N), so the sequence grows with the ring; unlike
Ulysses the ring size is not capped by the head count.

Inside a body every tensor carries the leading shard axis
(parallel/mesh.py); ``axis`` is a mesh axis (``mesh.axis("ring")``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from of_spmm_tpu_torch.nn.attention import MultiheadAttention
from of_spmm_tpu_torch.parallel.mesh import bcast
from of_spmm_tpu_torch.parallel.sp import merge_heads, project_heads, sharded_apply


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, axis,
                   is_causal: bool = False) -> torch.Tensor:
    """Attention over sequence-split (L, B, H, T/p, hd) q / k / v blocks;
    returns the (L, B, H, T/p, hd) output block. The causal mask is by
    global position."""
    n = axis.size
    idx = axis.index(q.device)
    Tl, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd)
    perm = [(i, (i + 1) % n) for i in range(n)]
    pos = torch.arange(Tl, device=q.device)
    q_pos = idx[:, None] * Tl + pos  # (L, Tl)

    m = torch.full(q.shape[:-1] + (1,), float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), device=q.device)
    o = torch.zeros(q.shape, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        scores = torch.einsum("...qd,...kd->...qk", q, k_blk).float() * scale
        mask = None
        if is_causal:
            kv_pos = ((idx - step) % n)[:, None] * Tl + pos
            mask = bcast(kv_pos[:, None, :] <= q_pos[:, :, None], scores.dim())
            scores = scores.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        # rows masked so far keep m = -inf: guard exp(-inf + inf)
        safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
        p = torch.exp(scores - safe_m)
        if is_causal:
            p = p.masked_fill(~mask, 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = alpha * o + torch.einsum("...qk,...kd->...qd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
        if step < n - 1:
            k_blk, v_blk = axis.permute(k_blk, perm), axis.permute(v_blk, perm)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


class RingAttention(MultiheadAttention):
    """MultiheadAttention computed with ring context parallelism; the same
    parameters as MultiheadAttention (its ``forward`` is the dense one).
    Inputs and outputs stay sequence-split on the ring axis."""

    def __init__(self, embed_dim: int, num_heads: int, use_bias: bool = True, device=None,
                 generator=None):
        super().__init__(embed_dim, num_heads, use_bias=use_bias, device=device,
                         generator=generator)

    def apply_local(self, x_local: torch.Tensor, *, axis, is_causal: bool = False
                    ) -> torch.Tensor:
        """Body: (L, B, T/p, E) -> (L, B, T/p, E)."""
        q, k, v = project_heads(self, x_local)
        return merge_heads(self, ring_attention(q, k, v, axis=axis, is_causal=is_causal))

    def make_sharded_apply(self, mesh, axis_name: str = "ring", is_causal: bool = False
                           ) -> Callable:
        """``fn(x)`` with x (B, T, E) split over ``axis_name`` by sequence."""
        return sharded_apply(lambda xl, ax: self.apply_local(xl, axis=ax, is_causal=is_causal),
                             mesh, axis_name)


__all__ = ["ring_attention", "RingAttention"]
