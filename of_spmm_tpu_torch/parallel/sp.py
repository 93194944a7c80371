"""Sequence parallelism: Ulysses attention over an all-to-all, the port of
the JAX package's parallel/sp.py.

Activations live sequence-split S(seq) on an ``sp`` mesh axis. Attention
needs the whole sequence per head, so one all-to-all on each side of the
softmax core rotates the split head <-> sequence (DeepSpeed-Ulysses):
S(seq) over p shards becomes S(head), each shard holding H/p
whole-sequence heads. Four all-to-alls per layer (q, k, v, out), each
moving B*T*E/p elements; their backward is the reverse all-to-all.

Inside a body every tensor carries the leading shard axis
(parallel/mesh.py); ``axis`` is a mesh axis (``mesh.axis("sp")``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from of_spmm_tpu_torch.nn.attention import MultiheadAttention, scaled_dot_product_attention
from of_spmm_tpu_torch.parallel.global_view import sbp_for, shard, unshard
from of_spmm_tpu_torch.utils.errors import check_shape


def head_to_sequence(x: torch.Tensor, axis) -> torch.Tensor:
    """(L, B, H, T/p, hd) sequence-split -> (L, B, H/p, T, hd) head-split."""
    return axis.all_to_all(x, split_dim=2, concat_dim=3)


def sequence_to_head(x: torch.Tensor, axis) -> torch.Tensor:
    """(L, B, H/p, T, hd) head-split -> (L, B, H, T/p, hd) sequence-split."""
    return axis.all_to_all(x, split_dim=3, concat_dim=2)


def ulysses_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, *, axis,
                      is_causal: bool = False) -> torch.Tensor:
    """Attention over (L, B, H, T/p, hd) sequence-split heads: rotate to
    head-split, the whole-sequence softmax core on H/p heads, rotate back."""
    q, k, v = (head_to_sequence(t, axis) for t in (qh, kh, vh))
    return sequence_to_head(scaled_dot_product_attention(q, k, v, is_causal=is_causal), axis)


def project_heads(mha: MultiheadAttention, x_local: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of a body's (L, B, t, E) block through ``mha``'s packed
    in-projection, each (L, B, H, t, hd)."""
    E, H = mha.embed_dim, mha.num_heads
    ws = mha.in_w.chunk(3, dim=0)
    bs = mha.in_b.chunk(3, dim=0) if mha.use_bias else (None,) * 3

    def proj(w, b):
        y = x_local @ w.T
        if b is not None:
            y = y + b
        return y.unflatten(-1, (H, E // H)).transpose(-3, -2)

    return tuple(proj(w, b) for w, b in zip(ws, bs))


def merge_heads(mha: MultiheadAttention, o: torch.Tensor) -> torch.Tensor:
    """(L, B, H, t, hd) heads -> (L, B, t, E) through the out-projection."""
    o = o.transpose(-3, -2).flatten(-2) @ mha.out_w.T
    return o + mha.out_b if mha.use_bias else o


def sharded_apply(body: Callable, mesh, axis_name: str) -> Callable:
    """``fn(x)``: ``body(x_local, axis)`` over x split S(1) (sequence) on
    ``axis_name``; the global output on a ShardMesh, this rank's block
    over ranks."""
    x_sbp = sbp_for(mesh, **{axis_name: "S1"})

    def fn(x: torch.Tensor) -> torch.Tensor:
        return unshard(body(shard(x, x_sbp, mesh), mesh.axis(axis_name)), x_sbp, mesh)

    return fn


class SequenceParallelAttention(MultiheadAttention):
    """MultiheadAttention computed from sequence-split activations. The
    parameters are MultiheadAttention's (``in_w``, ``in_b``, ``out_w``,
    ``out_b``), so a state dict moves between the dense and the
    sequence-parallel module unchanged; ``forward`` is the dense one.
    ``num_heads`` must divide by the sp axis size."""

    def __init__(self, embed_dim: int, num_heads: int, use_bias: bool = True, device=None,
                 generator=None):
        super().__init__(embed_dim, num_heads, use_bias=use_bias, device=device,
                         generator=generator)

    def apply_local(self, x_local: torch.Tensor, *, axis, is_causal: bool = False
                    ) -> torch.Tensor:
        """Body: (L, B, T/p, E) -> (L, B, T/p, E)."""
        H, p = self.num_heads, axis.size
        check_shape(H % p == 0, f"num_heads={H} must divide the sp axis size {p}")
        q, k, v = project_heads(self, x_local)
        return merge_heads(self, ulysses_attention(q, k, v, axis=axis, is_causal=is_causal))

    def make_sharded_apply(self, mesh, axis_name: str = "sp", is_causal: bool = False
                           ) -> Callable:
        """``fn(x)`` with x (B, T, E) split over ``axis_name`` by sequence."""
        return sharded_apply(lambda xl, ax: self.apply_local(xl, axis=ax, is_causal=is_causal),
                             mesh, axis_name)


__all__ = ["head_to_sequence", "sequence_to_head", "ulysses_attention",
           "SequenceParallelAttention"]
