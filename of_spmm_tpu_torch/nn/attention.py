"""Attention: the dense oracle and multi-head attention.

Counterparts of the JAX package's ``of_spmm_tpu/nn/attention.py``:

- ``scaled_dot_product_attention``: scores q k^T / sqrt(d), a top-left
  causal mask and an optional boolean mask (False -> -inf), softmax in
  float32, cast back to q's dtype, times v. A row with every key masked
  gives NaN, as in JAX.
- ``MultiheadAttention``: torch-convention packed projections under the
  JAX keys ``in_w`` (3E, E), ``in_b`` (3E,), ``out_w`` (E, E), ``out_b``
  (E,). ``flash=True`` routes the softmax core through
  ``ops.flash_attention`` (the hand-written kernel on the card), which
  takes no mask other than ``is_causal``.

This is not ``torch.nn.functional.scaled_dot_product_attention``: that
fused library call is only a yardstick of speed in chip_smoke.py.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from of_spmm_tpu_torch.ops.flash_attention import flash_attention
from of_spmm_tpu_torch.utils.device import resolve_device


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 is_causal: bool = False) -> torch.Tensor:
    """(..., T, d) attention with a float32 softmax."""
    scores = torch.einsum("...qd,...kd->...qk", q, k) / math.sqrt(q.shape[-1])
    if is_causal:
        T, S = scores.shape[-2:]
        causal = torch.ones((T, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask.to(device=q.device, dtype=torch.bool),
                                    float("-inf"))
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("...qk,...kd->...qd", w, v)


class MultiheadAttention(torch.nn.Module):
    """Multi-head attention over batch-first (B, T, E) inputs.

    ``in_w`` and ``out_w`` start uniform in +-sqrt(1/E), the biases at
    zero (the JAX package's init). ``device=None`` is the card (raising
    without one); ``generator`` (CPU) seeds the weights.
    """

    def __init__(self, embed_dim: int, num_heads: int, use_bias: bool = True,
                 flash: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim ({embed_dim}) must be divisible by num_heads "
                             f"({num_heads})")
        dev = resolve_device(device)
        self.embed_dim, self.num_heads = int(embed_dim), int(num_heads)
        self.use_bias, self.flash = bool(use_bias), bool(flash)
        E = self.embed_dim
        bound = math.sqrt(1.0 / E)

        def uniform(shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return torch.nn.Parameter(((u * 2 - 1) * bound).to(dev))

        self.in_w = uniform((3 * E, E))
        self.out_w = uniform((E, E))
        self.in_b = self.out_b = None
        if use_bias:
            self.in_b = torch.nn.Parameter(torch.zeros(3 * E, device=dev))
            self.out_b = torch.nn.Parameter(torch.zeros(E, device=dev))

    def forward(self, q: torch.Tensor, k: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None, *, mask: Optional[torch.Tensor] = None,
                is_causal: bool = False) -> torch.Tensor:
        k = q if k is None else k
        v = k if v is None else v
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        wq, wk, wv = self.in_w.chunk(3, dim=0)
        bq = bk = bv = None
        if self.use_bias:
            bq, bk, bv = self.in_b.chunk(3, dim=0)

        def proj(x, w, b):
            y = x @ w.T
            if b is not None:
                y = y + b
            B, T, _ = y.shape
            return y.reshape(B, T, H, hd).transpose(1, 2)  # (B, H, T, hd), a view

        qh, kh, vh = proj(q, wq, bq), proj(k, wk, bk), proj(v, wv, bv)
        if self.flash:
            if mask is not None:
                raise ValueError("flash=True supports only is_causal masks")
            o = flash_attention(qh, kh, vh, is_causal=is_causal)
        else:
            o = scaled_dot_product_attention(qh, kh, vh, mask=mask, is_causal=is_causal)
        B, _, T, _ = o.shape
        o = o.transpose(1, 2).reshape(B, T, E) @ self.out_w.T
        return o + self.out_b if self.use_bias else o


__all__ = ["MultiheadAttention", "scaled_dot_product_attention"]
