"""Transformer encoder (BERT-style), the counterpart of the JAX package's
``of_spmm_tpu/models/transformer.py``.

Pre-LN encoder blocks over batch-first (B, T, E) activations: token and
position embeddings (a position at or past ``max_len`` gives a zero row,
through the package gather), blocks of x + attn(ln1(x)) and
x + fc2(gelu(fc1(ln2(x)))), a final LayerNorm, and, when ``n_classes``
is set, a linear head on the first (CLS) position. The defaults are
BERT-base: 12 layers, width 768, 12 heads, MLP 3072, max_len 512,
vocabulary 30522.

As in the JAX package, the blocks build their attention without
``flash``: the dense attention core. ``MultiheadAttention(flash=True)``
drives the flash kernel on the same parameters.

Parameters carry over from the JAX package's tree with
``interop.transformer_params_from_numpy``.
"""

from __future__ import annotations

from typing import Optional

import torch

from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.utils.device import resolve_device


class EncoderBlock(torch.nn.Module):
    """One pre-LN block: ``ln1``, ``attn``, ``ln2``, ``fc1``, ``fc2``."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int, dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dropout = float(dropout)
        self.ln1 = onn.LayerNorm(embed_dim, device=dev)
        self.attn = onn.MultiheadAttention(embed_dim, num_heads, device=dev,
                                           generator=generator)
        self.ln2 = onn.LayerNorm(embed_dim, device=dev)
        self.fc1 = onn.Linear(embed_dim, mlp_dim, device=dev, generator=generator)
        self.fc2 = onn.Linear(mlp_dim, embed_dim, device=dev, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.ln1(x), mask=mask)
        if train and self.dropout > 0 and generator is not None:
            h = onn.Dropout(self.dropout)(h, train=True, generator=generator)
        x = x + h
        return x + self.fc2(onn.gelu(self.fc1(self.ln2(x))))


class TransformerEncoder(torch.nn.Module):
    """BERT-style encoder; BERT-base defaults.

    ``forward(tokens)`` takes int (B, T) token ids and returns the hidden
    states (B, T, E), or the CLS logits (B, n_classes) when ``n_classes``
    is set. ``train=True`` applies dropout (when ``dropout > 0``) with the
    given ``generator``, which stands in for the JAX package's per-layer
    rng keys. ``device=None`` is the card (raising without one);
    ``generator`` (CPU) also seeds the initial weights.
    """

    def __init__(self, vocab_size: int = 30522, max_len: int = 512, embed_dim: int = 768,
                 num_heads: int = 12, num_layers: int = 12, mlp_dim: int = 3072,
                 n_classes: Optional[int] = None, dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size, self.max_len, self.embed_dim = vocab_size, max_len, embed_dim
        self.num_heads, self.num_layers, self.mlp_dim = num_heads, num_layers, mlp_dim
        self.n_classes, self.dropout = n_classes, float(dropout)
        self.tok = onn.Embedding(vocab_size, embed_dim, device=dev, generator=generator)
        self.pos = onn.Embedding(max_len, embed_dim, device=dev, generator=generator)
        self.ln_f = onn.LayerNorm(embed_dim, device=dev)
        self.head = (onn.Linear(embed_dim, n_classes, device=dev, generator=generator)
                     if n_classes is not None else None)
        self.blocks = torch.nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_dim, dropout, device=dev,
                         generator=generator)
            for _ in range(num_layers))

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T = tokens.shape[1]
        positions = torch.arange(T, device=tokens.device)
        h = self.tok(tokens) + self.pos(positions)[None, :, :]
        for block in self.blocks:
            h = block(h, train=train, generator=generator)
        h = self.ln_f(h)
        if self.head is not None:
            return self.head(h[:, 0, :])  # CLS pooling
        return h


def bert_base(n_classes: Optional[int] = None, device=None,
              generator: Optional[torch.Generator] = None) -> TransformerEncoder:
    return TransformerEncoder(n_classes=n_classes, device=device, generator=generator)


def bert_tiny(n_classes: Optional[int] = None, device=None,
              generator: Optional[torch.Generator] = None) -> TransformerEncoder:
    """4 layers, width 128, for tests and smoke runs."""
    return TransformerEncoder(vocab_size=1000, max_len=128, embed_dim=128, num_heads=4,
                              num_layers=4, mlp_dim=512, n_classes=n_classes, device=device,
                              generator=generator)
