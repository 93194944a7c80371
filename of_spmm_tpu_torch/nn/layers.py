"""Dense layers of the transformer path, as ``torch.nn.Module``s.

Counterparts of the JAX package's ``of_spmm_tpu/nn/layers.py`` modules,
with the same parameter names, shapes and initial distributions, so a
JAX parameter tree carries over unchanged (interop.py):

- ``Linear``: y = x @ w + b with w stored (in, out); w and b uniform in
  +-1/sqrt(in).
- ``Dropout``: the identity unless ``train=True``, which needs an explicit
  ``torch.Generator``.
- ``LayerNorm``: population variance, eps 1e-5, ``gamma`` / ``beta``.
- ``Embedding``: the package gather, so an index outside the table gives
  a zero row (``F.embedding`` would raise).
- ``gelu``: the tanh approximation, as ``jax.nn.gelu`` is by default.

Each module takes ``device`` (None: the card, raising without one) and an
optional CPU ``generator`` for its initial values.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.ops.reference import gather
from of_spmm_tpu_torch.utils.device import resolve_device


def _uniform(shape, bound: float, device, generator) -> torch.nn.Parameter:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return torch.nn.Parameter(((u * 2 - 1) * bound).to(device))


class Linear(torch.nn.Module):
    """y = x @ w + b (w stored (in_features, out_features))."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        bound = math.sqrt(1.0 / max(in_features, 1))
        self.w = _uniform((in_features, out_features), bound, dev, generator)
        self.b = _uniform((out_features,), bound, dev, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class Dropout(torch.nn.Module):
    """Inverted dropout; the identity unless ``train=True``."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout(train=True) requires a generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
        return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


class LayerNorm(torch.nn.Module):
    """Normalise over the last ``len(normalized_shape)`` axes (population
    variance), then scale by ``gamma`` and shift by ``beta``."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]], eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.eps = float(eps)
        self.gamma = self.beta = None
        if elementwise_affine:
            self.gamma = torch.nn.Parameter(torch.ones(self.normalized_shape, device=dev))
            self.beta = torch.nn.Parameter(torch.zeros(self.normalized_shape, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.gamma, self.beta, self.eps)


class Embedding(torch.nn.Module):
    """Row lookup through the package gather: weight[indices], with a zero
    row for an index outside [0, num_embeddings). ``weight`` is N(0, 1);
    row ``padding_idx``, if given, starts at zero."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embedding_dim = int(embedding_dim)
        w = torch.randn((num_embeddings, embedding_dim), generator=generator,
                        dtype=torch.float32)
        if padding_idx is not None:
            w[padding_idx] = 0.0
        self.weight = torch.nn.Parameter(w.to(dev))

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        out = gather(self.weight, indices.reshape(-1))
        return out.reshape(*indices.shape, self.embedding_dim)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu``'s default form)."""
    return F.gelu(x, approximate="tanh")
