"""Dense layers, norms and activations, as ``torch.nn.Module``s and
functions.

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
- ``BatchNorm``: features on the **last** axis (``forward``), or on axis
  1 (``channels_first``, NCHW, which ResNet uses). ``gamma`` / ``beta``,
  running ``mean`` / ``var`` as buffers. ``train=True`` normalises with
  the batch's population variance and updates the buffers in place,
  (1 - m) * running + m * batch with the unbiased batch variance; the
  JAX module returns ``(y, new_state)`` instead. Eval mode uses the
  buffers. Both are ``F.batch_norm`` on the channel axis.
- ``GroupNorm`` (``F.group_norm``) and ``InstanceNorm2d``
  (``F.instance_norm``, ``affine=False`` by default), population variance.
- The activations ``relu``, ``silu``, ``sigmoid``, ``tanh``, ``softmax``,
  ``log_softmax`` (axis -1), ``leaky_relu`` (slope 0.01) and ``elu``
  (alpha 1), with ``jax.nn``'s defaults. ``relu`` looks ``torch.relu`` up
  at each call, so a patched ``torch.relu`` sees every call.

Each module with parameters takes ``device`` (None: the card, raising
without one) and an optional CPU ``generator`` for its initial values.
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


def kaiming_uniform(shape, fan_in: int, device, generator) -> torch.nn.Parameter:
    """Uniform in +-sqrt(1 / fan_in) (the JAX package's ``_kaiming_uniform``)."""
    return _uniform(shape, math.sqrt(1.0 / max(fan_in, 1)), device, generator)


def _affine(n: int, affine: bool, device):
    if not affine:
        return None, None
    return (torch.nn.Parameter(torch.ones(n, device=device)),
            torch.nn.Parameter(torch.zeros(n, device=device)))


class Linear(torch.nn.Module):
    """y = x @ w + b (w stored (in_features, out_features))."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.w = kaiming_uniform((in_features, out_features), in_features, dev, generator)
        self.b = kaiming_uniform((out_features,), in_features, dev, generator) if use_bias else None

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


class BatchNorm(torch.nn.Module):
    """Batch normalisation over the features of the last axis, with running
    statistics (buffers ``mean`` / ``var``) updated in place under
    ``train=True``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_features, self.eps, self.momentum = int(num_features), float(eps), float(momentum)
        self.gamma, self.beta = _affine(self.num_features, affine, dev)
        self.register_buffer("mean", torch.zeros(self.num_features, device=dev))
        self.register_buffer("var", torch.ones(self.num_features, device=dev))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.channels_first(x.movedim(-1, 1), train).movedim(1, -1)

    def channels_first(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The same normalisation of ``x`` with its features on axis 1."""
        return F.batch_norm(x, self.mean, self.var, self.gamma, self.beta, training=train,
                            momentum=self.momentum, eps=self.eps)


class GroupNorm(torch.nn.Module):
    """Group normalisation over (N, C, *spatial) inputs."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, device=None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError("num_channels must divide num_groups")
        dev = resolve_device(device)
        self.num_groups, self.eps = int(num_groups), float(eps)
        self.gamma, self.beta = _affine(int(num_channels), affine, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.gamma, self.beta, self.eps)


class InstanceNorm2d(torch.nn.Module):
    """Per-(sample, channel) normalisation over H and W of NCHW inputs."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = False,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.eps = float(eps)
        self.gamma, self.beta = _affine(int(num_features), affine, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, weight=self.gamma, bias=self.beta, eps=self.eps)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return F.elu(x, alpha)
