"""``Sequential`` and parameter accounting, the counterparts of the JAX
package's ``of_spmm_tpu/nn/module.py``.

The JAX package keeps parameters and mutable state (BatchNorm's running
statistics) in trees apart from the modules; here they are the modules'
parameters and buffers. ``Sequential`` names its children ``layer_<i>``
as the JAX trees are keyed, so ``interop.sequential_params_from_numpy``
carries a JAX Sequential's parameters and state over.
"""

from __future__ import annotations

import inspect
from typing import Any, Mapping, Optional

import numpy as np
import torch


def _leaves(obj: Any) -> list:
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    if isinstance(obj, Mapping):
        return [leaf for v in obj.values() for leaf in _leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [leaf for v in obj for leaf in _leaves(v)]
    return [] if obj is None else [obj]


def _size(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else int(np.asarray(leaf).size)


def _itemsize(leaf) -> int:
    return leaf.element_size() if isinstance(leaf, torch.Tensor) else np.asarray(leaf).itemsize


def param_count(params: Any) -> int:
    """The number of scalar parameters of a module (its buffers not
    counted), or of the leaves of a tree of tensors or arrays."""
    return sum(_size(leaf) for leaf in _leaves(params))


def param_bytes(params: Any) -> int:
    """The bytes of the same leaves."""
    return sum(_size(leaf) * _itemsize(leaf) for leaf in _leaves(params))


def is_stateful(module: Any) -> bool:
    """True if the module holds mutable state: buffers (BatchNorm's running
    statistics), its own or its children's."""
    return isinstance(module, torch.nn.Module) and next(module.buffers(), None) is not None


def _accepts(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


class Sequential(torch.nn.Module):
    """Apply layers in turn; modules become children ``layer_<i>``.

    A layer may be a module or a bare callable (an activation function).
    ``forward(x, train=False, generator=None)`` passes ``train`` to each
    module whose ``forward`` takes it (so a BatchNorm child updates its
    buffers) and ``generator`` to each that takes one (Dropout); the one
    generator stands in for the JAX package's per-layer rng keys."""

    def __init__(self, *layers: Any):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (tuple, list)):
            layers = tuple(layers[0])
        self._calls = []
        for i, layer in enumerate(layers):
            if isinstance(layer, torch.nn.Module):
                self.add_module(f"layer_{i}", layer)
                self._calls.append((f"layer_{i}", _accepts(layer.forward, "train"),
                                    _accepts(layer.forward, "generator")))
            elif callable(layer):
                self._calls.append((layer, False, False))
            else:
                raise TypeError(f"layer {i} is neither a module nor callable: {layer!r}")

    def __len__(self) -> int:
        return len(self._calls)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer, takes_train, takes_generator in self._calls:
            if isinstance(layer, str):
                kw = {}
                if takes_train:
                    kw["train"] = train
                if takes_generator:
                    kw["generator"] = generator
                x = getattr(self, layer)(x, **kw)
            else:
                x = layer(x)
        return x


__all__ = ["Sequential", "is_stateful", "param_bytes", "param_count"]
