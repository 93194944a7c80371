"""Convolution and pooling modules, the counterparts of the JAX package's
``of_spmm_tpu/nn/conv.py``.

Torch layouts as the JAX modules keep them: NCHW inputs, weights ``w``
OIHW (``ConvTranspose2d``: IOHW), bias ``b``. The convolutions are
``F.conv{1,2}d`` / ``F.conv_transpose2d`` (cuDNN on the card) with the
JAX modules' arguments:

- ``Conv2d`` / ``Conv1d``: stride, symmetric padding, dilation, groups;
  ``w`` and ``b`` uniform in +-sqrt(1 / fan_in), fan_in = in / groups * k.
- ``ConvTranspose2d``: out = (in - 1) * stride - 2 * padding + k; no
  ``output_padding`` and no ``groups``; fan_in = in_channels * k * k.
- ``MaxPool2d`` pads with -inf; ``AvgPool2d`` divides by k * k, padding
  included (torch's ``count_include_pad=True``). Where a padding exceeds
  half its window, which torch's pools refuse and the JAX ones take, the
  input is padded first.
- ``AdaptiveAvgPool2d`` takes only output sizes that divide the input
  (``NotImplementedError`` otherwise), as the JAX module does.

Each convolution takes ``device`` (None: the card, raising without one)
and an optional CPU ``generator`` for its initial values (``w``, then
``b``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.nn.layers import kaiming_uniform
from of_spmm_tpu_torch.utils.device import resolve_device

Size = Union[int, Sequence[int]]


def _tup(v: Size, n: int) -> Tuple[int, ...]:
    return (int(v),) * n if isinstance(v, int) else tuple(int(u) for u in v)


class _ConvNd(torch.nn.Module):
    """N-d convolution, NC* / OI* (``F.conv{nd}d``)."""

    _nd = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Size, stride: Size = 1,
                 padding: Size = 0, dilation: Size = 1, groups: int = 1, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        nd = self._nd
        k = _tup(kernel_size, nd)
        self.stride, self.padding = _tup(stride, nd), _tup(padding, nd)
        self.dilation, self.groups = _tup(dilation, nd), int(groups)
        fan_in = in_channels // groups * math.prod(k)
        self.w = kaiming_uniform((out_channels, in_channels // groups) + k, fan_in, dev,
                                 generator)
        self.b = kaiming_uniform((out_channels,), fan_in, dev, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(F, f"conv{self._nd}d")
        return conv(x, self.w, self.b, self.stride, self.padding, self.dilation, self.groups)


class Conv2d(_ConvNd):
    """2-D convolution, NCHW / OIHW."""

    _nd = 2


class Conv1d(_ConvNd):
    """1-D convolution, NCL / OIL."""

    _nd = 1


class _ConvTransposeNd(torch.nn.Module):
    """N-d transposed convolution, NC* / IO* (``F.conv_transpose{nd}d``)."""

    _nd = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Size, stride: Size = 1,
                 padding: Size = 0, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        nd = self._nd
        k = _tup(kernel_size, nd)
        self.stride, self.padding = _tup(stride, nd), _tup(padding, nd)
        fan_in = in_channels * math.prod(k)
        self.w = kaiming_uniform((in_channels, out_channels) + k, fan_in, dev, generator)
        self.b = kaiming_uniform((out_channels,), fan_in, dev, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(F, f"conv_transpose{self._nd}d")
        return conv(x, self.w, self.b, self.stride, self.padding)


class ConvTranspose2d(_ConvTransposeNd):
    """2-D transposed convolution, NCHW / IOHW."""

    _nd = 2


def _pool(x: torch.Tensor, kernel_size: Size, stride: Optional[Size], padding: Size,
          nd: int, kind: str) -> torch.Tensor:
    """Max (``kind="max"``) or average pooling over the last ``nd`` axes;
    the stride defaults to the window."""
    k = _tup(kernel_size, nd)
    s = _tup(stride, nd) if stride is not None else k
    pad = _tup(padding, nd)
    if any(p > kk // 2 for p, kk in zip(pad, k)):
        fill = -math.inf if kind == "max" else 0.0
        x = F.pad(x, [q for p in reversed(pad) for q in (p, p)], value=fill)
        pad = (0,) * nd
    if kind == "max":
        return getattr(F, f"max_pool{nd}d")(x, k, s, pad)
    return getattr(F, f"avg_pool{nd}d")(x, k, s, pad, count_include_pad=True)


class _PoolNd(torch.nn.Module):
    _nd, _kind = 2, "max"

    def __init__(self, kernel_size: Size, stride: Optional[Size] = None, padding: Size = 0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(x, self.kernel_size, self.stride, self.padding, self._nd, self._kind)


class MaxPool2d(_PoolNd):
    _nd, _kind = 2, "max"


class AvgPool2d(_PoolNd):
    _nd, _kind = 2, "avg"


class AdaptiveAvgPool2d(torch.nn.Module):
    """Adaptive average pooling to output sizes that divide the input (the
    ResNet head's (1, 1), AlexNet's (6, 6))."""

    def __init__(self, output_size: Size = 1):
        super().__init__()
        self.output_size = _tup(output_size, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (oh, ow), (h, w) = self.output_size, x.shape[2:]
        if (oh, ow) != (1, 1) and (h % oh or w % ow):
            raise NotImplementedError(
                f"adaptive pooling needs output {oh}x{ow} to divide input {h}x{w}")
        return F.adaptive_avg_pool2d(x, (oh, ow))


__all__ = ["AdaptiveAvgPool2d", "AvgPool2d", "Conv1d", "Conv2d", "ConvTranspose2d", "MaxPool2d"]
