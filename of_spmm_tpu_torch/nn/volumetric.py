"""The N-d convolutions and pools beyond 2-D, adaptive pooling and the
parametric and shrink activations: the counterparts of the JAX package's
``of_spmm_tpu/nn/volumetric.py``.

- ``Conv3d`` (NCDHW / OIDHW), ``ConvTranspose1d`` / ``ConvTranspose3d``
  (IO*): the modules of nn/conv.py at one and three spatial axes.
- ``MaxPool{1,3}d`` / ``AvgPool{1,3}d``: nn/conv.py's pooling at one and
  three spatial axes.
- ``AdaptiveMaxPool{1,2,3}d`` / ``AdaptiveAvgPool{1,3}d``: torch's window
  rule (start = floor(i In / Out), end = ceil((i + 1) In / Out)), which
  the JAX module writes out, for any output size:
  ``F.adaptive_{max,avg}_pool{n}d``.
- ``PReLU`` (``a``: one slope, or one per channel of axis 1, 0.25 at
  first), ``GLU``, and the functions ``hardshrink``, ``softshrink``,
  ``tanhshrink``, ``softsign``, ``logsigmoid``, ``threshold``, ``elu``,
  ``leaky_relu``: torch's functions of the same rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.nn.conv import Size, _ConvNd, _ConvTransposeNd, _PoolNd, _tup
from of_spmm_tpu_torch.nn.layers import elu, leaky_relu
from of_spmm_tpu_torch.utils.device import resolve_device


class Conv3d(_ConvNd):
    """3-D convolution, NCDHW / OIDHW."""

    _nd = 3


class ConvTranspose1d(_ConvTransposeNd):
    _nd = 1


class ConvTranspose3d(_ConvTransposeNd):
    _nd = 3


class MaxPool1d(_PoolNd):
    _nd, _kind = 1, "max"


class MaxPool3d(_PoolNd):
    _nd, _kind = 3, "max"


class AvgPool1d(_PoolNd):
    _nd, _kind = 1, "avg"


class AvgPool3d(_PoolNd):
    _nd, _kind = 3, "avg"


class _AdaptivePoolNd(torch.nn.Module):
    _nd, _kind = 3, "max"

    def __init__(self, output_size: Size = 1):
        super().__init__()
        self.output_size = _tup(output_size, self._nd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = getattr(F, f"adaptive_{self._kind}_pool{self._nd}d")
        return fn(x, self.output_size)


class AdaptiveMaxPool1d(_AdaptivePoolNd):
    _nd, _kind = 1, "max"


class AdaptiveMaxPool2d(_AdaptivePoolNd):
    _nd, _kind = 2, "max"


class AdaptiveMaxPool3d(_AdaptivePoolNd):
    _nd, _kind = 3, "max"


class AdaptiveAvgPool1d(_AdaptivePoolNd):
    _nd, _kind = 1, "avg"


class AdaptiveAvgPool3d(_AdaptivePoolNd):
    _nd, _kind = 3, "avg"


class PReLU(torch.nn.Module):
    """max(0, x) + a min(0, x), ``a`` one slope or one per channel (axis 1)."""

    def __init__(self, num_parameters: int = 1, init_value: float = 0.25, device=None):
        super().__init__()
        self.a = torch.nn.Parameter(torch.full((num_parameters,), float(init_value),
                                               device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.a)


class GLU(torch.nn.Module):
    """a * sigmoid(b), a and b the two halves of ``axis``."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = int(axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.glu(x, self.axis)


def hardshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    return F.hardshrink(x, lambd)


def softshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    return F.softshrink(x, lambd)


def tanhshrink(x: torch.Tensor) -> torch.Tensor:
    return F.tanhshrink(x)


def softsign(x: torch.Tensor) -> torch.Tensor:
    return F.softsign(x)


def logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.logsigmoid(x)


def threshold(x: torch.Tensor, threshold_val: float, value: float) -> torch.Tensor:
    """x where x > threshold_val, else value."""
    return F.threshold(x, threshold_val, value)


__all__ = ["AdaptiveAvgPool1d", "AdaptiveAvgPool3d", "AdaptiveMaxPool1d", "AdaptiveMaxPool2d",
           "AdaptiveMaxPool3d", "AvgPool1d", "AvgPool3d", "Conv3d", "ConvTranspose1d",
           "ConvTranspose3d", "GLU", "MaxPool1d", "MaxPool3d", "PReLU", "elu", "hardshrink",
           "leaky_relu", "logsigmoid", "softshrink", "softsign", "tanhshrink", "threshold"]
