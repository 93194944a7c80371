"""VGG16 (configuration D) and AlexNet (torchvision's single tower), the
counterparts of the JAX package's ``of_spmm_tpu/models/vision.py``.

NCHW / OIHW; parameters ``conv_<i>`` and ``fc_<i>`` as the JAX trees are
keyed (``interop.vgg16_params_from_numpy``,
``interop.alexnet_params_from_numpy``). ``forward(x, train=False,
generator=None)`` returns the logits; dropout runs only with
``train=True`` and a generator, as the JAX models' runs only with an rng.
VGG16 applies ReLU then dropout after each of its first two FC layers;
AlexNet applies dropout before each of them. AlexNet's adaptive pool to
6x6 is the identity at 224 x 224.

``device=None`` is the card (raising without one); ``generator`` (CPU)
seeds the initial weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.utils.device import resolve_device

# VGG16 configuration "D": conv channels per stage, "M" a 2x2 max pool
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")


class _ConvNet(torch.nn.Module):
    """Convolutions ``conv_<i>``, three linear layers ``fc_<i>``."""

    def __init__(self, convs, fc_in: int, n_classes: int, dropout: float, dev, generator):
        super().__init__()
        self.n_classes, self.dropout = int(n_classes), float(dropout)
        for i, (cin, cout, k, s, p) in enumerate(convs):
            self.add_module(f"conv_{i}", onn.Conv2d(cin, cout, k, stride=s, padding=p,
                                                    device=dev, generator=generator))
        for i, (fin, fout) in enumerate(((fc_in, 4096), (4096, 4096), (4096, self.n_classes))):
            self.add_module(f"fc_{i}", onn.Linear(fin, fout, device=dev, generator=generator))

    def _drop(self, h: torch.Tensor, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if train and generator is not None:
            return onn.Dropout(self.dropout)(h, train=True, generator=generator)
        return h


class VGG16(_ConvNet):
    """VGG-16: thirteen 3x3 convolutions with ReLU, five max pools, three
    FC layers."""

    def __init__(self, n_classes: int = 1000, in_ch: int = 3, dropout: float = 0.5,
                 device=None, generator: Optional[torch.Generator] = None):
        chans = [c for c in _VGG16_CFG if c != "M"]
        convs = [(cin, cout, 3, 1, 1) for cin, cout in zip([in_ch] + chans[:-1], chans)]
        super().__init__(convs, 512 * 7 * 7, n_classes, dropout, resolve_device(device),
                         generator)
        self.pool = onn.MaxPool2d(2, stride=2)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, ci = x, 0
        for c in _VGG16_CFG:
            if c == "M":
                h = self.pool(h)
            else:
                h = torch.relu(getattr(self, f"conv_{ci}")(h))
                ci += 1
        h = h.reshape(h.shape[0], -1)
        for i in range(2):
            h = self._drop(torch.relu(getattr(self, f"fc_{i}")(h)), train, generator)
        return self.fc_2(h)


class AlexNet(_ConvNet):
    """AlexNet: five convolutions (max pools after the 1st, 2nd and 5th),
    an adaptive average pool to 6x6, three FC layers."""

    def __init__(self, n_classes: int = 1000, in_ch: int = 3, dropout: float = 0.5,
                 device=None, generator: Optional[torch.Generator] = None):
        convs = [(in_ch, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
                 (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
        super().__init__(convs, 256 * 6 * 6, n_classes, dropout, resolve_device(device),
                         generator)
        self.pool = onn.MaxPool2d(3, stride=2)
        self.avgpool = onn.AdaptiveAvgPool2d(6)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(5):
            h = torch.relu(getattr(self, f"conv_{i}")(h))
            if i in (0, 1, 4):
                h = self.pool(h)
        h = self.avgpool(h)
        h = h.reshape(h.shape[0], -1)
        for i in range(2):
            h = torch.relu(getattr(self, f"fc_{i}")(self._drop(h, train, generator)))
        return self.fc_2(h)


def vgg16(n_classes: int = 1000, device=None,
          generator: Optional[torch.Generator] = None) -> VGG16:
    return VGG16(n_classes=n_classes, device=device, generator=generator)


def alexnet(n_classes: int = 1000, device=None,
            generator: Optional[torch.Generator] = None) -> AlexNet:
    return AlexNet(n_classes=n_classes, device=device, generator=generator)
