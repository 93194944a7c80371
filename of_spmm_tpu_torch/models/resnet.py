"""ResNet-50 / ResNet-101, the counterparts of the JAX package's
``of_spmm_tpu/models/resnet.py``.

Bottleneck blocks (1x1 -> 3x3 -> 1x1, expansion 4, the 3x3 strided at
the first block of each stage after the first), NCHW / OIHW, a 7x7
stride-2 stem, a 3x3 stride-2 max pool, global average pooling and a
linear head. Parameters and buffers are named as the JAX trees are
keyed: ``stem_conv``, ``stem_bn``, ``block_<i>.conv<j>``, ``.bn<j>``,
``.down_conv``, ``.down_bn``, ``head``; ``interop.resnet_params_from_numpy``
carries a JAX ResNet's parameters and BatchNorm state over.

``forward(x, train=False)`` returns the logits. With ``train=True`` every
BatchNorm normalises with the batch's statistics and updates its running
``mean`` / ``var`` in place (the JAX model returns ``(logits,
new_state)``). The BatchNorms run on NCHW directly
(``BatchNorm.channels_first``) where the JAX model moves the channel axis
last and back. The ReLUs call ``torch.relu``.

``device=None`` is the card (raising without one); ``generator`` (CPU)
seeds the initial weights.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.utils.device import resolve_device


class Bottleneck(torch.nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with a residual; 4 * mid_ch outputs."""

    def __init__(self, in_ch: int, mid_ch: int, stride: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.out_ch = 4 * mid_ch
        shapes = ((in_ch, mid_ch, 1, 1, 0), (mid_ch, mid_ch, 3, stride, 1),
                  (mid_ch, self.out_ch, 1, 1, 0))
        for j, (cin, cout, k, s, p) in enumerate(shapes):
            self.add_module(f"conv{j}", onn.Conv2d(cin, cout, k, stride=s, padding=p,
                                                   use_bias=False, device=dev,
                                                   generator=generator))
            self.add_module(f"bn{j}", onn.BatchNorm(cout, device=dev))
        self.down_conv = self.down_bn = None
        if stride != 1 or in_ch != self.out_ch:
            self.down_conv = onn.Conv2d(in_ch, self.out_ch, 1, stride=stride, use_bias=False,
                                        device=dev, generator=generator)
            self.down_bn = onn.BatchNorm(self.out_ch, device=dev)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for j in range(3):
            h = getattr(self, f"bn{j}").channels_first(getattr(self, f"conv{j}")(h), train)
            if j < 2:
                h = torch.relu(h)
        shortcut = x
        if self.down_conv is not None:
            shortcut = self.down_bn.channels_first(self.down_conv(x), train)
        return torch.relu(h + shortcut)


class ResNet(torch.nn.Module):
    """ResNet with Bottleneck stages; ``layers`` blocks a stage (ResNet-50:
    (3, 4, 6, 3)), stage widths ``width`` * 2^s."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), n_classes: int = 1000,
                 in_ch: int = 3, width: int = 64, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.layers, self.n_classes = tuple(layers), int(n_classes)
        self.stem_conv = onn.Conv2d(in_ch, width, 7, stride=2, padding=3, use_bias=False,
                                    device=dev, generator=generator)
        self.stem_bn = onn.BatchNorm(width, device=dev)
        self.stem_pool = onn.MaxPool2d(3, stride=2, padding=1)
        in_c, mid, i = width, width, 0
        for si, n in enumerate(self.layers):
            for bi in range(n):
                block = Bottleneck(in_c, mid, 2 if (si > 0 and bi == 0) else 1, device=dev,
                                   generator=generator)
                self.add_module(f"block_{i}", block)
                in_c, i = block.out_ch, i + 1
            mid *= 2
        self.n_blocks = i
        self.head = onn.Linear(in_c, self.n_classes, device=dev, generator=generator)

    def stem(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """7x7 stride-2 convolution, BatchNorm, ReLU, 3x3 stride-2 max pool."""
        return self.stem_pool(torch.relu(self.stem_bn.channels_first(self.stem_conv(x), train)))

    def classify(self, h: torch.Tensor) -> torch.Tensor:
        """Global average pooling and the linear head."""
        return self.head(h.mean(dim=(2, 3)))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.stem(x, train)
        for i in range(self.n_blocks):
            h = getattr(self, f"block_{i}")(h, train)
        return self.classify(h)


def resnet50(n_classes: int = 1000, device=None,
             generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), n_classes, device=device, generator=generator)


def resnet101(n_classes: int = 1000, device=None,
              generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet((3, 4, 23, 3), n_classes, device=device, generator=generator)
