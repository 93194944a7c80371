"""Resizing, padding, pixel shuffle, distances, losses and activations:
the counterparts of the JAX package's ``of_spmm_tpu/nn/extras.py``.

Delegated to torch, whose rule is the JAX module's: nearest
``interpolate`` (``F.interpolate`` given the output size), the pads
(``F.pad``: zeros, "reflect", "replicate"), ``pixel_shuffle`` /
``pixel_unshuffle``, ``Flatten``, ``hardsigmoid``, ``hardswish``,
``hardtanh``, ``mish``, ``softplus``, ``glu``, ``selu``, ``celu``.

Written out, as the JAX module computes them:

- bilinear ``interpolate``: an output position i maps to the input at
  (i + 0.5) In / Out - 0.5, clipped to [0, In - 1] (i (In - 1) / (Out - 1)
  with ``align_corners`` and Out > 1). With ``scale_factor`` the output
  size is int(In * factor) and the map still uses In / Out, where
  ``F.interpolate`` uses 1 / factor: the two differ at a factor that does
  not divide evenly (1.5, 0.6).
- ``cosine_similarity`` (each norm clamped by eps before the division),
  ``pairwise_distance`` (sum |a - b + eps|^p)^(1/p), ``kl_div`` (input
  log-probabilities; 0 where the target is <= 0; reduction "mean",
  "sum" or "none" only: no "batchmean"), ``margin_ranking_loss``,
  ``hinge_embedding_loss``, ``triplet_margin_loss``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Factor = Union[float, Tuple[float, float]]


def _out_size(h: int, w: int, scale_factor: Optional[Factor],
              size: Optional[Sequence[int]]) -> Tuple[int, int]:
    if size is not None:
        return int(size[0]), int(size[1])
    if scale_factor is None:
        raise ValueError("one of size/scale_factor is required")
    sf = (scale_factor, scale_factor) if isinstance(scale_factor, (int, float)) else scale_factor
    return int(h * sf[0]), int(w * sf[1])


def _src_coords(out_len: int, in_len: int, align_corners: bool, device) -> torch.Tensor:
    """Each output position's input coordinate, in float32 as JAX has it."""
    i = torch.arange(out_len, dtype=torch.float32, device=device)
    if align_corners and out_len > 1:
        return i * ((in_len - 1) / (out_len - 1))
    return torch.clamp((i + 0.5) * (in_len / out_len) - 0.5, 0, in_len - 1)


def interpolate(x: torch.Tensor, scale_factor: Optional[Factor] = None,
                size: Optional[Sequence[int]] = None, mode: str = "nearest",
                align_corners: bool = False) -> torch.Tensor:
    """NCHW spatial resize, "nearest" or "bilinear"."""
    if x.ndim != 4:
        raise ValueError(f"interpolate expects NCHW, got ndim={x.ndim}")
    h, w = x.shape[2], x.shape[3]
    oh, ow = _out_size(h, w, scale_factor, size)
    if mode == "nearest":
        return F.interpolate(x, size=(oh, ow), mode="nearest")
    if mode != "bilinear":
        raise ValueError(f"unsupported mode {mode!r}")
    ys = _src_coords(oh, h, align_corners, x.device)
    xs = _src_coords(ow, w, align_corners, x.device)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy, wx = (ys - y0).to(x.dtype)[:, None], (xs - x0).to(x.dtype)
    top, bot = x[:, :, y0], x[:, :, y1]
    top = top[..., x0] * (1 - wx) + top[..., x1] * wx
    bot = bot[..., x0] * (1 - wx) + bot[..., x1] * wx
    return top * (1 - wy) + bot * wy


class Upsample(torch.nn.Module):
    def __init__(self, scale_factor: Optional[Factor] = None,
                 size: Optional[Sequence[int]] = None, mode: str = "nearest",
                 align_corners: bool = False):
        super().__init__()
        self.scale_factor, self.size = scale_factor, size
        self.mode, self.align_corners = mode, align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return interpolate(x, self.scale_factor, self.size, self.mode, self.align_corners)


def _pad4(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        return (padding,) * 4
    p = tuple(padding)
    if len(p) != 4:
        raise ValueError("padding must be int or (left, right, top, bottom)")
    return p


class _Pad2d(torch.nn.Module):
    _mode = "constant"

    def __init__(self, padding: Union[int, Tuple[int, int, int, int]]):
        super().__init__()
        self.padding = _pad4(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, self.padding, mode=self._mode)


class ZeroPad2d(_Pad2d):
    _mode = "constant"


class ReflectionPad2d(_Pad2d):
    _mode = "reflect"


class ReplicationPad2d(_Pad2d):
    _mode = "replicate"


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    r = upscale_factor
    if x.shape[1] % (r * r):
        raise ValueError(f"channels {x.shape[1]} not divisible by {r}^2")
    return F.pixel_shuffle(x, r)


def pixel_unshuffle(x: torch.Tensor, downscale_factor: int) -> torch.Tensor:
    r = downscale_factor
    h, w = x.shape[2], x.shape[3]
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {r}")
    return F.pixel_unshuffle(x, r)


class PixelShuffle(torch.nn.Module):
    def __init__(self, upscale_factor: int):
        super().__init__()
        self.upscale_factor = int(upscale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.upscale_factor)


class Flatten(torch.nn.Module):
    def __init__(self, start_dim: int = 1, end_dim: int = -1):
        super().__init__()
        self.start_dim, self.end_dim = int(start_dim), int(end_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flatten(x, self.start_dim, self.end_dim)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, axis: int = 1,
                      eps: float = 1e-8) -> torch.Tensor:
    dot = torch.sum(a * b, dim=axis)
    na = torch.sqrt(torch.sum(a * a, dim=axis))
    nb = torch.sqrt(torch.sum(b * b, dim=axis))
    return dot / (torch.clamp(na, min=eps) * torch.clamp(nb, min=eps))


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, p: float = 2.0,
                      eps: float = 1e-6) -> torch.Tensor:
    return torch.sum(torch.abs(a - b + eps) ** p, dim=-1) ** (1.0 / p)


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"bad reduction {reduction!r}")


def kl_div(logp: torch.Tensor, target: torch.Tensor, reduction: str = "mean",
           log_target: bool = False) -> torch.Tensor:
    """KL divergence loss; ``logp`` holds log-probabilities."""
    if log_target:
        loss = torch.exp(target) * (target - logp)
    else:
        loss = torch.where(target > 0, target * (torch.log(torch.clamp(target, min=1e-38)) - logp),
                           torch.zeros((), dtype=logp.dtype, device=logp.device))
    return _reduce(loss, reduction)


def margin_ranking_loss(x1: torch.Tensor, x2: torch.Tensor, y: torch.Tensor,
                        margin: float = 0.0, reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.clamp(-y * (x1 - x2) + margin, min=0.0), reduction)


def hinge_embedding_loss(x: torch.Tensor, y: torch.Tensor, margin: float = 1.0,
                         reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.where(y == 1, x, torch.clamp(margin - x, min=0.0)), reduction)


def triplet_margin_loss(anchor: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                        margin: float = 1.0, p: float = 2.0, eps: float = 1e-6,
                        reduction: str = "mean") -> torch.Tensor:
    dp = pairwise_distance(anchor, pos, p, eps)
    dn = pairwise_distance(anchor, neg, p, eps)
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.hardsigmoid(x)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return F.hardswish(x)


def hardtanh(x: torch.Tensor, min_val: float = -1.0, max_val: float = 1.0) -> torch.Tensor:
    return F.hardtanh(x, min_val, max_val)


def mish(x: torch.Tensor) -> torch.Tensor:
    return F.mish(x)


def softplus(x: torch.Tensor, beta: float = 1.0, threshold: float = 20.0) -> torch.Tensor:
    return F.softplus(x, beta, threshold)


def glu(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return F.glu(x, axis)


def selu(x: torch.Tensor) -> torch.Tensor:
    return F.selu(x)


def celu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return F.celu(x, alpha)


__all__ = ["Flatten", "PixelShuffle", "ReflectionPad2d", "ReplicationPad2d", "Upsample",
           "ZeroPad2d", "celu", "cosine_similarity", "glu", "hardsigmoid", "hardswish",
           "hardtanh", "hinge_embedding_loss", "interpolate", "kl_div", "margin_ranking_loss",
           "mish", "pairwise_distance", "pixel_shuffle", "pixel_unshuffle", "selu", "softplus",
           "triplet_margin_loss"]
