"""Loss functions, the counterpart of the JAX package's nn/losses.py.

``cross_entropy``, ``nll_loss``, ``mse_loss``, ``l1_loss``,
``smooth_l1_loss`` and ``bce_with_logits`` as plain functions on
tensors, with ``reduction`` "none" | "mean" | "sum" (anything else raises
``ValueError``).

``cross_entropy`` is written out rather than delegated to
``torch.nn.functional.cross_entropy``, which ignores label -100 by
default: with ``ignore_index=None`` the JAX function maps every negative
label to class 0 and counts it, and so does this one. With
``ignore_index`` set, those labels are masked out and "mean" divides by
the number of the others (at least 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"unknown reduction {reduction!r}")


def _pick(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean",
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """Sparse softmax cross-entropy over the last axis (class logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    drop = labels < 0 if ignore_index is None else labels == ignore_index
    nll = -_pick(logp, torch.where(drop, torch.zeros_like(labels), labels))
    if ignore_index is not None:
        mask = (labels != ignore_index).to(nll.dtype)
        nll = nll * mask
        if reduction == "mean":
            return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return _reduce(nll, reduction)


def nll_loss(logp: torch.Tensor, labels: torch.Tensor, reduction: str = "mean"):
    return _reduce(-_pick(logp, labels), reduction)


def mse_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean"):
    return _reduce((pred - target) ** 2, reduction)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean"):
    return _reduce((pred - target).abs(), reduction)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0,
                   reduction: str = "mean"):
    diff = (pred - target).abs()
    return _reduce(torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta),
                   reduction)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor, reduction: str = "mean"):
    """max(x, 0) - x t + log(1 + exp(-|x|)), stable for large |x|, in the
    JAX function's order. max(x, 0) is written (x + |x|) / 2, equal to it
    bit for bit, so that at x = 0 the kinks of max and |x| give the true
    derivative sigmoid(0) - t = 0.5 - t (torch's abs has grad 0 there)."""
    loss = 0.5 * (logits + logits.abs()) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return _reduce(loss, reduction)


__all__ = ["cross_entropy", "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
           "bce_with_logits"]
