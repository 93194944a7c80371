"""The plain reference's shared parts: the sparse product and its
transpose, the masked loss, gradient clipping, Adam and its schedule.

Plain PyTorch only. Nothing here imports the program or JAX, and nothing
here takes an array the program made: the reference works its operators
out from the benchmark's graph, and reads the benchmark's inputs and
weights.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def csr_tensor(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               n: int) -> torch.Tensor:
    """The (n, n) matrix with entries vals at (rows, cols), duplicates
    summed, as a sparse CSR tensor."""
    with warnings.catch_warnings():
        # "sparse invariant checks are implicitly disabled", "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                      check_invariants=False).coalesce()
        return coo.to_sparse_csr()


def pattern(indptr: np.ndarray, cols: np.ndarray, device) -> tuple:
    """(rows, cols) of a CSR pattern as int64 tensors on ``device``."""
    ip = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=device)
    rows = torch.repeat_interleave(torch.arange(ip.shape[0] - 1, device=device),
                                   ip[1:] - ip[:-1])
    return rows, c


class Operator:
    """A sparse matrix A and its transpose, both CSR tensors."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n: int):
        self.a = csr_tensor(rows, cols, vals, n)
        self.at = csr_tensor(cols, rows, vals, n)
        self.nnz = int(self.a.values().shape[0])


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return op.a @ x

    @staticmethod
    def backward(ctx, g):
        return ctx.op.at @ g.contiguous(), None


def spmm(op: Operator, x: torch.Tensor) -> torch.Tensor:
    """A @ x; its gradient in x is A^T @ g."""
    return _Spmm.apply(x, op)


def masked_nll(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy over the rows in ``mask``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def learning_rate(opt: dict, k: int) -> float:
    """The k-th update's rate (k from 1): a linear warmup over
    ``opt["warmup"]`` updates from 0, times a cosine from ``lr`` to 0 over
    ``opt["epochs"]`` updates."""
    lr, epochs, warm = float(opt["lr"]), int(opt["epochs"]), int(opt["warmup"])
    t = min(max(k - 1, 0), epochs)
    rate = 0.5 * lr * (1 + math.cos(math.pi * t / epochs))
    if k <= warm:
        rate *= min(max(k, 0), warm) / max(warm, 1)
    return rate


class Trainer:
    """Full-batch training of ``forward(params, x)`` by the masked loss,
    clipping the global gradient norm, then Adam (no weight decay).

    ``frozen`` and ``mask`` exist to plant faults: a step that leaves the
    parameters as they were, and a loss over part of the batch."""

    def __init__(self, forward: Callable, params: Dict[str, torch.Tensor], opt: dict,
                 x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 frozen: bool = False):
        self.forward, self.opt, self.frozen = forward, opt, frozen
        self.x, self.labels, self.mask = x, labels, mask
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0
        self.clipped: Dict[str, torch.Tensor] = {}

    def step(self) -> float:
        names = list(self.params)
        loss = masked_nll(self.forward(self.params, self.x), self.labels, self.mask)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        total = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(float(self.opt["clip"]) / (total + 1e-6), max=1.0)
        self.clipped = {n: g * scale for n, g in zip(names, grads)}
        self.k += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr = learning_rate(self.opt, self.k)
        with torch.no_grad():
            for n in names:
                g = self.clipped[n]
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                if self.frozen:
                    continue
                mhat = self.m[n] / (1 - b1 ** self.k)
                vhat = self.v[n] / (1 - b2 ** self.k)
                self.params[n].sub_(lr * mhat / (vhat.sqrt() + eps))
        return float(loss.detach())


def readings(trainer: Trainer, steps: int) -> dict:
    """What the check compares, from ``steps`` updates of a trainer that
    has taken none: each step's loss, each leaf's norm of the first
    gradient as the optimizer got it, and each leaf's norm of the change
    of its parameters over the steps."""
    start = {k: v.detach().clone() for k, v in trainer.params.items()}
    losses: List[float] = []
    grad: Dict[str, float] = {}
    for i in range(steps):
        losses.append(trainer.step())
        if i == 0:
            grad = {k: float(torch.linalg.vector_norm(g)) for k, g in trainer.clipped.items()}
    change = {k: float(torch.linalg.vector_norm(trainer.params[k].detach() - start[k]))
              for k in start}
    return {"losses": losses, "grad": grad, "change": change}


def dense_products(n: int, dims: Sequence[int], per_layer: int, train: bool) -> int:
    """FLOPs of the dense products of a stack of layers with ``per_layer``
    (n, fan_in) @ (fan_in, fan_out) products each: forward, and in
    training the weight gradient of each and the input gradient of each
    but the first layer's (its input needs none)."""
    total = 0
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        one = 2 * n * fi * fo * per_layer
        total += one
        if train:
            total += one + (one if i > 0 else 0)
    return total
