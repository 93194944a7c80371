"""Plain reference of GCN (Kipf and Welling): H' = act(A_hat @ H @ W + b)
with A_hat = D^-1/2 (A + I) D^-1/2, ReLU after every layer but the last.
Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.common import Operator, dense_products, pattern, spmm


def operator(indptr, cols, device) -> Operator:
    """A_hat of the graph's pattern (A + I, duplicates summed), degrees
    in float64."""
    rows, c = pattern(indptr, cols, device)
    n = int(len(indptr) - 1)
    loop = torch.arange(n, device=device)
    rows, c = torch.cat([rows, loop]), torch.cat([c, loop])
    deg = torch.bincount(rows, minlength=n).to(torch.float64)
    dinv = deg.clamp_min(1e-12).rsqrt()
    vals = (dinv[rows] * dinv[c]).to(torch.float32)
    return Operator(rows, c, vals, n)


def leaves(dims: Sequence[int]) -> Dict[str, tuple]:
    """Each parameter's name (the port's state_dict key), shape and
    initialisation."""
    out = {}
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"layers.{i}.w"] = ((fi, fo), "glorot")
        out[f"layers.{i}.b"] = ((fo,), "zeros")
    return out


def forward(params: Dict[str, torch.Tensor], op: Operator, x: torch.Tensor,
            dims: Sequence[int]) -> torch.Tensor:
    h = x
    last = len(dims) - 2
    for i in range(len(dims) - 1):
        h = spmm(op, h) @ params[f"layers.{i}.w"] + params[f"layers.{i}.b"]
        if i < last:
            h = torch.relu(h)
    return h


def spmm_widths(dims: Sequence[int], train: bool) -> list:
    """The width d of each SpMM of a forward (and, in training, of the
    backward: every layer's but the first, whose input needs no
    gradient)."""
    fwd = list(dims[:-1])
    return fwd + (fwd[1:] if train else [])


def flops(n: int, nnz: int, dims: Sequence[int], train: bool) -> int:
    """Model FLOPs of a forward (train: and its backward): one dense
    product a layer, and 2 nnz d per SpMM."""
    return dense_products(n, dims, 1, train) + sum(2 * nnz * d for d in spmm_widths(dims, train))


def operator_nnz(indptr, cols) -> int:
    """Nonzeros of A_hat: the graph's, and a self-loop on every node that
    has none."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return int(len(cols) + len(indptr) - 1 - np.count_nonzero(rows == cols))
