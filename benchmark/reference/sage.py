"""Plain reference of GraphSAGE with the mean aggregator (Hamilton et
al.): h' = act(h @ W_self + (D^-1 A h) @ W_neigh + b), ReLU after every
layer but the last. Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from benchmark.reference.common import Operator, dense_products, pattern, spmm


def operator(indptr, cols, device) -> Operator:
    """D^-1 A of the graph's pattern: each row's entries 1 / its count."""
    rows, c = pattern(indptr, cols, device)
    n = int(len(indptr) - 1)
    deg = torch.bincount(rows, minlength=n).to(torch.float64)
    vals = (1.0 / deg.clamp_min(1.0))[rows].to(torch.float32)
    return Operator(rows, c, vals, n)


def leaves(dims: Sequence[int]) -> Dict[str, tuple]:
    out = {}
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"layers.{i}.w_self"] = ((fi, fo), "glorot")
        out[f"layers.{i}.w_neigh"] = ((fi, fo), "glorot")
        out[f"layers.{i}.b"] = ((fo,), "zeros")
    return out


def forward(params: Dict[str, torch.Tensor], op: Operator, x: torch.Tensor,
            dims: Sequence[int]) -> torch.Tensor:
    h = x
    last = len(dims) - 2
    for i in range(len(dims) - 1):
        h = (h @ params[f"layers.{i}.w_self"] + spmm(op, h) @ params[f"layers.{i}.w_neigh"]
             + params[f"layers.{i}.b"])
        if i < last:
            h = torch.relu(h)
    return h


def spmm_widths(dims: Sequence[int], train: bool) -> list:
    fwd = list(dims[:-1])
    return fwd + (fwd[1:] if train else [])


def flops(n: int, nnz: int, dims: Sequence[int], train: bool) -> int:
    """Two dense products a layer, and 2 nnz d per SpMM."""
    return dense_products(n, dims, 2, train) + sum(2 * nnz * d for d in spmm_widths(dims, train))


def operator_nnz(indptr, cols) -> int:
    return int(len(cols))
