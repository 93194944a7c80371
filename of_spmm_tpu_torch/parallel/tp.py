"""Tensor (model) parallelism: the Megatron column -> row parallel MLP pair,
the port of the JAX package's parallel/tp.py.

- ``column_parallel_linear``: W split S(1) (output features); the local
  matmul gives S(1) activations, no collective (weight S(1) => out S(1)).
- ``row_parallel_linear``: W split S(0) (input features) on those
  activations; the local matmul is a partial sum, and one all-reduce over
  the tp axis resolves P -> B (the ccl-p-to-b route).

One all-reduce per block forward, and one backward (comm's all-reduce is
its own adjoint over ranks; on a ShardMesh autograd derives it). With a
``dp_axis`` the same block is hybrid DP x TP: activations [S(0), B],
weights [B, S(k)] (sbp_parallel.proto:74-79).

Inside a body every tensor carries the leading shard axis
(parallel/mesh.py); ``tp_axis`` is a mesh axis (``mesh.axis("tp")``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from of_spmm_tpu_torch.nn.layers import gelu
from of_spmm_tpu_torch.parallel.global_view import sbp_for, shard, to_global, unshard
from of_spmm_tpu_torch.parallel.mesh import bcast
from of_spmm_tpu_torch.utils.device import resolve_device

# each parameter's split over the tp axis: w_in S(1), b_in S(0) (the
# split hidden dim), w_out S(0), b_out replicated (added once, after the
# all-reduce)
TP_SPLITS = {"w_in": "S1", "b_in": "S0", "w_out": "S0", "b_out": "B"}


def init_tp_mlp(d_model: int, d_hidden: int, dtype=torch.float32, device=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Parameters of one column -> row parallel MLP block (whole): weights
    uniform in +-1/sqrt(fan_in), biases zero. ``device=None`` is the card;
    ``generator`` (CPU) seeds the weights."""
    dev = resolve_device(device)

    def uniform(shape, s):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((u * 2 - 1) * s).to(device=dev, dtype=dtype)

    return {"w_in": uniform((d_model, d_hidden), 1.0 / math.sqrt(d_model)),
            "b_in": torch.zeros(d_hidden, dtype=dtype, device=dev),
            "w_out": uniform((d_hidden, d_model), 1.0 / math.sqrt(d_hidden)),
            "b_out": torch.zeros(d_model, dtype=dtype, device=dev)}


def _sbp(mesh, tp_axis: str) -> Dict[str, tuple]:
    return {k: sbp_for(mesh, **{tp_axis: a}) for k, a in TP_SPLITS.items()}


def shard_tp_mlp(params: Dict[str, torch.Tensor], mesh, tp_axis: str = "tp") -> dict:
    """The MLP's parameters placed with their TP splits (GlobalTensors):
    w_in S(1), b_in S(0), w_out S(0), b_out B."""
    n = mesh.axis_size(tp_axis)
    for name, dim in (("w_in", 1), ("b_in", 0), ("w_out", 0)):
        if params[name].shape[dim] % n:
            raise ValueError(f"{name} dim {dim} ({params[name].shape[dim]}) not divisible by "
                             f"tp={n}; pad d_hidden to a multiple of the tp axis")
    specs = _sbp(mesh, tp_axis)
    return {k: to_global(v, specs[k], mesh) for k, v in params.items()}


def column_parallel_linear(w_local: torch.Tensor, b_local: torch.Tensor, x: torch.Tensor,
                           activation: Optional[Callable] = gelu) -> torch.Tensor:
    """S(1)-split Linear in a body: out S(1), no collective."""
    y = x @ bcast(w_local, x.dim()) + bcast(b_local, x.dim())
    return activation(y) if activation is not None else y


def row_parallel_linear(w_local: torch.Tensor, x_local: torch.Tensor, tp_axis) -> torch.Tensor:
    """S(0)-split Linear on S(1) activations: the local product is a
    partial sum, resolved by one all-reduce over ``tp_axis``."""
    return tp_axis.psum(x_local @ bcast(w_local, x_local.dim()))


def tp_mlp_block(params: dict, x: torch.Tensor, tp_axis,
                 activation: Optional[Callable] = gelu) -> torch.Tensor:
    """The column -> row MLP body: x replicated along tp in, replicated
    out; one all-reduce."""
    h = column_parallel_linear(params["w_in"], params["b_in"], x, activation)
    y = row_parallel_linear(params["w_out"], h, tp_axis)
    return y + bcast(params["b_out"], y.dim())


def make_tp_mlp(mesh, tp_axis: str = "tp", activation: Optional[Callable] = gelu,
                dp_axis: Optional[str] = None) -> Callable:
    """``fwd(params, x)``: the TP MLP over ``mesh``. ``params`` are
    shard_tp_mlp's GlobalTensors or whole tensors, ``x`` the global batch
    (split S(0) over ``dp_axis`` when given: hybrid DP x TP). Returns the
    global output on a ShardMesh, this rank's block over ranks."""
    specs = _sbp(mesh, tp_axis)
    x_sbp = sbp_for(mesh, **({dp_axis: "S0"} if dp_axis else {}))

    def fwd(params: dict, x: torch.Tensor) -> torch.Tensor:
        local = {k: shard(params[k], specs[k], mesh) for k in specs}
        y = tp_mlp_block(local, shard(x, x_sbp, mesh), mesh.axis(tp_axis), activation)
        return unshard(y, x_sbp, mesh)

    return fwd


__all__ = ["init_tp_mlp", "shard_tp_mlp", "column_parallel_linear", "row_parallel_linear",
           "tp_mlp_block", "make_tp_mlp"]
