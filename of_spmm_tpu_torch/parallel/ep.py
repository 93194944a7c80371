"""Expert parallelism: a mixture of experts with all-to-all token dispatch,
the port of the JAX package's parallel/ep.py (GShard / Switch style).

Tokens live split S(token) on an ``ep`` mesh axis, experts split
S(expert) on the same axis (each shard owns n_experts / p of them):

- gating and slot assignment run on each shard's own tokens with static
  shapes: every (shard, expert) pair has a fixed-capacity slot buffer,
  and a token whose expert is full at its turn is dropped from it;
- dispatch and combine are one-hot tensors, so the route is einsums;
- one all-to-all ships the slot buffers to the experts' owners, a second
  ships the results back (their backward is the reverse all-to-all).

Inside a body every tensor carries the leading shard axis
(parallel/mesh.py).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.nn.layers import gelu
from of_spmm_tpu_torch.parallel.global_view import sbp_for, shard, to_global, unshard
from of_spmm_tpu_torch.utils.device import resolve_device
from of_spmm_tpu_torch.utils.errors import check_shape

EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert for a block of tokens: ceil(top_k * n_tokens *
    factor / n_experts), at least 1 (GShard's rule)."""
    return max(1, int(math.ceil(top_k * n_tokens * capacity_factor / n_experts)))


def top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int, normalize: bool = True):
    """Greedy top-k routing with per-expert capacity, static shapes.

    ``probs`` (..., T, E) are gate probabilities. Returns ``dispatch``
    (..., T, E, C), 0/1 (token t holds slot c of expert e), ``combine``
    (..., T, E, C), the gate-weighted dispatch, and ``aux`` (...), the
    Switch load-balancing loss E * sum_e mean_prob_e * mean_assign_e over
    the first choice. Slots go in token order, choice k before k + 1; a
    token whose expert is full at its turn is dropped from it. With
    ``normalize`` each token's kept gates sum to 1."""
    T, E = probs.shape[-2:]
    remaining = probs
    counts = torch.zeros(probs.shape[:-2] + (E,), device=probs.device)
    dispatch = torch.zeros(probs.shape[:-1] + (E, capacity), dtype=probs.dtype,
                           device=probs.device)
    gates, slots, first = [], [], None
    for _ in range(top_k):
        onehot = F.one_hot(torch.argmax(remaining, -1), E).float()  # (..., T, E)
        if first is None:
            first = onehot
        # each token's place in its expert's queue: earlier choices first,
        # then token order
        pos = (onehot.cumsum(-2) - 1.0 + counts[..., None, :]) * onehot
        pos_t = pos.sum(-1)  # (..., T)
        keep = (pos_t < capacity).float()
        slot = F.one_hot(pos_t.long().clamp(max=capacity - 1), capacity).float()
        d_k = (onehot * keep[..., None])[..., None] * slot[..., None, :]
        dispatch = dispatch + d_k.to(probs.dtype)
        gates.append((probs * onehot).sum(-1) * keep.to(probs.dtype))
        counts = counts + (onehot * keep[..., None]).sum(-2)
        remaining = remaining * (1.0 - onehot)
        slots.append(d_k)
    g = torch.stack(gates, -1)
    if normalize:
        g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
    combine = sum(g[..., k, None, None] * d.to(probs.dtype) for k, d in enumerate(slots))
    aux = E * (probs.mean(-2) * first.mean(-2)).sum(-1)
    return dispatch, combine, aux


def _expert_ffn(w1, b1, w2, b2, h: torch.Tensor) -> torch.Tensor:
    """(..., E_local, C, D) slot buffers through each expert's FFN."""
    a = gelu(torch.einsum("...ecd,...edf->...ecf", h, w1) + b1[..., None, :])
    return torch.einsum("...ecf,...efd->...ecd", a, w2) + b2[..., None, :]


class MoELayer(torch.nn.Module):
    """Top-k routed mixture of expert FFNs. Parameters: ``wg`` (D, E) the
    gate; ``w1`` (E, D, F), ``b1`` (E, F), ``w2`` (E, F, D), ``b2`` (E, D),
    stacked on a leading expert axis, so S(expert) is S(0). Weights start
    uniform in +-1/sqrt(fan_in), biases zero. ``device=None`` is the card;
    ``generator`` (CPU) seeds the weights."""

    def __init__(self, embed_dim: int, n_experts: int, ffn_dim: int, top_k: int = 2,
                 capacity_factor: float = 1.25, normalize_gates: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        D, E, Fd = embed_dim, n_experts, ffn_dim
        self.embed_dim, self.n_experts, self.ffn_dim = D, E, Fd
        self.top_k, self.capacity_factor = int(top_k), float(capacity_factor)
        self.normalize_gates = bool(normalize_gates)

        def uniform(shape, s):
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return torch.nn.Parameter(((u * 2 - 1) * s).to(dev))

        s1, s2 = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
        self.wg = uniform((D, E), s1)
        self.w1 = uniform((E, D, Fd), s1)
        self.b1 = torch.nn.Parameter(torch.zeros(E, Fd, device=dev))
        self.w2 = uniform((E, Fd, D), s2)
        self.b2 = torch.nn.Parameter(torch.zeros(E, D, device=dev))

    def _route(self, wg: torch.Tensor, x: torch.Tensor):
        """(..., T, D) tokens -> dispatch, combine, aux at the block's
        capacity."""
        cap = expert_capacity(x.shape[-2], self.n_experts, self.top_k, self.capacity_factor)
        probs = torch.softmax((x @ wg).float(), dim=-1)
        return top_k_dispatch(probs.to(x.dtype), self.top_k, cap, self.normalize_gates)

    def _layer(self, p: dict, x: torch.Tensor, axis=None):
        """Route, dispatch, the experts, combine; with ``axis`` (a body's
        mesh axis) the slot buffers cross it by all-to-all both ways."""
        dispatch, combine, aux = self._route(p["wg"], x)
        h = torch.einsum("...tec,...td->...ecd", dispatch, x)  # (..., E, C, D)
        if axis is not None:  # (L, E, C, D) -> (L, E/p, pC, D)
            h = axis.all_to_all(h, split_dim=1, concat_dim=2)
        out = _expert_ffn(p["w1"], p["b1"], p["w2"], p["b2"], h)
        if axis is not None:  # back to the tokens' owners
            out = axis.all_to_all(out, split_dim=2, concat_dim=1)
            aux = axis.pmean(aux)
        return torch.einsum("...tec,...ecd->...td", combine, out), aux

    def apply(self, x: torch.Tensor, *, return_aux: bool = False):
        """One shard, every expert local: (T, D) -> (T, D)."""
        check_shape(x.dim() == 2 and x.shape[1] == self.embed_dim,
                    f"moe input must be (T, {self.embed_dim}), got {tuple(x.shape)}")
        y, aux = self._layer(dict(self.named_parameters()), x)
        return (y, aux) if return_aux else y

    forward = apply

    def _sbp(self, mesh, axis: str) -> dict:
        experts = sbp_for(mesh, **{axis: "S0"})
        return {"wg": sbp_for(mesh), **{k: experts for k in EXPERT_PARAMS}}

    def shard_params(self, mesh, axis: str = "ep") -> dict:
        """The parameters placed: experts S(expert) over ``axis``, the gate
        replicated (GlobalTensors)."""
        specs = self._sbp(mesh, axis)
        return {k: to_global(p, specs[k], mesh) for k, p in self.named_parameters()}

    def make_sharded_apply(self, mesh, axis: str = "ep", return_aux: bool = False) -> Callable:
        """``fn(x, params=None)``: tokens (T, D) split S(0) over ``axis``,
        experts S(expert); ``params`` are shard_params' GlobalTensors
        (default: the module's parameters). Returns the global output on
        a ShardMesh, this rank's block over ranks (and the mean aux)."""
        p = mesh.axis_size(axis)
        if self.n_experts % p:
            raise ValueError(f"n_experts={self.n_experts} not divisible by mesh axis "
                             f"'{axis}' size {p}")
        specs = self._sbp(mesh, axis)
        x_sbp = sbp_for(mesh, **{axis: "S0"})

        def fn(x: torch.Tensor, params: Optional[dict] = None):
            params = dict(self.named_parameters()) if params is None else params
            local = {k: shard(params[k], specs[k], mesh) for k in specs}
            y, aux = self._layer(local, shard(x, x_sbp, mesh), mesh.axis(axis))
            y = unshard(y, x_sbp, mesh)
            return (y, unshard(aux, sbp_for(mesh), mesh)) if return_aux else y

        return fn


__all__ = ["expert_capacity", "top_k_dispatch", "MoELayer"]
