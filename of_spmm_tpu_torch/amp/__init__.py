"""amp: the mixed-precision policy and loss scaling, the counterpart of
the JAX package's amp/.

- ``Policy``: the (param, compute, output) dtype triple and its casts over
  a tensor or a nested dict / tuple / list of them; only floating
  tensors are cast. ``DEFAULT_POLICY`` computes in bfloat16 with float32
  master parameters, ``FP32_POLICY`` in float32.
- ``all_finite``: one bool tensor, True when every floating leaf is finite.
- ``GradScaler``: dynamic loss scaling with the JAX state-dict API
  (``init``, ``scale``, ``unscale``, ``update``, ``unscale_and_update``)
  and its rule: after ``growth_interval`` finite steps in a row the scale
  grows by ``growth_factor``; a non-finite step multiplies it by
  ``backoff_factor`` and restarts the count. ``torch.amp.GradScaler``
  wraps ``optimizer.step`` and has another call shape, so it is not used.
- ``StaticGradScaler``: a constant scale.

The states are dicts of 0-dim tensors (``init(device=...)`` places them
beside the grads); every update is tensor arithmetic, with no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from of_spmm_tpu_torch.utils.tree import tree_leaves, tree_map


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Cast parameters and inputs to ``compute_dtype`` at the forward
    boundary; keep the master parameters in ``param_dtype``."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast(tree, self.param_dtype)

    def cast_output(self, tree):
        return _cast(tree, self.output_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def all_finite(tree) -> torch.Tensor:
    """A bool tensor: every floating leaf of ``tree`` is finite."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree) if _is_float(x)]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def _unscale(grads, state: dict):
    inv = 1.0 / state["scale"]
    return tree_map(lambda g: g * inv.to(device=g.device, dtype=g.dtype), grads)


@dataclasses.dataclass(frozen=True)
class GradScaler:
    """Dynamic loss scaler.

        scaler = GradScaler()
        state = scaler.init(device)
        loss = scaler.scale(loss, state)   # then the grads of the scaled loss
        grads, state, did_step = scaler.unscale_and_update(grads, state)
        # skip the optimizer's step where did_step is False
    """

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000

    def init(self, device: Optional[torch.device] = None) -> dict:
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32, device=device),
                "growth_tracker": torch.zeros((), dtype=torch.int32, device=device)}

    def scale(self, loss: torch.Tensor, state: dict) -> torch.Tensor:
        return loss * state["scale"].to(device=loss.device, dtype=loss.dtype)

    def unscale(self, grads, state: dict):
        return _unscale(grads, state)

    def update(self, state: dict, grads_finite: torch.Tensor) -> dict:
        scale, tracker = state["scale"], state["growth_tracker"]
        finite = torch.as_tensor(grads_finite, device=scale.device)
        grown = tracker + 1
        hit = grown >= self.growth_interval
        new_scale = torch.where(finite, torch.where(hit, scale * self.growth_factor, scale),
                                scale * self.backoff_factor)
        zero = torch.zeros_like(tracker)
        new_tracker = torch.where(finite, torch.where(hit, zero, grown), zero)
        return {"scale": new_scale, "growth_tracker": new_tracker.to(torch.int32)}

    def unscale_and_update(self, grads, state: dict):
        """(unscaled grads, new state, did_step): skip the step where the
        grads are not finite."""
        grads = self.unscale(grads, state)
        finite = all_finite(grads)
        return grads, self.update(state, finite), finite


@dataclasses.dataclass(frozen=True)
class StaticGradScaler:
    """A constant loss scale."""

    scale_value: float = 1.0

    def init(self, device: Optional[torch.device] = None) -> dict:
        return {"scale": torch.tensor(self.scale_value, dtype=torch.float32, device=device)}

    def scale(self, loss: torch.Tensor, state: dict) -> torch.Tensor:
        return loss * state["scale"].to(device=loss.device, dtype=loss.dtype)

    def unscale(self, grads, state: dict):
        return _unscale(grads, state)

    def unscale_and_update(self, grads, state: dict):
        grads = self.unscale(grads, state)
        return grads, state, all_finite(grads)


__all__ = ["Policy", "DEFAULT_POLICY", "FP32_POLICY", "all_finite", "GradScaler",
           "StaticGradScaler"]
