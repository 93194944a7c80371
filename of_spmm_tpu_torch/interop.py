"""Carry parameters over from the JAX package's models (as numpy)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch


def gcn_params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """The JAX GCN's ``{"layer_i": {"w": (fan_in, fan_out), "b": (fan_out,)}}``
    (leaves converted with np.asarray) as a ``state_dict`` for
    ``models.GCN``: both keep weights as (fan_in, fan_out)."""
    n = len(params)
    if sorted(params) != sorted(f"layer_{i}" for i in range(n)):
        raise KeyError(f"expected keys layer_0..layer_{n - 1}, got {sorted(params)}")
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for i in range(n):
        p = params[f"layer_{i}"]
        sd[f"layers.{i}.w"] = torch.tensor(np.asarray(p["w"], dtype=np.float32))
        sd[f"layers.{i}.b"] = torch.tensor(np.asarray(p["b"], dtype=np.float32))
    return sd
