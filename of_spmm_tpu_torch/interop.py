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


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def mha_params_from_numpy(params: Mapping[str, np.ndarray], prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """The JAX MultiheadAttention's ``{"in_w", "out_w"[, "in_b", "out_b"]}``
    as a ``state_dict`` for ``nn.MultiheadAttention`` (same keys, same
    torch-convention shapes), each key under ``prefix``."""
    return OrderedDict((prefix + key, _f32(params[key]))
                       for key in ("in_w", "out_w", "in_b", "out_b") if key in params)


def transformer_params_from_numpy(params: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """The JAX TransformerEncoder's tree (``tok``, ``pos``, ``ln_f``,
    optional ``head``, ``block_i/{ln1, attn, ln2, fc1, fc2}``; leaves as
    numpy) as a ``state_dict`` for ``models.TransformerEncoder``: block i
    becomes ``blocks.i``; Linear weights stay (in, out)."""
    n = sum(1 for key in params if key.startswith("block_"))
    if sorted(k for k in params if k.startswith("block_")) != sorted(
            f"block_{i}" for i in range(n)):
        raise KeyError(f"expected keys block_0..block_{n - 1}, got {sorted(params)}")
    sd: Dict[str, torch.Tensor] = OrderedDict()
    sd["tok.weight"] = _f32(params["tok"]["weight"])
    sd["pos.weight"] = _f32(params["pos"]["weight"])
    for name in ("ln_f", "head"):
        for key, leaf in params.get(name, {}).items():
            sd[f"{name}.{key}"] = _f32(leaf)
    for i in range(n):
        block = params[f"block_{i}"]
        for name in ("ln1", "ln2", "fc1", "fc2"):
            for key, leaf in block[name].items():
                sd[f"blocks.{i}.{name}.{key}"] = _f32(leaf)
        sd.update(mha_params_from_numpy(block["attn"], f"blocks.{i}.attn."))
    return sd
