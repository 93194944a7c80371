"""Carry parameters and training state over from the JAX package (as
numpy): each model's parameter tree as a ``state_dict``, and an
optimizer state or a whole ``TrainGraph`` state as the port's."""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from of_spmm_tpu_torch.embedding.one_embedding import _CacheMeta
from of_spmm_tpu_torch.parallel.global_view import GlobalTensor, sbp_for, to_global
from of_spmm_tpu_torch.utils.tree import nest, unnest


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


# each conv's parameter keys: (required, optional)
_CONV_KEYS = {
    "gcn": (("w",), ("b",)),
    "sage": (("w_self", "w_neigh"), ("b",)),
    "gat": (("w", "a_src", "a_dst"), ("b",)),
    "gin": (("eps", "w1", "b1", "w2", "b2"), ()),
}


def _conv_params(kind: str, params: Mapping[str, np.ndarray], prefix: str = ""
                 ) -> Dict[str, torch.Tensor]:
    required, optional = _CONV_KEYS[kind]
    keys = set(params)
    if not set(required) <= keys or not keys <= set(required) | set(optional):
        raise KeyError(f"{kind} conv params need keys {sorted(required)} "
                       f"(optional {sorted(optional)}), got {sorted(keys)}")
    return OrderedDict((prefix + k, _f32(params[k])) for k in (*required, *optional)
                       if k in params)


def gcn_conv_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX GCNConv's ``{"w"[, "b"]}`` as a ``state_dict`` for
    ``nn.GCNConv``."""
    return _conv_params("gcn", params)


def sage_conv_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX SAGEConv's ``{"w_self", "w_neigh"[, "b"]}`` for
    ``nn.SAGEConv``."""
    return _conv_params("sage", params)


def gat_conv_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX GATConv's ``{"w", "a_src", "a_dst"[, "b"]}`` for
    ``nn.GATConv``."""
    return _conv_params("gat", params)


def gin_conv_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX GINConv's ``{"eps", "w1", "b1", "w2", "b2"}`` for
    ``nn.GINConv``."""
    return _conv_params("gin", params)


def _layers(kind: str, params: Mapping[str, Mapping[str, np.ndarray]], module: str
            ) -> Dict[str, torch.Tensor]:
    n = len(params)
    if sorted(params) != sorted(f"layer_{i}" for i in range(n)):
        raise KeyError(f"expected keys layer_0..layer_{n - 1}, got {sorted(params)}")
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for i in range(n):
        sd.update(_conv_params(kind, params[f"layer_{i}"], f"{module}.{i}."))
    return sd


def gcn_params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """The JAX GCN's ``{"layer_i": {"w": (fan_in, fan_out), "b": (fan_out,)}}``
    (leaves converted with np.asarray) as a ``state_dict`` for
    ``models.GCN``: both keep weights as (fan_in, fan_out)."""
    return _layers("gcn", params, "layers")


def sage_params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX GraphSAGE's ``{"layer_i": {"w_self", "w_neigh", "b"}}`` as a
    ``state_dict`` for ``models.GraphSAGE``."""
    return _layers("sage", params, "layers")


def gat_params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]]
                          ) -> Dict[str, torch.Tensor]:
    """The JAX GAT's ``{"layer_i": {"w", "a_src", "a_dst", "b"}}`` as a
    ``state_dict`` for ``models.GAT`` (layer i becomes ``convs.i``)."""
    return _layers("gat", params, "convs")


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


def _exact(params: Mapping[str, np.ndarray], keys, what: str) -> Dict[str, torch.Tensor]:
    if set(params) != set(keys):
        raise KeyError(f"{what} params need keys {sorted(keys)}, got {sorted(params)}")
    return OrderedDict((k, _f32(params[k])) for k in keys)


def tp_mlp_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``init_tp_mlp`` dict ``{"w_in", "b_in", "w_out", "b_out"}``
    (whole, weights (in, out)) as the port's ``parallel.tp`` dict."""
    return _exact(params, ("w_in", "b_in", "w_out", "b_out"), "TP MLP")


def moe_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``MoELayer`` dict ``{"wg", "w1", "b1", "w2", "b2"}`` (experts
    stacked on the leading axis) as a ``state_dict`` for ``MoELayer``."""
    return _exact(params, ("wg", "w1", "b1", "w2", "b2"), "MoE")


def stage_params_from_numpy(stacked: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``stack_stage_params`` dict of a stage's parameters (each
    stacked on a leading stage axis) as the port's, which keeps the stage
    axis (``parallel.pipeline``)."""
    return OrderedDict((k, _f32(v)) for k, v in stacked.items())


def conv_params_from_numpy(params: Mapping[str, np.ndarray], prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    """A JAX convolution's ``{"w"[, "b"]}`` (Conv1d / 2d / 3d, OI*;
    ConvTranspose1d / 2d / 3d, IO*) as a ``state_dict`` for the port's
    module of the same name (same keys, same shapes), under ``prefix``."""
    if "w" not in params or not set(params) <= {"w", "b"}:
        raise KeyError(f"conv params need keys ['w'] (optional ['b']), got {sorted(params)}")
    return OrderedDict((prefix + k, _f32(params[k])) for k in ("w", "b") if k in params)


def rnn_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX LSTM's, GRU's or RNN's ``{"w_ih", "w_hh", "b_ih", "b_hh"}``
    (torch's gate order) as a ``state_dict`` for ``nn.LSTM`` / ``GRU`` /
    ``RNN``."""
    return _exact(params, ("w_ih", "w_hh", "b_ih", "b_hh"), "RNN")


def _with_state(params: Mapping, state: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """A JAX tree of parameters and one of mutable state (BatchNorm's
    ``mean`` / ``var``; ``None`` where a module has none) as one
    ``state_dict`` under the trees' dotted keys: the state's leaves are
    the port modules' buffers."""
    sd = identity_params_from_numpy(params)
    sd.update(identity_params_from_numpy(_drop_none(state or {})))
    return sd


def _drop_none(tree: Mapping) -> dict:
    return {k: _drop_none(v) if isinstance(v, Mapping) else v
            for k, v in tree.items() if v is not None}


def _numbered(params: Mapping, prefix: str, n: int) -> None:
    keys = sorted(k for k in params if k.startswith(prefix))
    if keys != sorted(f"{prefix}{i}" for i in range(n)):
        raise KeyError(f"expected keys {prefix}0..{prefix}{n - 1}, got {keys}")


def sequential_params_from_numpy(params: Mapping[str, Mapping],
                                 state: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A JAX Sequential's ``{"layer_i": {...}}`` (and its ``init_state()``
    or a ``new_state``, for BatchNorm children) as a ``state_dict`` for
    ``nn.Sequential`` built of the same layers: ``layer_i.<key>``."""
    _numbered(params, "layer_", len(params))
    return _with_state(params, state)


def resnet_params_from_numpy(params: Mapping[str, Mapping],
                             state: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """A JAX ResNet's parameters (``stem_conv``, ``stem_bn``,
    ``block_<i>/{conv<j>, bn<j>, down_conv, down_bn}``, ``head``) and its
    BatchNorm state (``init_state()`` or the ``new_state`` of a training
    forward) as a ``state_dict`` for ``models.ResNet``: the running
    ``mean`` / ``var`` become the BatchNorms' buffers."""
    _numbered(params, "block_", sum(1 for k in params if k.startswith("block_")))
    if set(state) != {k for k in params if k.startswith(("block_", "stem_bn"))}:
        raise KeyError(f"ResNet state keys {sorted(state)} do not match its parameters'")
    return _with_state(params, state)


def _convnet_params(params: Mapping[str, Mapping], n_convs: int, what: str
                    ) -> Dict[str, torch.Tensor]:
    if set(params) != {f"conv_{i}" for i in range(n_convs)} | {f"fc_{i}" for i in range(3)}:
        raise KeyError(f"{what} params need conv_0..conv_{n_convs - 1} and fc_0..fc_2, "
                       f"got {sorted(params)}")
    return identity_params_from_numpy(params)


def vgg16_params_from_numpy(params: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """The JAX VGG16's ``{"conv_i": {"w", "b"}, "fc_i": {"w", "b"}}`` as a
    ``state_dict`` for ``models.VGG16`` (Linear weights stay (in, out))."""
    return _convnet_params(params, 13, "VGG16")


def alexnet_params_from_numpy(params: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """The JAX AlexNet's tree as a ``state_dict`` for ``models.AlexNet``."""
    return _convnet_params(params, 5, "AlexNet")


# ---------------------------------------------------------------------------
# Training state: optimizer states and a whole TrainGraph state_dict.
# ---------------------------------------------------------------------------

ParamsFromNumpy = Callable[[Mapping], Mapping[str, torch.Tensor]]


def _nested(params_from_numpy: ParamsFromNumpy, tree) -> dict:
    """A JAX parameter-shaped tree (numpy leaves) converted by
    ``params_from_numpy`` and nested by the port's parameter names."""
    return nest(params_from_numpy(tree))


def optimizer_state_from_numpy(state: Mapping, params_from_numpy: ParamsFromNumpy) -> dict:
    """A JAX optimizer state (``{"step", "m", "v"}``, ``{"step", "accum",
    "z"}``, ...; leaves as numpy) as the port's: each parameter-shaped
    slot converted by ``params_from_numpy`` (e.g. ``gcn_params_from_numpy``)
    and nested by the port's names, ``step`` an int32 tensor. Load it with
    ``TrainGraph.load_state_dict`` (inside a whole state) or
    ``optim.Optimizer.load_state_tree``."""
    out = {}
    for name, v in state.items():
        out[name] = (torch.tensor(np.asarray(v), dtype=torch.int32) if name == "step"
                     else _nested(params_from_numpy, v))
    return out


def train_state_from_numpy(sd: Mapping, params_from_numpy: ParamsFromNumpy) -> dict:
    """A JAX ``TrainGraph.state_dict()`` (leaves as numpy: params, the
    optimizer state, the scaler state, step_count) as the port's
    ``TrainGraph.state_dict()`` tree, for ``TrainGraph.load_state_dict``:
    a JAX graph's training continues in the port."""
    state = {"opt": optimizer_state_from_numpy(sd["state"]["opt"], params_from_numpy)}
    if "scaler" in sd["state"]:
        state["scaler"] = {k: torch.tensor(np.asarray(v)) for k, v in sd["state"]["scaler"].items()}
    return {"params": _nested(params_from_numpy, sd["params"]), "state": state,
            "step_count": torch.tensor(int(np.asarray(sd["step_count"])), dtype=torch.int64)}


def identity_params_from_numpy(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX tree whose nesting already is the port model's parameter
    names (a module whose submodules are named as the JAX keys, e.g.
    ``layer_0`` / ``layer_2`` for a Sequential): its leaves as float32
    tensors under dotted names."""
    return OrderedDict((k, _f32(v)) for k, v in unnest(params).items())


# ---------------------------------------------------------------------------
# The embedding path.
# ---------------------------------------------------------------------------


def embedding_params_from_numpy(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``Embedding`` dict ``{"weight"}`` (``models/embedding.py`` or
    ``nn.layers``) as a ``state_dict`` for ``models.Embedding``."""
    return _exact(params, ("weight",), "Embedding")


def sharded_embedding_params_from_numpy(params: Mapping[str, np.ndarray], mesh,
                                        axis: str = "x") -> dict:
    """The JAX ``ShardedEmbedding`` dict ``{"weight"}`` (the whole
    (padded_rows, D) table) as the port's: ``{"weight": GlobalTensor}``
    placed S(0) over ``axis`` of ``mesh`` (a ``ShardMesh`` or a
    ``RankGroup``), its blocks a leaf that requires grad."""
    w = _exact(params, ("weight",), "ShardedEmbedding")["weight"]
    g = to_global(w, sbp_for(mesh, **{axis: "S0"}), mesh)
    return {"weight": GlobalTensor(g.local.detach().clone().requires_grad_(), g.sbp, mesh)}


def cached_embedding_state_from_numpy(cache, meta) -> tuple:
    """A JAX ``CachedEmbedding``'s cache array and ``_CacheMeta`` as the
    port's ``(cache tensor, _CacheMeta)`` (the cache a float32 CPU tensor,
    to move where the port's ``CachedEmbedding`` runs; the meta's arrays,
    clock and index copied field for field)."""
    state = _CacheMeta(slot_ids=np.array(meta.slot_ids, np.int64),
                       last_used=np.array(meta.last_used, np.int64),
                       dirty=np.array(meta.dirty, bool), clock=int(meta.clock),
                       index={int(k): int(v) for k, v in meta.index.items()})
    return _f32(cache), state
