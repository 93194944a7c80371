"""Checkpoints of trees of tensors, the counterpart of the JAX package's
utils/checkpoint.py.

``save_checkpoint`` writes one ``.npz`` (through ``path + ".tmp"`` and
``os.replace``, so a reader never sees half a file): arrays ``arr_<i>``
in leaf order and a JSON ``manifest`` of their path keys, no pickle. The
leaf order and the keys are the JAX package's (utils/tree.py), so a
file written by either package loads in the other for the same tree.
``load_checkpoint`` reads one into the structure of ``like`` and raises
``ValueError("checkpoint structure mismatch ...")`` when the manifest
differs. Each leaf lands on the device and in the dtype of its ``like``
leaf, and a ``GlobalTensor`` leaf (parallel/global_view.py) comes back
with its placement: the counterpart of JAX's ``restore_shardings``.
bfloat16 tensors are written as float32 (numpy has no bfloat16).

``save_sharded`` / ``load_sharded`` go through
``torch.distributed.checkpoint``: in one process without a process
group, or collectively over ranks (replicated tensors written once).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from of_spmm_tpu_torch.utils.tree import flatten_with_paths, tree_unflatten


def _global_tensor_type():
    from of_spmm_tpu_torch.parallel.global_view import GlobalTensor
    return GlobalTensor


def _value(leaf) -> torch.Tensor:
    """A leaf as one whole tensor (a GlobalTensor gathered)."""
    if isinstance(leaf, _global_tensor_type()):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _numpy(leaf) -> np.ndarray:
    t = _value(leaf).cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _like(a: torch.Tensor, ref) -> Any:
    """``a`` placed as ``ref``: its device and dtype, its placement."""
    GlobalTensor = _global_tensor_type()
    if isinstance(ref, GlobalTensor):
        from of_spmm_tpu_torch.parallel.global_view import to_global
        return to_global(a.to(ref.local.dtype), ref.sbp, ref.mesh)
    if isinstance(ref, torch.Tensor):
        return a.to(device=ref.device, dtype=ref.dtype)
    return a


def _check(manifest: list, keys: list) -> None:
    if keys != manifest:
        raise ValueError("checkpoint structure mismatch:\n"
                         f"  file:   {manifest}\n  target: {keys}")


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree of tensors to ``path`` (.npz, created atomically)."""
    items = flatten_with_paths(tree)
    arrays = {f"arr_{i}": _numpy(leaf) for i, (_, leaf) in enumerate(items)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, manifest=json.dumps([key for key, _ in items]), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like: Any, restore_shardings: bool = True) -> Any:
    """Load into the structure of ``like``; each leaf placed as its ``like``
    leaf (with ``restore_shardings=False``, plain CPU tensors)."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        arrays = [z[f"arr_{i}"] for i in range(len(manifest))]
    items = flatten_with_paths(like)
    _check(manifest, [key for key, _ in items])
    leaves = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if restore_shardings:
        leaves = [_like(a, ref) for a, (_, ref) in zip(leaves, items)]
    return tree_unflatten(like, leaves)


def _flat_state(tree: Any) -> Dict[str, torch.Tensor]:
    return {key: _value(leaf).contiguous() for key, leaf in flatten_with_paths(tree)}


def save_sharded(path: str, tree: Any) -> None:
    """Save through torch.distributed.checkpoint into the directory
    ``path`` (every rank calls it under a process group)."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_flat_state(tree), checkpoint_id=os.path.abspath(path))


def load_sharded(path: str, like: Any) -> Any:
    """Restore a ``save_sharded`` checkpoint into the structure of
    ``like``, each leaf placed as its ``like`` leaf."""
    import torch.distributed.checkpoint as dcp

    items = flatten_with_paths(like)
    flat = {key: t.clone() for key, t in _flat_state(like).items()}
    dcp.load(flat, checkpoint_id=os.path.abspath(path))
    return tree_unflatten(like, [_like(flat[key], ref) for key, ref in items])


__all__ = ["save_checkpoint", "load_checkpoint", "save_sharded", "load_sharded"]
