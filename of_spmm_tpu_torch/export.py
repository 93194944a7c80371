"""Model export and serving, the counterpart of the JAX package's
``of_spmm_tpu/export.py`` (there: a serialized ``jax.export`` StableHLO
module; here: a ``torch.export`` program).

- ``export_model(fn, example_args, path)``: trace ``fn`` (an
  ``nn.Module``, or a callable wrapped in one) at the example shapes
  under ``torch.no_grad()`` and write an artifact directory:
  ``program.pt2`` (``torch.export.save``), ``meta.json`` (the JAX keys:
  ``name``, ``in_avals``, ``out_avals``, ``platforms``, ``nr_devices``)
  and, given a ``state_dict``, ``params.npz``.
- ``load_model(path)``: the saved program as a callable module.
- ``load_params(path, like)``: ``params.npz`` back as a ``state_dict``
  shaped like ``like``.
- ``export_graph_text`` / ``ir_stats``: the exported graph's readable code
  and its histogram of operators, where each hand-written kernel shows as
  its ``ofs.*`` op (ops/cuda/library.py).

The hand-written kernels stay in the program: each is a
``torch.library`` custom op (``torch.ops.ofs.*``), recorded as one node
per launch, with a plan's arrays as the program's lifted constants (as
the JAX export bakes its plan into the module). A loaded program runs
the CUDA kernels on the card and their plain versions on the CPU, by
the device of its inputs and constants.

The artifact needs Python and this package to run: the ops are
registered from Python (ctypes launches, ops/cuda/build.py), so
``load_model`` imports them before it loads. A Python-free artifact
(AOTInductor) would need the kernels registered in C++
(``TORCH_LIBRARY``), which the ctypes build does not give.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda.library import load_ops

PROGRAM = "program.pt2"


class _Call(torch.nn.Module):
    """A callable as a module: ``forward(*args)`` is ``fn(*args)``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _aval(t: Any) -> str:
    """``float32[2708,7]``: a tensor's dtype and shape, as JAX prints an
    abstract value's."""
    if isinstance(t, torch.Tensor):
        return f"{str(t.dtype).replace('torch.', '')}[{','.join(str(int(s)) for s in t.shape)}]"
    return repr(t)


def export_program(fn: Callable, example_args: Sequence[Any]) -> torch.export.ExportedProgram:
    """``torch.export`` of ``fn`` at ``example_args``' shapes (non-strict,
    no gradients)."""
    module = fn if isinstance(fn, torch.nn.Module) else _Call(fn)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args), strict=False)


def _outputs(ep: torch.export.ExportedProgram) -> list:
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [a.meta.get("val") if hasattr(a, "meta") else a for a in out.args[0]]


def export_model(fn: Callable, example_args: Sequence[Any], path: str,
                 params: Mapping[str, torch.Tensor] = None, name: str = "model") -> str:
    """Export ``fn`` at ``example_args``' shapes into the directory
    ``path`` (created): ``program.pt2``, ``meta.json`` and, when
    ``params`` (a ``state_dict``) is given, ``params.npz``. Returns
    ``path``."""
    os.makedirs(path, exist_ok=True)
    ep = export_program(fn, example_args)
    for key, t in ep.constants.items():
        # an empty plan array that views numpy memory has a storage
        # address but no data address, which torch.export.save cannot pack
        if isinstance(t, torch.Tensor) and t.numel() == 0:
            ep.constants[key] = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    torch.export.save(ep, os.path.join(path, PROGRAM))
    tensors = [a for a in example_args if isinstance(a, torch.Tensor)]
    meta = {
        "name": name,
        "in_avals": [_aval(a) for a in example_args],
        "out_avals": [_aval(o) for o in _outputs(ep)],
        "platforms": sorted({a.device.type for a in tensors}),
        "nr_devices": len({str(a.device) for a in tensors}) or 1,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if params is not None:
        np.savez(os.path.join(path, "params.npz"),
                 **{f"leaf_{i}": _numpy(t) for i, t in enumerate(params.values())})
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(list(params), f)
    return path


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_model(path: str) -> torch.nn.Module:
    """The saved program of ``path`` as a callable module. Registers the
    ``ofs`` ops first, so a fresh process that imports this package can
    run it."""
    load_ops()
    return torch.export.load(os.path.join(path, PROGRAM)).module()


def load_params(path: str, like) -> Dict[str, torch.Tensor]:
    """``params.npz`` as a ``state_dict`` with the names, order, dtypes and
    devices of ``like`` (a ``state_dict`` or a module)."""
    like = like.state_dict() if isinstance(like, torch.nn.Module) else like
    data = np.load(os.path.join(path, "params.npz"))
    with open(os.path.join(path, "params.json")) as f:
        names = json.load(f)
    if list(like) != names:
        raise KeyError(f"the saved params are {names}, ``like`` has {list(like)}")
    return OrderedDict(
        (k, torch.from_numpy(data[f"leaf_{i}"]).to(dtype=v.dtype, device=v.device))
        for i, (k, v) in enumerate(like.items()))


def export_graph_text(fn: Callable, example_args: Sequence[Any]) -> str:
    """The exported graph's readable Python code (each kernel an
    ``torch.ops.ofs.*`` call), for inspection."""
    return export_program(fn, example_args).graph_module.code


def _op_name(target) -> str:
    """``ofs.bucket_spmm`` / ``aten.mm``: an operator's namespace and name
    without its overload."""
    if isinstance(target, torch._ops.OpOverload):
        return f"{target.namespace}.{target._schema.name.split('::')[-1]}"
    return getattr(target, "__name__", str(target))


def ir_stats(fn: Callable, example_args: Sequence[Any]) -> dict:
    """``{"n_lines", "ops"}``: the lines of the exported graph's code and
    the histogram of its ``call_function`` targets (a mutating op that
    the graph wraps in ``auto_functionalized`` counts as itself)."""
    ep = export_program(fn, example_args)
    ops: Dict[str, int] = {}
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        if "auto_functionalized" in _op_name(target) and node.args:
            target = node.args[0]
        key = _op_name(target)
        ops[key] = ops.get(key, 0) + 1
    return {"n_lines": ep.graph_module.code.count("\n"), "ops": ops}
