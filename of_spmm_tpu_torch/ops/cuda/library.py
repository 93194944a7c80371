"""The hand-written kernels as PyTorch operators, namespace ``ofs``.

Each of the eight kernels of the main path is one
``torch.library.custom_op`` (``torch.ops.ofs.<name>``), defined in the
kernel's own module beside its launcher and its plain version:

- ``bucket_spmm``, ``gather_rows`` (ops/cuda/spmm.py): each writes a
  buffer the caller passes (``out``, declared mutated), so the bucket
  kernel can fill a slice of a concatenation;
- ``panel_spmm``, ``fused_spmm``, ``ranges_spmm`` (one launch per plan
  segment, looped inside the op), ``expansion_spmm``, ``expansion2_spmm``
  and ``flash_attention``: each returns a new tensor.

An op's CUDA implementation is the ctypes launch (``build.LAUNCHES``
counts there and nowhere else); its CPU implementation is the plain
version beside the kernel; its fake implementation gives the output's
shape, dtype and device from the arguments' metadata and touches no data.
A CUDA tensor never reaches the plain version. The arguments are tensors,
lists of tensors (``None`` for a plan's absent array), ints, floats and
bools: a plan object is flattened by its wrapper (``bucket_spmm_plan``,
``panel_spmm``, ...) and rebuilt inside the op as a namespace of the
fields the launcher and the plain version read (``rebuild``).

Because the plan enters as plain tensors, ``torch.export`` records each
launch as one ``ofs.*`` node with the plan's arrays as lifted constants,
and a saved program runs the same kernels once this module's ops are
registered (importing ``of_spmm_tpu_torch.ops`` does it; ``load_ops``
says so explicitly). Two kernels read a device table of raw addresses
(the bucket kernel's buckets, the expansion kernels' groups): the op
builds that table from its own arguments at call time (``device_table``,
cached by its content), so no program holds addresses as a constant.
"""

from __future__ import annotations

import collections
import importlib
import threading
import types
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

NAMESPACE = "ofs"
# the kernel module that defines each op
OPS: Dict[str, str] = {
    "bucket_spmm": "spmm", "gather_rows": "spmm", "panel_spmm": "panels",
    "fused_spmm": "fused", "ranges_spmm": "ranges", "expansion_spmm": "expansion",
    "expansion2_spmm": "expansion2", "flash_attention": "flash_attention",
}
TABLE_CACHE = 64  # address tables kept per process

_TABLES: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_TABLE_LOCK = threading.Lock()
_BUILT_FOR: Dict[int, tuple] = {}  # id(work units) -> the table rows they were cut for


def define(name: str, cpu: Callable, cuda: Callable, fake: Callable,
           mutates_args: Tuple[str, ...] = ()):
    """``ofs::<name>`` with ``cpu`` (whose annotations give the schema) as
    its CPU implementation, ``cuda`` as its CUDA one and ``fake`` as its
    shape function."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=mutates_args,
                                 device_types="cpu")
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op


def load_ops() -> Dict[str, object]:
    """Import every kernel module, which registers its ops; returns
    ``{name: torch.ops.ofs.<name>}``. A process that loads a saved
    program calls this (or imports ``of_spmm_tpu_torch.ops``) first."""
    for mod in sorted(set(OPS.values())):
        importlib.import_module(f"of_spmm_tpu_torch.ops.cuda.{mod}")
    return {name: getattr(getattr(torch.ops, NAMESPACE), name) for name in OPS}


def device_table(rows: Sequence[Sequence[int]], width: int, device) -> torch.Tensor:
    """An int64 (len(rows), width) tensor of ``rows`` on ``device``, from
    a cache keyed by the rows themselves (addresses and sizes): a table
    found there is equal to one built now, whatever freed and reused the
    memory since."""
    key = (str(torch.device(device)), tuple(tuple(int(v) for v in r) for r in rows))
    with _TABLE_LOCK:
        table = _TABLES.get(key)
        if table is not None:
            _TABLES.move_to_end(key)
            return table
    table = torch.tensor(key[1], dtype=torch.int64).reshape(-1, width).to(device)
    with _TABLE_LOCK:
        _TABLES[key] = table
        while len(_TABLES) > TABLE_CACHE:
            _TABLES.popitem(last=False)
    return table


def bind_work(units: torch.Tensor, rows: Sequence[Sequence[int]]) -> None:
    """Remember the table rows a placed work list (its ``units`` tensor)
    was cut for, while that tensor lives (``check_work``)."""
    key = id(units)
    _BUILT_FOR[key] = tuple(tuple(int(v) for v in r) for r in rows)
    weakref.finalize(units, _BUILT_FOR.pop, key, None)


def check_work(units: torch.Tensor, rows: Sequence[Sequence[int]], what: str) -> None:
    """Refuse a placed work list whose arrays have moved since placement:
    its units index buckets or groups that ``rows`` (the table of this
    call's arguments) no longer describe. A work list not placed in this
    process (a saved program's constant) came with its arrays and passes."""
    want = _BUILT_FOR.get(id(units))
    if want is not None and want != tuple(tuple(int(v) for v in r) for r in rows):
        raise ValueError(f"{what}: the work list was built for other arrays: place the "
                         "plan again (ops.place_operator / ops.place_plan)")


def flatten(objs: Iterable[object], names: Sequence[str]) -> list:
    """``getattr(obj, name)`` for each object and each name (dotted names
    reach into sub-objects; a missing attribute is None), object by
    object: the op's argument list of a plan's segments or groups."""
    out = []
    for obj in objs:
        for name in names:
            v = obj
            for part in name.split("."):
                v = getattr(v, part, None) if v is not None else None
            out.append(v)
    return out


def rebuild(values: Sequence[object], names: Sequence[str], **extra) -> types.SimpleNamespace:
    """The namespace whose (dotted) ``names`` hold ``values`` (one object's
    share of ``flatten``), plus ``extra`` attributes."""
    ns = types.SimpleNamespace(**extra)
    for name, v in zip(names, values):
        *path, last = name.split(".")
        cur = ns
        for part in path:
            if not hasattr(cur, part):
                setattr(cur, part, types.SimpleNamespace())
            cur = getattr(cur, part)
        setattr(cur, last, v)
    return ns


def chunks(values: Sequence[object], size: int) -> list:
    """``values`` cut into consecutive runs of ``size`` (one per object)."""
    return [list(values[i:i + size]) for i in range(0, len(values), size)] if size else []


def plan_op(name: str, *, arrays: Tuple[str, ...], ints: Tuple[str, ...], items: str,
            item_arrays: Tuple[str, ...], item_ints: Tuple[str, ...],
            derived: Callable[[types.SimpleNamespace], dict], plain: Callable,
            launch: Callable) -> Callable:
    """Register ``ofs::<name>`` for an engine whose plan is arrays and
    ints plus a tuple of segments or groups (``items``), each arrays and
    ints. The op's arguments: ``x``, the plan's shape, the plan's
    ``arrays`` (dotted names reach into sub-objects) and ``ints``, then
    every item's ``item_arrays`` and ``item_ints``. Inside, the plan is
    rebuilt as a namespace with ``derived(plan)``'s attributes added (its
    properties), and ``plain(plan, x)`` runs on the CPU, ``launch(plan,
    x)`` on the card; both return Y (shape[0], d) float32. Returns
    ``run(plan, x)``, which flattens a checked, placed plan into the op.

    ofs::<name>(Tensor x, int[] shape, Tensor?[] plan_arrays, int[] plan_ints,
                Tensor?[] part_arrays, int[] part_ints) -> Tensor
    """
    def unflatten(shape, plan_arrays, plan_ints, part_arrays, part_ints):
        parts = [rebuild(a + i, item_arrays + item_ints) for a, i in
                 zip(chunks(part_arrays, len(item_arrays)), chunks(part_ints, len(item_ints)))]
        plan = rebuild(list(plan_arrays) + list(plan_ints), arrays + ints, shape=tuple(shape),
                       **{items: parts})
        for k, v in derived(plan).items():
            setattr(plan, k, v)
        return plan

    def cpu(x: torch.Tensor, shape: List[int], plan_arrays: List[Optional[torch.Tensor]],
            plan_ints: List[int], part_arrays: List[Optional[torch.Tensor]],
            part_ints: List[int]) -> torch.Tensor:
        return plain(unflatten(shape, plan_arrays, plan_ints, part_arrays, part_ints), x)

    def cuda(x, shape, plan_arrays, plan_ints, part_arrays, part_ints) -> torch.Tensor:
        return launch(unflatten(shape, plan_arrays, plan_ints, part_arrays, part_ints), x)

    def fake(x, shape, plan_arrays, plan_ints, part_arrays, part_ints) -> torch.Tensor:
        return x.new_empty((shape[0], x.shape[1]))

    op = define(name, cpu, cuda, fake)

    def run(plan, x: torch.Tensor) -> torch.Tensor:
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
        parts = getattr(plan, items)
        return op(x, list(plan.shape), flatten([plan], arrays),
                  [int(v) for v in flatten([plan], ints)], flatten(parts, item_arrays),
                  [int(v) for v in flatten(parts, item_ints)])

    return run
