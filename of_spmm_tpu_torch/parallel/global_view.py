"""Global view: SBP placements of tensors on a mesh, the port of the JAX
package's parallel/global_view.py.

- SBP atoms: ``"S<k>"`` (split on tensor axis k), ``"B"`` (replicated),
  ``"P"`` (partial sum: the shards add up to the value). nd-SBP is a
  tuple of atoms, one per mesh axis: ``("S0", "B")`` on a (dp, tp) mesh is
  the reference's [S(0), B].
- ``to_global(x, sbp, mesh)`` places a tensor (or a dict, list or tuple
  of them) as a ``GlobalTensor``; ``to_local`` gives the shards this
  process holds; ``reshard`` moves a GlobalTensor to another placement;
  ``sbp_of`` reads its placement back.

A ``GlobalTensor`` holds the blocks of the shards this process holds
along a leading shard axis, as a body does (parallel/mesh.py): all of
them on a ``ShardMesh``, this rank's over ranks (``RankGroup``). The
transitions are the reference's boxing (eager_boxing_interpreter_mgr.cpp:
132-179), done by hand on one mesh axis at a time through that axis's
collectives, so one code path serves both forms: S -> B an all-gather,
S(i) -> S(j) an all-to-all, P -> B an all-reduce, P -> S a
reduce-scatter, B -> S a local slice, B -> P zeros on all but the
axis's first shard. A tensor axis split over several mesh axes goes
through B on each (gathered minor axis first, sliced major axis first).
In the JAX package GSPMD does this work and P exists only inside
shard_map; here P is storable.

``torch.distributed.tensor`` (DTensor) would serve the rank form, but it
runs one process per shard, so it cannot hold S shards in one process:
the one type here serves both.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from of_spmm_tpu_torch.utils.tree import tree_map

SbpAtom = str  # "S0", "S1", ..., "B", "P"
Sbp = Union[SbpAtom, Sequence[SbpAtom]]

_S_RE = re.compile(r"^S(\d+)$")


def _atoms(sbp: Sbp) -> Tuple[SbpAtom, ...]:
    if isinstance(sbp, str):
        return (sbp,)
    return tuple(sbp)


def _check_atom(a: SbpAtom) -> None:
    if a in ("B", "P"):
        return
    if _S_RE.match(a):
        return
    raise ValueError(f"bad SBP atom {a!r} (want 'S<k>', 'B' or 'P')")


def _dim(a: SbpAtom) -> Optional[int]:
    """The tensor axis an atom splits (None for B and P)."""
    m = _S_RE.match(a)
    return int(m.group(1)) if m else None


def _mesh_atoms(sbp: Sbp, mesh, ndim: int) -> Tuple[SbpAtom, ...]:
    atoms = _atoms(sbp)
    if len(atoms) != len(mesh.axis_names):
        raise ValueError(f"sbp {atoms} has {len(atoms)} atoms but mesh has axes "
                         f"{mesh.axis_names}")
    for a in atoms:
        _check_atom(a)
        k = _dim(a)
        if k is not None and k >= ndim:
            raise ValueError(f"S{k} out of range for ndim={ndim}")
    return atoms


def sbp_to_spec(sbp: Sbp, mesh, ndim: int) -> tuple:
    """The (nd-)SBP signature as a partition spec: per tensor axis None or
    the mesh axis names that split it (a tuple when several do, in mesh
    order), as the JAX package's PartitionSpec. P has no storage spec and
    is rejected, as there."""
    atoms = _mesh_atoms(sbp, mesh, ndim)
    spec: list = [None] * ndim
    for axis_name, a in zip(mesh.axis_names, atoms):
        if a == "P":
            raise ValueError("P (partial-sum) is not a storable placement; resolve it "
                             "with materialize_partial inside shard_map")
        k = _dim(a)
        if k is None:
            continue
        if spec[k] is None:
            spec[k] = axis_name
        elif isinstance(spec[k], tuple):
            spec[k] = spec[k] + (axis_name,)
        else:
            spec[k] = (spec[k], axis_name)
    return tuple(spec)


def pad_to_multiple(x, axis: int, multiple: int, value=0):
    """Pad ``axis`` with ``value`` up to the next multiple of ``multiple``
    (split dims must divide by the mesh axis size)."""
    pad = -x.shape[axis] % multiple
    if pad == 0:
        return x
    if isinstance(x, np.ndarray):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths, constant_values=value)
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis % x.ndim) + 1] = pad
    return torch.nn.functional.pad(x, widths, value=value)


@dataclasses.dataclass(frozen=True)
class GlobalTensor:
    """A tensor placed on ``mesh`` with nd-SBP ``sbp``: ``local`` holds the
    blocks of the shards this process holds (mesh.local_coords()) along
    its leading axis."""

    local: torch.Tensor
    sbp: Tuple[SbpAtom, ...]
    mesh: Any

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape (P counts the block's shape)."""
        shape = list(self.local.shape[1:])
        for n, a in zip(self.mesh.shape, self.sbp):
            if _dim(a) is not None:
                shape[_dim(a)] *= n
        return tuple(shape)

    def full(self) -> torch.Tensor:
        """The global value, on every process (a reshard to B on every
        mesh axis)."""
        return reshard(self, ("B",) * len(self.sbp)).local[0]


def _take_block(local: torch.Tensor, d: int, ax) -> torch.Tensor:
    """B -> S(d - 1) on one mesh axis: each shard keeps its coordinate's
    block of body dim ``d``."""
    n = ax.size
    if local.shape[d] % n:
        raise ValueError(f"to_global: dim {d - 1} of the block {tuple(local.shape[1:])} does "
                         f"not divide by the mesh axis size {n}; pad first with "
                         f"parallel.pad_to_multiple")
    t = local.unflatten(d, (n, local.shape[d] // n)).movedim(d, 1)
    return t[torch.arange(t.shape[0], device=t.device), ax.index(t.device)]


def _first_only(local: torch.Tensor, ax) -> torch.Tensor:
    """B -> P on one mesh axis: the value on the axis's first shard,
    zeros on the others."""
    keep = (ax.index(local.device) == 0).to(local.dtype)
    return local * keep.view((-1,) + (1,) * (local.dim() - 1))


def _reshard_local(local: torch.Tensor, src: Tuple[SbpAtom, ...],
                   dst: Tuple[SbpAtom, ...], mesh) -> torch.Tensor:
    """The blocks of ``local`` (placed ``src``) moved to ``dst``, one mesh
    axis at a time; written once for both forms."""
    cur, n = list(src), len(src)
    touched = {_dim(a) for i in range(n) if src[i] != dst[i] for a in (src[i], dst[i])}
    touched.discard(None)

    def others_split(k: Optional[int], i: int) -> bool:
        return any(j != i and k in (_dim(cur[j]), _dim(dst[j])) for j in range(n))

    # lift to B what must change (and every split of a tensor axis that a
    # change touches), minor mesh axis first; S -> S' and P -> S in one
    # collective where no other mesh axis splits the tensor axes involved
    for i in reversed(range(n)):
        a, b, k = cur[i], dst[i], _dim(cur[i])
        if a == b and (k is None or k not in touched):
            continue
        ax = mesh.axis(mesh.axis_names[i])
        if (a != b and k is not None and _dim(b) is not None and not others_split(k, i)
                and not others_split(_dim(b), i)):
            local, cur[i] = ax.all_to_all(local, _dim(b) + 1, k + 1), b
        elif a == "P" and _dim(b) is not None and not others_split(_dim(b), i):
            local, cur[i] = ax.psum_scatter(local, _dim(b) + 1), b
        elif k is not None:
            local, cur[i] = ax.all_gather(local, k + 1), "B"
        elif a == "P":
            local, cur[i] = ax.psum(local), "B"
    # then B -> S or P, major mesh axis first
    for i in range(n):
        if cur[i] == dst[i]:
            continue
        ax = mesh.axis(mesh.axis_names[i])
        k = _dim(dst[i])
        local = _first_only(local, ax) if k is None else _take_block(local, k + 1, ax)
    return local


def _place_one(x, sbp: Sbp, mesh) -> GlobalTensor:
    if isinstance(x, GlobalTensor):
        return reshard(x, sbp, mesh)
    x = torch.as_tensor(x).to(mesh.device)
    atoms = _mesh_atoms(sbp, mesh, x.dim())
    replicas = x.unsqueeze(0).expand((len(mesh.local_coords()),) + tuple(x.shape))
    return GlobalTensor(_reshard_local(replicas, ("B",) * len(atoms), atoms, mesh), atoms, mesh)


def to_global(x, sbp: Sbp, mesh):
    """Place a tensor (or a dict, list or tuple of them) on ``mesh`` with
    the nd-SBP ``sbp``: every process passes the global value and keeps
    the blocks of its shards (a GlobalTensor is resharded). P puts the
    value on each P axis's first shard and zeros on the others. Split
    dims must divide by their mesh axes (pad_to_multiple first)."""
    return tree_map(lambda a: _place_one(a, sbp, mesh), x)


def to_local(x):
    """The blocks of the shards this process holds, one tensor each: all
    of a ShardMesh's, this rank's over ranks."""
    return tree_map(lambda g: list(g.local.unbind(0)), x)


def reshard(x, sbp: Sbp, mesh=None):
    """GlobalToGlobal: a GlobalTensor (or a tree of them) moved to the
    nd-SBP ``sbp`` on its mesh (``mesh``, when given, must be it)."""

    def one(g: GlobalTensor) -> GlobalTensor:
        if mesh is not None and mesh is not g.mesh:
            raise ValueError("reshard moves a GlobalTensor within its own mesh")
        atoms = _mesh_atoms(sbp, g.mesh, g.local.dim() - 1)
        return GlobalTensor(_reshard_local(g.local, g.sbp, atoms, g.mesh), atoms, g.mesh)

    return tree_map(one, x)


def materialize_partial(x: torch.Tensor, axis) -> torch.Tensor:
    """Resolve a partial-sum value inside a body: P -> B over ``axis`` (a
    mesh axis, ``mesh.axis(name)``), the ccl-p-to-b route."""
    return axis.psum(x)


def sbp_of(x: GlobalTensor, mesh) -> Tuple[SbpAtom, ...]:
    """The nd-SBP a GlobalTensor is placed with."""
    if not isinstance(x, GlobalTensor):
        raise ValueError("sbp_of reads a GlobalTensor (parallel.to_global)")
    if x.mesh is not mesh:
        raise ValueError("the tensor is placed on another mesh")
    return x.sbp


def shard(x, sbp: Sbp, mesh) -> torch.Tensor:
    """The body's leading-axis blocks of ``x`` under ``sbp``: x's own when
    x is a GlobalTensor of that placement, else those of to_global."""
    if isinstance(x, GlobalTensor) and x.sbp == _atoms(sbp) and x.mesh is mesh:
        return x.local
    return to_global(x, sbp, mesh).local


def unshard(local: torch.Tensor, sbp: Sbp, mesh) -> torch.Tensor:
    """A body's output blocks as an entry point returns them: on a mesh
    whose shards are all in this process the global value (S blocks
    concatenated, P summed, B the first shard's), over ranks this rank's
    block."""
    atoms = _atoms(sbp)
    if len(mesh.local_coords()) < mesh.size:
        return local[0]
    t = local.reshape(tuple(mesh.shape) + tuple(local.shape[1:]))
    for i in reversed(range(len(atoms))):
        k = _dim(atoms[i])
        if k is not None:
            t = torch.cat(t.unbind(i), dim=i + k)
        else:
            t = t.sum(i) if atoms[i] == "P" else t.select(i, 0)
    return t


def sbp_for(mesh, **atoms: SbpAtom) -> Tuple[SbpAtom, ...]:
    """nd-SBP over ``mesh`` naming some axes' atoms (``tp="S1"``), B on
    the others."""
    for name in atoms:
        mesh.axis_index(name)
    return tuple(atoms.get(name, "B") for name in mesh.axis_names)


__all__ = ["GlobalTensor", "sbp_to_spec", "pad_to_multiple", "to_global", "to_local",
           "reshard", "materialize_partial", "sbp_of", "shard", "unshard", "sbp_for", "tree_map"]
