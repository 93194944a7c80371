"""Named mesh axes and the collectives over one axis, written once for both
execution forms (this replaces the JAX package's ``jax.sharding.Mesh``
and the ``axis_name`` collectives inside ``shard_map``).

A mesh has a ``shape`` and one name per axis (``axis_names``); shard s
of a mesh of S = prod(shape) shards sits at ``coords(shape)[s]``
(row-major). The bodies of the parallel strategies (tp, sp, ring, ep,
pipeline, ddp and the global view's boxing) hold every tensor with a
leading shard axis:

- on a ``ShardMesh`` (one process) that axis holds all S shards in mesh
  order, on the mesh's one device, and a collective over a named axis is
  a reshape to ``shape + block`` and then a sum, a concatenation, a chunk
  or a rotation along that axis (``StackedAxis``); autograd derives the
  backward, so a global input gets its exact gradient;
- over ranks (``RankGroup``, one process per shard) the leading axis
  holds 1 and each collective is a comm/ call on the process group of
  that mesh axis (``RankAxis``); its backward is the reverse collective,
  so a global input's gradient on a rank is that rank's share and the
  shares sum (over the ranks) to the gradient of the sum of the ranks'
  losses.

A value replicated over every shard may enter a body without the leading
axis: broadcasting hands it to each shard. Its gradient is then the sum
over the shards on a ShardMesh, and this rank's share over ranks
(``sum_shared`` of the mesh sums the shares).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch import comm


def coords(shape: Sequence[int]) -> List[Tuple[int, ...]]:
    """The mesh coordinates of shards 0 .. prod(shape) - 1, row-major."""
    return [tuple(int(c) for c in np.unravel_index(s, tuple(shape)))
            for s in range(math.prod(shape))]


class MeshAxes:
    """A mesh's ``shape`` and ``axis_names``: one axis named "x" by
    default, as the JAX package's meshes are."""

    def _set_axes(self, n: int, shape: Optional[Sequence[int]],
                  axis_names: Optional[Sequence[str]]) -> None:
        shape = (n,) if shape is None else tuple(int(s) for s in shape)
        if axis_names is None:
            if len(shape) != 1:
                raise ValueError(f"a mesh of shape {shape} needs axis_names")
            axis_names = ("x",)
        axis_names = tuple(axis_names)
        if math.prod(shape) != n or len(axis_names) != len(shape) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} with axes {axis_names} does not hold "
                             f"{n} shards")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names {axis_names} repeat")
        self.shape, self.axis_names = shape, axis_names

    def axis_index(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_index(name)]


def bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A body tensor ``t`` (leading shard axis first) with singleton axes
    after the shard axis, so that it broadcasts against ``ndim``-dim body
    tensors shard by shard."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - t.dim()) + t.shape[1:])


def _check_split(n: int, size: int, what: str) -> None:
    if size % n:
        raise ValueError(f"{what}: {size} does not split into {n} shards")


class StackedAxis:
    """Collectives over mesh axis ``dim`` on tensors whose leading axis
    holds all prod(shape) shards (the one-process form)."""

    def __init__(self, shape: Sequence[int], dim: int):
        self.shape, self.dim = tuple(shape), int(dim)
        self.size = self.shape[self.dim]

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.shape + tuple(x.shape[1:]))

    def _join(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape((-1,) + tuple(t.shape[len(self.shape):]))

    def _local(self, d: int) -> int:
        """Position of a body tensor's dim ``d`` (>= 1) once the mesh axis
        is unbound: the other mesh dims, then the block's."""
        return len(self.shape) - 2 + d

    def index(self, device=None) -> torch.Tensor:
        """Each shard's coordinate on this axis, (S,) int64."""
        return torch.tensor([c[self.dim] for c in coords(self.shape)], device=device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        t = self._split(x)
        return self._join(t.sum(self.dim, keepdim=True).expand(t.shape))

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's block concatenated along ``dim`` in axis order."""
        t = self._split(x)
        g = torch.cat(t.unbind(self.dim), dim=self._local(dim))
        return self._join(g.unsqueeze(self.dim).expand(
            self.shape + tuple(g.shape[len(self.shape) - 1:])))

    def psum_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the axis, chunk c along ``dim`` kept by coordinate c."""
        t = self._split(x).sum(self.dim)
        _check_split(self.size, t.shape[self._local(dim)], "psum_scatter")
        return self._join(torch.stack(t.chunk(self.size, self._local(dim)), self.dim))

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Chunk j along ``split_dim`` goes to coordinate j; each keeps the
        chunks it receives concatenated along ``concat_dim`` by sender."""
        n = self.size
        _check_split(n, x.shape[split_dim], "all_to_all")
        pieces = [s.chunk(n, self._local(split_dim)) for s in self._split(x).unbind(self.dim)]
        out = [torch.cat([pieces[c][j] for c in range(n)], self._local(concat_dim))
               for j in range(n)]
        return self._join(torch.stack(out, self.dim))

    def permute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Coordinate dst receives coordinate src's block for each
        (src, dst) pair; a coordinate named as no dst receives zeros."""
        src = self._split(x).unbind(self.dim)
        recv = {int(d): int(s) for s, d in perm}
        zero = torch.zeros_like(src[0])
        return self._join(torch.stack([src[recv[j]] if j in recv else zero
                                       for j in range(self.size)], self.dim))


class RankAxis:
    """The same collectives over a process group, on tensors whose leading
    axis holds this rank's one block (the rank form)."""

    def __init__(self, group, coord: int, size: int):
        self.group, self.coord, self.size = group, int(coord), int(size)

    def index(self, device=None) -> torch.Tensor:
        return torch.tensor([self.coord], device=device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x, self.group)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return comm.all_gather(x, self.group, dim)

    def psum_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return comm.reduce_scatter(x, self.group, dim)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        return comm.all_to_all(x, self.group, split_dim, concat_dim)

    def permute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        return comm.permute(x, perm, self.group)


__all__ = ["coords", "bcast", "MeshAxes", "StackedAxis", "RankAxis"]
