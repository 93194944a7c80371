"""Sharded embedding — the id-shuffle lookup over a row-sharded table, the
counterpart of the JAX package's ``models/sharded_embedding.py``.

The table is row-split S(0) over one mesh axis. One body, written once
over the axis's collectives (``parallel/mesh.py``), serves a
``ShardMesh`` (its shards batched along a leading axis) and ranks
(``RankGroup``, one shard a process):

1. all_gather of the batch's ids (each shard learns all requested ids),
2. a local zero-filled gather of ``ids - me * rows_per_shard`` (each
   shard contributes exactly the rows it owns, zeros elsewhere),
3. psum_scatter, which resolves the partial sum and returns each shard
   its own batch chunk.

The lookup is differentiable: the gather's backward is a segment sum
into the shard's rows, and the collectives' backwards are each other
(comm/'s autograd pairs over ranks), so the backward is the reverse
id-shuffle. The table's gradient is dense, as the JAX package's is.

Unlike the JAX package, every id outside [0, num_embeddings) gives a
zero row: there an id in [num_embeddings, padded_rows) falls inside the
last shard's range and returns that shard's padding row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from of_spmm_tpu_torch.ops.autograd import gather
from of_spmm_tpu_torch.parallel.global_view import GlobalTensor, sbp_for, shard, unshard


@dataclasses.dataclass(frozen=True)
class ShardedEmbedding:
    """Row-sharded embedding table over one mesh axis.

    num_embeddings is padded up to a multiple of the mesh axis size; ids
    >= num_embeddings (or negative) return zero rows.
    """

    num_embeddings: int
    embedding_dim: int
    axis: str = "x"

    def padded_rows(self, n_shards: int) -> int:
        return -(-self.num_embeddings // n_shards) * n_shards

    def init(self, generator: Optional[torch.Generator], mesh) -> dict:
        """The table N(0, 1 / embedding_dim), created with its S(0)
        placement on the mesh's device (never whole in one place): shard
        c's block is drawn from its own generator, seeded from
        ``generator`` and c, so the shard mesh and every rank hold the
        same table. Returns ``{"weight": GlobalTensor}`` (a leaf that
        requires grad)."""
        n = mesh.axis_size(self.axis)
        rows = self.padded_rows(n) // n
        axis = mesh.axis_index(self.axis)
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        shards = mesh.local_coords()
        w = torch.empty((len(shards), rows, self.embedding_dim), device=mesh.device)
        for k, c in enumerate(shards):
            g = torch.Generator(device=mesh.device).manual_seed(base + c[axis])
            w[k].normal_(generator=g)
        w.mul_(self.embedding_dim ** -0.5)
        return {"weight": GlobalTensor(w.requires_grad_(), sbp_for(mesh, **{self.axis: "S0"}),
                                       mesh)}

    def apply(self, params: dict, ids, mesh) -> torch.Tensor:
        """Lookup: ids (B,) integer (B divisible by the axis size) ->
        (B, D). ids enter row-split; output rows come back row-split: the
        whole (B, D) on a ShardMesh, this rank's (B / S, D) over ranks."""
        ids = torch.as_tensor(ids)
        if ids.dim() != 1:
            raise ValueError(f"ids must be rank-1, got shape {tuple(ids.shape)}")
        n = mesh.axis_size(self.axis)
        if ids.shape[0] % n:
            raise ValueError(
                f"batch {ids.shape[0]} not divisible by mesh axis "
                f"{self.axis}={n} (pad ids first)"
            )
        rows = self.padded_rows(n) // n
        sbp = sbp_for(mesh, **{self.axis: "S0"})
        ax = mesh.axis(self.axis)
        w = shard(params["weight"], sbp, mesh)  # (L, rows, D)
        ids_all = ax.all_gather(shard(ids.to(w.device).long(), sbp, mesh), 1)  # (L, B)
        local = ids_all - ax.index(w.device)[:, None] * rows
        owned = ((ids_all >= 0) & (ids_all < self.num_embeddings)
                 & (local >= 0) & (local < rows))
        # the L shards' blocks as one table: block k's rows start at k * rows
        block = torch.arange(w.shape[0], device=w.device)[:, None] * rows
        flat = torch.where(owned, local + block, -1)
        contrib = gather(w.reshape(-1, self.embedding_dim), flat.reshape(-1))
        contrib = contrib.reshape(flat.shape + (self.embedding_dim,))  # (L, B, D) partial
        return unshard(ax.psum_scatter(contrib, 1), sbp, mesh)  # my batch chunk, summed


__all__ = ["ShardedEmbedding"]
