"""embedding — large-scale embedding with tiered storage (one_embedding),
the counterpart of the JAX package's ``embedding/``.

- ``PersistentTable``: host-side file-backed KV table (ids -> rows) with
  snapshot save/load — the SSD tier; the JAX package's files.
- ``CachedEmbedding``: a row cache on the card in front of a
  PersistentTable with host-managed LRU admission; lookups dedup ids,
  fetch misses from the host tier and run one device gather; sparse
  gradient updates land in the cache (in place) and write back on
  eviction / flush.
- ``MultiTableEmbedding``: the multi-table API wrapper.
"""

from of_spmm_tpu_torch.embedding.one_embedding import (
    CachedEmbedding,
    MultiTableEmbedding,
    PersistentTable,
)

__all__ = ["PersistentTable", "CachedEmbedding", "MultiTableEmbedding"]
