"""Embedding — the gather-backed lookup table, the counterpart of the JAX
package's ``models/embedding.py``.

The JAX module is the same lookup as its ``nn.layers.Embedding``:
``weight[indices]`` through the framework's gather, a zero row for an
index outside [0, num_embeddings), and a backward that sums the grads
of duplicate indices (the segment-sum pairing). The port's
``nn.layers.Embedding`` computes exactly that, so this module is it:
``Embedding(num_embeddings, embedding_dim, padding_idx=None,
device=None, generator=None)``, on the card unless ``device`` names
another; ``weight`` N(0, 1) with row ``padding_idx`` zero.
"""

from of_spmm_tpu_torch.nn.layers import Embedding

__all__ = ["Embedding"]
