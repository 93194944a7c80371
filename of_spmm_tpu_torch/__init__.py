"""of_spmm_tpu_torch: the PyTorch / CUDA port of of_spmm_tpu.

A second package beside the JAX one, for one NVIDIA H100. Its modules
mirror the JAX package's layout; every TPU kernel on a ported path becomes
a kernel written by hand for Hopper (``csrc/*.cu``), with a plain PyTorch
version beside it. The port imports neither JAX nor the JAX package.

Ported so far: the differentiable SpMM on every layout of the JAX package
(its backward the same engine on the transpose plan), the locality
reorder (``make_operator(reorder=...)``), SpGEMM (host and device), the
edge-list ops, GCN, GraphSAGE and GAT with full-batch training
(``python -m of_spmm_tpu_torch.examples.train_gcn``), the row-partitioned
SpMM and GCN step on a shard mesh or over ``torch.distributed`` ranks
(``parallel``, ``comm``, ``distributed``, ``train``), and the attention
path (flash attention, multi-head attention and the BERT-style
transformer encoder) for inference.

    from of_spmm_tpu_torch.data import load_graph, random_features
    from of_spmm_tpu_torch.models import GCN, bert_base, normalized_adjacency
    from of_spmm_tpu_torch.ops import make_operator, spgemm, spgemm_device
    from of_spmm_tpu_torch.parallel import ShardMesh, dist_spmm, partition_rows
    from of_spmm_tpu_torch.sparse import reorder_locality
"""

from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.binned import BinnedEll, EllBucket, bin_rows
from of_spmm_tpu_torch import ops
from of_spmm_tpu_torch.ops import spgemm
from of_spmm_tpu_torch import sparse
from of_spmm_tpu_torch import utils

__version__ = "0.1.0"

__all__ = ["COO", "CSR", "BinnedEll", "EllBucket", "bin_rows", "ops", "spgemm", "sparse",
           "utils", "__version__"]
