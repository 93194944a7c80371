from of_spmm_tpu_torch.models.gcn import GCN, normalized_adjacency

__all__ = ["GCN", "normalized_adjacency"]
