from of_spmm_tpu_torch.models.gat import GAT
from of_spmm_tpu_torch.models.gcn import GCN, normalized_adjacency
from of_spmm_tpu_torch.models.sage import GraphSAGE, mean_adjacency
from of_spmm_tpu_torch.models.transformer import (
    EncoderBlock, TransformerEncoder, bert_base, bert_tiny)

__all__ = ["GAT", "GCN", "GraphSAGE", "mean_adjacency", "normalized_adjacency",
           "EncoderBlock", "TransformerEncoder", "bert_base", "bert_tiny"]
