from of_spmm_tpu_torch.models.gcn import GCN, normalized_adjacency
from of_spmm_tpu_torch.models.transformer import (
    EncoderBlock, TransformerEncoder, bert_base, bert_tiny)

__all__ = ["GCN", "normalized_adjacency", "EncoderBlock", "TransformerEncoder", "bert_base",
           "bert_tiny"]
