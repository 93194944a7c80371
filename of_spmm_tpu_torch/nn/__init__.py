"""The module library: the dense layers and attention of the transformer
path (nn/layers.py, nn/attention.py), the GNN convolutions (nn/gnn.py)
and the loss functions (``losses``, nn/losses.py). Import it by absolute
path (``from of_spmm_tpu_torch import nn as onn``) beside ``torch.nn``."""

from of_spmm_tpu_torch.nn import losses
from of_spmm_tpu_torch.nn.attention import MultiheadAttention, scaled_dot_product_attention
from of_spmm_tpu_torch.nn.gnn import GATConv, GCNConv, GINConv, SAGEConv
from of_spmm_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear, gelu

__all__ = ["Dropout", "Embedding", "GATConv", "GCNConv", "GINConv", "LayerNorm", "Linear",
           "MultiheadAttention", "SAGEConv", "gelu", "losses", "scaled_dot_product_attention"]
