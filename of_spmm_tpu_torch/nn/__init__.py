"""The module library: dense layers, norms and activations
(nn/layers.py), attention (nn/attention.py), the GNN convolutions
(nn/gnn.py), convolutions and pools (nn/conv.py, nn/volumetric.py), the
recurrent layers (nn/rnn.py), resizing, padding, distances and more
activations (nn/extras.py), ``Sequential`` and parameter accounting
(nn/module.py) and the loss functions (``losses``, nn/losses.py). It
exports what the JAX package's nn/__init__.py exports and the port's
transformer and GNN layers; the shrink activations and the ranking
losses stay in nn/volumetric.py and nn/extras.py, as there. Import it by
absolute path (``from of_spmm_tpu_torch import nn as onn``) beside
``torch.nn``."""

from of_spmm_tpu_torch.nn import losses
from of_spmm_tpu_torch.nn.attention import MultiheadAttention, scaled_dot_product_attention
from of_spmm_tpu_torch.nn.conv import (
    AdaptiveAvgPool2d, AvgPool2d, Conv1d, Conv2d, ConvTranspose2d, MaxPool2d)
from of_spmm_tpu_torch.nn.extras import (
    Flatten, PixelShuffle, ReflectionPad2d, ReplicationPad2d, Upsample, ZeroPad2d,
    cosine_similarity, glu, hardsigmoid, hardswish, hardtanh, interpolate, kl_div, mish,
    pairwise_distance, pixel_shuffle, pixel_unshuffle, softplus)
from of_spmm_tpu_torch.nn.gnn import GATConv, GCNConv, GINConv, SAGEConv
from of_spmm_tpu_torch.nn.layers import (
    BatchNorm, Dropout, Embedding, GroupNorm, InstanceNorm2d, LayerNorm, Linear, elu, gelu,
    leaky_relu, log_softmax, relu, sigmoid, silu, softmax, tanh)
from of_spmm_tpu_torch.nn.module import Sequential, is_stateful, param_bytes, param_count
from of_spmm_tpu_torch.nn.rnn import GRU, LSTM, RNN
from of_spmm_tpu_torch.nn.volumetric import (
    GLU, AdaptiveAvgPool1d, AdaptiveAvgPool3d, AdaptiveMaxPool1d, AdaptiveMaxPool2d,
    AdaptiveMaxPool3d, AvgPool1d, AvgPool3d, Conv3d, ConvTranspose1d, ConvTranspose3d, MaxPool1d,
    MaxPool3d, PReLU)

__all__ = [
    "losses", "MultiheadAttention", "scaled_dot_product_attention",
    "Linear", "Dropout", "LayerNorm", "Embedding", "BatchNorm", "GroupNorm", "InstanceNorm2d",
    "relu", "gelu", "silu", "sigmoid", "tanh", "softmax", "log_softmax", "leaky_relu", "elu",
    "Sequential", "param_count", "param_bytes", "is_stateful",
    "GCNConv", "SAGEConv", "GATConv", "GINConv",
    "Conv1d", "Conv2d", "ConvTranspose2d", "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d",
    "LSTM", "GRU", "RNN",
    "Conv3d", "ConvTranspose1d", "ConvTranspose3d", "MaxPool1d", "MaxPool3d", "AvgPool1d",
    "AvgPool3d", "AdaptiveAvgPool1d", "AdaptiveAvgPool3d", "AdaptiveMaxPool1d",
    "AdaptiveMaxPool2d", "AdaptiveMaxPool3d", "PReLU", "GLU",
    "interpolate", "Upsample", "ZeroPad2d", "ReflectionPad2d", "ReplicationPad2d",
    "pixel_shuffle", "pixel_unshuffle", "PixelShuffle", "Flatten", "cosine_similarity",
    "pairwise_distance", "kl_div", "hardsigmoid", "hardswish", "hardtanh", "mish", "softplus",
    "glu",
]
