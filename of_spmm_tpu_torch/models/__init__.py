from of_spmm_tpu_torch.models.embedding import Embedding
from of_spmm_tpu_torch.models.gat import GAT
from of_spmm_tpu_torch.models.gcn import GCN, normalized_adjacency
from of_spmm_tpu_torch.models.resnet import Bottleneck, ResNet, resnet50, resnet101
from of_spmm_tpu_torch.models.sage import GraphSAGE, mean_adjacency
from of_spmm_tpu_torch.models.sharded_embedding import ShardedEmbedding
from of_spmm_tpu_torch.models.transformer import (
    EncoderBlock, TransformerEncoder, bert_base, bert_tiny)
from of_spmm_tpu_torch.models.vision import VGG16, AlexNet, alexnet, vgg16

__all__ = ["Embedding", "ShardedEmbedding", "GAT", "GCN", "GraphSAGE", "mean_adjacency",
           "normalized_adjacency", "EncoderBlock", "TransformerEncoder", "bert_base", "bert_tiny",
           "Bottleneck", "ResNet", "resnet50", "resnet101", "VGG16", "AlexNet", "vgg16",
           "alexnet"]
