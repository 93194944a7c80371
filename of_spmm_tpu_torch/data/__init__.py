from of_spmm_tpu_torch.data.cache import cache_path, cache_root, cached
from of_spmm_tpu_torch.data.dataset import (
    DataLoader,
    Dataset,
    ShardedDataset,
    TensorDataset,
    TokenDataset,
    shard_dataset,
)
from of_spmm_tpu_torch.data.records import (
    RecordDataset,
    RecordWriter,
    decode_example,
    encode_example,
    read_records,
)
from of_spmm_tpu_torch.data.vision import (
    CenterCrop,
    CocoDetection,
    Compose,
    ImageFolder,
    Normalize,
    RandomCrop,
    RandomHorizontalFlip,
    RandomResizedCrop,
    Resize,
    decode_image,
    detection_collate,
)
from of_spmm_tpu_torch.data.graphs import (
    NAMED_CONFIGS,
    GraphConfig,
    load_graph,
    random_features,
    synthetic_edges,
)

__all__ = ["DataLoader", "Dataset", "TensorDataset", "TokenDataset", "ShardedDataset",
           "shard_dataset", "cached", "cache_root", "cache_path", "NAMED_CONFIGS",
           "GraphConfig", "load_graph", "RecordDataset", "RecordWriter", "decode_example",
           "encode_example", "read_records", "CenterCrop", "CocoDetection", "Compose",
           "ImageFolder", "Normalize", "RandomCrop", "RandomHorizontalFlip", "RandomResizedCrop",
           "Resize", "decode_image", "detection_collate", "random_features", "synthetic_edges"]
