from of_spmm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_sharded,
    save_checkpoint,
    save_sharded,
)
from of_spmm_tpu_torch.utils.config import FLAGS
from of_spmm_tpu_torch.utils import profiler
from of_spmm_tpu_torch.utils.summary import SummaryWriter, read_events
from of_spmm_tpu_torch.utils.device import resolve_device
from of_spmm_tpu_torch.utils.roofline import (
    PEAK_FP32_FLOPS,
    PEAK_HBM_BYTES_PER_S,
    PEAK_TENSOR16_FLOPS,
    PEAK_TF32_FLOPS,
    AttentionTraffic,
    PanelTraffic,
    SpmmTraffic,
    detect_peak_bw,
    detect_peak_fp32,
    detect_peak_tensor16,
    detect_peak_tf32,
    spmm_report,
    time_cuda,
)

__all__ = ["FLAGS", "load_checkpoint", "load_sharded", "save_checkpoint", "save_sharded", "resolve_device", "PEAK_HBM_BYTES_PER_S", "PEAK_FP32_FLOPS",
           "PEAK_TENSOR16_FLOPS", "PEAK_TF32_FLOPS", "AttentionTraffic",
           "detect_peak_tensor16", "detect_peak_tf32",
           "SpmmTraffic", "PanelTraffic", "detect_peak_bw", "detect_peak_fp32", "spmm_report",
           "time_cuda", "profiler", "SummaryWriter", "read_events"]
