"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the work a step or a request needs, counted from
shapes.

``SpmmTraffic`` is a frozen copy of ``of_spmm_tpu_torch/utils/roofline.py``'s
byte and FLOP arithmetic; the peaks are NVIDIA's data-sheet figures (dense,
without sparsity), keyed by the name ``torch.cuda.get_device_name()``
reports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 data sheet: SXM5 80 GB HBM3 3.35 TB/s and 67 TFLOP/s float32
# outside the tensor cores; PCIe 2.0 TB/s, 51 TFLOP/s; NVL 3.9 TB/s, 60.
PEAK_HBM_BYTES_PER_S: Dict[str, float] = {
    "H100 80GB HBM3": 3.35e12,
    "H100 SXM": 3.35e12,
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}
PEAK_FP32_FLOPS: Dict[str, float] = {
    "H100 80GB HBM3": 67e12,
    "H100 SXM": 67e12,
    "H100 PCIe": 51e12,
    "H100 NVL": 60e12,
}


def _lookup(table: Dict[str, float], device_name: str) -> Optional[float]:
    """The peak of the card ``device_name`` names; None for a device
    without one (the CPU)."""
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def peak_hbm_bytes_per_s(device_name: str) -> Optional[float]:
    return _lookup(PEAK_HBM_BYTES_PER_S, device_name)


def peak_fp32_flops(device_name: str) -> Optional[float]:
    return _lookup(PEAK_FP32_FLOPS, device_name)


@dataclasses.dataclass(frozen=True)
class SpmmTraffic:
    """Minimum HBM traffic of one Y = A @ X (bytes), float32 values and
    int32 column indices."""

    nnz: int
    n_rows: int
    n_cols: int
    d: int
    bytes_val: int = 4
    bytes_idx: int = 4

    @property
    def structure_bytes(self) -> int:
        return self.nnz * (self.bytes_val + self.bytes_idx)  # vals + cols

    @property
    def output_bytes(self) -> int:
        return self.n_rows * self.d * self.bytes_val

    @property
    def compulsory_bytes(self) -> int:
        x_once = self.n_cols * self.d * self.bytes_val
        return x_once + self.structure_bytes + self.output_bytes

    @property
    def flops(self) -> int:
        return 2 * self.nnz * self.d


def dense_flops(n: int, fan_in: int, fan_out: int) -> int:
    """One (n, fan_in) @ (fan_in, fan_out) product."""
    return 2 * n * fan_in * fan_out
