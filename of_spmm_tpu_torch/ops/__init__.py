"""Op layer: reference oracles, CUDA kernels, the SpMM operator."""

from of_spmm_tpu_torch.ops import reference
from of_spmm_tpu_torch.ops.autograd import (
    SpmmOperator,
    make_operator,
    place_operator,
    spmm,
    spmm_internal,
)
from of_spmm_tpu_torch.ops.cuda.expansion import expansion_spmm, place_plan, spmm_expansion
from of_spmm_tpu_torch.ops.cuda.expansion2 import expansion2_spmm, spmm_expansion2
from of_spmm_tpu_torch.ops.cuda.fused import fused_spmm
from of_spmm_tpu_torch.ops.cuda.panels import panel_spmm
from of_spmm_tpu_torch.ops.cuda.ranges import ranges_spmm
from of_spmm_tpu_torch.ops.cuda.spmm import bucket_spmm, gather_rows

__all__ = [
    "reference",
    "SpmmOperator",
    "make_operator",
    "place_operator",
    "spmm",
    "spmm_internal",
    "bucket_spmm",
    "gather_rows",
    "panel_spmm",
    "fused_spmm",
    "ranges_spmm",
    "expansion_spmm",
    "expansion2_spmm",
    "spmm_expansion",
    "spmm_expansion2",
    "place_plan",
]
