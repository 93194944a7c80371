"""Op layer: reference oracles, CUDA kernels, the SpMM operator and its
autograd pairing, the edge-list ops, SpGEMM, the registry."""

from of_spmm_tpu_torch.ops import reference
from of_spmm_tpu_torch.ops.autograd import (
    PaddedSpgemmPlan,
    ProductSpgemmPlan,
    SpgemmPlan,
    SpmmOperator,
    gather,
    make_operator,
    place_operator,
    place_spgemm_plan,
    sddmm,
    segment_softmax,
    segment_sum,
    spmm,
    spmm_coo,
    spgemm_device,
    spgemm_numeric,
    spgemm_numeric_padded,
    spgemm_numeric_products,
    spgemm_symbolic,
    spgemm_symbolic_padded,
    spgemm_symbolic_products,
    spmm_internal,
    spmv,
)
from of_spmm_tpu_torch.ops.cuda.expansion import expansion_spmm, place_plan, spmm_expansion
from of_spmm_tpu_torch.ops.cuda.expansion2 import expansion2_spmm, spmm_expansion2
from of_spmm_tpu_torch.ops.cuda.fused import fused_spmm
from of_spmm_tpu_torch.ops.cuda.panels import panel_spmm
from of_spmm_tpu_torch.ops.cuda.ranges import ranges_spmm
from of_spmm_tpu_torch.ops.cuda.spmm import bucket_spmm, gather_rows
from of_spmm_tpu_torch.ops.reference import spgemm
from of_spmm_tpu_torch.ops.registry import OpDef, ShardingRule, all_ops, lookup, register_op

__all__ = [
    "reference",
    "SpmmOperator",
    "make_operator",
    "place_operator",
    "spmm",
    "spmm_internal",
    "gather",
    "segment_sum",
    "spmv",
    "sddmm",
    "spmm_coo",
    "segment_softmax",
    "spgemm",
    "spgemm_device",
    "SpgemmPlan",
    "PaddedSpgemmPlan",
    "ProductSpgemmPlan",
    "spgemm_symbolic",
    "spgemm_symbolic_padded",
    "spgemm_symbolic_products",
    "spgemm_numeric",
    "spgemm_numeric_padded",
    "spgemm_numeric_products",
    "place_spgemm_plan",
    "OpDef",
    "ShardingRule",
    "all_ops",
    "lookup",
    "register_op",
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
