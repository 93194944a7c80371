from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.binned import (
    DEFAULT_LADDER,
    BinnedEll,
    EllBucket,
    bin_rows,
    bin_rows_relabeled,
)
from of_spmm_tpu_torch.sparse.tiled import DEFAULT_TIER_SIZE, TieredEll, bin_rows_tiered
from of_spmm_tpu_torch.sparse.panels import (
    PanelPlan,
    PanelSegment,
    PanelWindows,
    attach_windows,
    build_panels_plan,
    ensure_masks,
)
from of_spmm_tpu_torch.sparse.fused import FusedPlan, FusedSegment, build_fused_plan
from of_spmm_tpu_torch.sparse.ranges import RangesPlan, RangesSegment, build_ranges_plan
from of_spmm_tpu_torch.sparse.reorder import (
    bfs_order,
    label_prop_order,
    locality_stats,
    matching_order,
    reorder_locality,
)
from of_spmm_tpu_torch.sparse.staged_windows import StagedWindows
from of_spmm_tpu_torch.sparse.expansion import ExpansionGroup, ExpansionPlan, build_expansion_plan
from of_spmm_tpu_torch.sparse.expansion2 import (
    Expansion2Group,
    Expansion2Plan,
    build_expansion2_plan,
    factor_rank1,
)

__all__ = ["COO", "CSR", "BinnedEll", "EllBucket", "bin_rows", "bin_rows_relabeled",
           "DEFAULT_LADDER", "TieredEll", "bin_rows_tiered", "DEFAULT_TIER_SIZE",
           "PanelPlan", "PanelSegment", "PanelWindows", "attach_windows",
           "build_panels_plan", "ensure_masks", "FusedPlan", "FusedSegment",
           "build_fused_plan", "RangesPlan", "RangesSegment", "build_ranges_plan",
           "StagedWindows", "ExpansionGroup", "ExpansionPlan", "build_expansion_plan",
           "Expansion2Group", "Expansion2Plan", "build_expansion2_plan", "factor_rank1",
           "bfs_order", "label_prop_order", "matching_order", "reorder_locality",
           "locality_stats"]
