"""parallel: the row-partitioned SpMM and what builds and checks its plans.

    plan = partition_rows(a_hat, 4, ragged=True)              # host numpy
    y = dist_spmm(plan, x, ShardMesh(["cuda:0"] * 4))         # global X -> global Y
    y_block = dist_spmm(plan, x_block, RankGroup())           # one rank per process

Ported so far from the JAX package's parallel/: partition, dist_spmm and
consistency. The data, tensor, sequence, ring, expert and pipeline
parallel modules and the global view are not ported yet.
"""

from of_spmm_tpu_torch.parallel.consistency import check_consistent, plan_fingerprint
from of_spmm_tpu_torch.parallel.dist_spmm import (
    RankGroup,
    ShardMesh,
    default_mesh,
    dist_spmm,
    dist_spmm_allgather,
    exchange,
    pad_x_for_plan,
)
from of_spmm_tpu_torch.parallel.partition import (
    RowPartitionPlan,
    StackedBucket,
    make_panel_plan,
    partition_rows,
)

__all__ = ["RowPartitionPlan", "StackedBucket", "partition_rows", "make_panel_plan",
           "ShardMesh", "RankGroup", "default_mesh", "dist_spmm", "dist_spmm_allgather",
           "exchange", "pad_x_for_plan", "plan_fingerprint", "check_consistent"]
