"""parallel: the row-partitioned SpMM, the global view and the parallel
strategies, on a shard mesh in one process or over ranks.

    plan = partition_rows(a_hat, 4, ragged=True)              # host numpy
    y = dist_spmm(plan, x, ShardMesh(["cuda:0"] * 4))         # global X -> global Y
    y_block = dist_spmm(plan, x_block, RankGroup())           # one rank per process

    mesh = ShardMesh(["cuda:0"] * 4, shape=(2, 2), axis_names=("dp", "tp"))
    y = make_tp_mlp(mesh, dp_axis="dp")(shard_tp_mlp(params, mesh), x)

The port of the JAX package's parallel/: partition, dist_spmm and
consistency (the halo-exchange SpMM); global_view (SBP placements and
their transitions); tp, sp, ring, ep and pipeline (tensor, Ulysses
sequence, ring context, expert and GPipe / 1F1B pipeline parallelism);
ddp (data parallelism over ``torch.optim``); auto_sharding (greedy
signature choice over ops/registry.py's rules). Each strategy's body is
written once over named mesh axes (mesh.py): on a ``ShardMesh`` its
shards run batched along a leading shard axis, over ranks
(``RankGroup(shape=..., axis_names=...)``) through comm/.
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
from of_spmm_tpu_torch.parallel.global_view import (
    GlobalTensor,
    materialize_partial,
    pad_to_multiple,
    reshard,
    sbp_of,
    sbp_to_spec,
    to_global,
    to_local,
)
from of_spmm_tpu_torch.parallel.tp import (
    column_parallel_linear,
    init_tp_mlp,
    make_tp_mlp,
    row_parallel_linear,
    shard_tp_mlp,
    tp_mlp_block,
)
from of_spmm_tpu_torch.parallel.sp import (
    SequenceParallelAttention,
    head_to_sequence,
    sequence_to_head,
    ulysses_attention,
)
from of_spmm_tpu_torch.parallel.ring import RingAttention, ring_attention
from of_spmm_tpu_torch.parallel.ep import MoELayer, expert_capacity, top_k_dispatch
from of_spmm_tpu_torch.parallel.pipeline import (
    PipelineModule,
    gpipe_spmd,
    pipeline_apply,
    pipeline_train_step_1f1b,
    stack_stage_params,
)
from of_spmm_tpu_torch.parallel.ddp import allreduce_gradients, broadcast_params, ddp_train_step

__all__ = ["RowPartitionPlan", "StackedBucket", "partition_rows", "make_panel_plan",
           "ShardMesh", "RankGroup", "default_mesh", "dist_spmm", "dist_spmm_allgather",
           "exchange", "pad_x_for_plan", "plan_fingerprint", "check_consistent",
           "GlobalTensor", "to_global", "pad_to_multiple", "to_local", "reshard", "sbp_of",
           "sbp_to_spec", "materialize_partial",
           "column_parallel_linear", "init_tp_mlp", "make_tp_mlp", "row_parallel_linear",
           "shard_tp_mlp", "tp_mlp_block",
           "SequenceParallelAttention", "head_to_sequence", "sequence_to_head",
           "ulysses_attention", "RingAttention", "ring_attention",
           "MoELayer", "expert_capacity", "top_k_dispatch",
           "PipelineModule", "gpipe_spmd", "pipeline_apply", "pipeline_train_step_1f1b",
           "stack_stage_params", "broadcast_params", "allreduce_gradients", "ddp_train_step"]
