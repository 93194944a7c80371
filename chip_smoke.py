#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (of_spmm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with the card
    python3 chip_smoke.py --parent DIR   # op_overhead also runs the checkout at DIR

Builds the port's CUDA kernels from the checkout's sources (one nvcc per
source, started together), holds each against its plain PyTorch version
on the card, then runs the main path on each of the port's engines: GCN
inference at the width of OGB's published GCN baseline for arxiv (3
layers, hidden 256) on synthetic ogbn-arxiv, through
load_graph -> normalized_adjacency -> make_operator -> GCN.forward, first
on the default (tiered) layout and then on layout="panels", "fused",
"ranges" and "expansion". Each engine also times one SpMM on
products-small. The expansion engine v2, which has no operator layout,
runs through its own entry points (build_expansion2_plan ->
spmm_expansion2) on arxiv and products-small, as tools/bench_expansion2.py
drives the JAX package's.

Then training on the same path: one full-batch GCN training step on
arxiv (loss_fn -> backward -> clip -> Adam; each SpMM's backward is the
same kernel on the transpose plan) on every layout, its loss and grads
against impl="torch" and its launches held exactly, then a few epochs of
the training example's ``train``; the same for GraphSAGE on arxiv's
mean adjacency (not symmetric: transpose plans of their own), and one
GAT step on cora against the CPU.

Then the training stack (graph/, optim/, amp/, utils/checkpoint.py): the
GCN example's TrainGraph (Adam, warmup + cosine, clipping) on the tiered
arxiv operator, 20 steps in float32 against PR 13's step and 20 under
AMP (bf16 compute, float32 masters; the first step's loss and grads
against impl="torch"), every step's bucket_spmm and gather_rows launches
held exactly, a save / load resume against the uninterrupted run; then
the BERT example (examples/train_bert.py) at its defaults in float32,
with AMP and with grad accumulation 2, BERT-base masked-LM steps at full
width (AMP against float32, grad accumulation 2 against 1, ZeRO-1 on
four shards of the card against stage 0), and the lazy sparse Adam
update of BERT-base's token table against dense Adam.

Then the locality reorder and SpGEMM: GCN inference on arxiv with its
node ids shuffled by a seeded permutation (as bench.py --shuffled does)
through make_operator(reorder="match") on the panels, fused and ranges
layouts, against impl="torch" and the unshuffled logits, the reorder's
seconds and band coverage, each layout's SpMM beside the unshuffled and
the shuffled-without-reorder figures, and one backward; then the arxiv
2-hop product A @ A: the host product and the symbolic phases timed on
the host, the plain, product-form and padded numeric phases on the card
against the host product, torch.sparse.mm beside them, the numeric
again with new values on the reused plans, and an operator built from
spgemm_device(A_hat, A_hat) on cora against two SpMMs.

Then the distributed SpMM: arxiv row-partitioned into four shards on the
one card (ShardMesh(["cuda:0"] * 4)) by four plans (padded; ragged,
refined and 1,024 replicated hubs; ragged on the panel engine; split
with hubs on the panel engine), each through dist_spmm forward and
backward on bucket_spmm or panel_spmm against the plain version on the
same plan and the single-operator SpMM, its launches held exactly;
dist_gcn_apply on two of them against the single-operator logits; one
make_dist_train_step step against the plain step; and the rank form over
an NCCL group of world size 1 against the shard mesh (more ranks need
more cards). Then the distributed training example
(examples/train_dist.py) on arxiv in four shards on the card: its first
step against the plain step, 20 steps of its loop with bucket_spmm's
launches held exactly and the losses falling, and its main through the
launcher at NCCL world size 1 against the shard mesh at S = 1.

Then the attention path: the flash-attention kernel against its plain
version on small cases (float32, bfloat16, float16; no keys gives
zeros), BERT-base inference
(bert_base -> TransformerEncoder.forward, seeded weights, B = 8,
T = 512, float32 with TF32 off) whose every block's attention input is
run again through MultiheadAttention(flash=True) with the block's own
parameters, non-causal and causal, against the dense attention; one
block's gradients through flash=True against the dense core; and the
kernel alone at BERT-base's attention shape.

Then the parallel strategies on four shards of the card
(ShardMesh(["cuda:0"] * 4), the shards batched along a leading axis):
Ulysses and ring attention at BERT-base's attention width against the
dense MultiheadAttention with the same parameters, and the ring at
T = 4096 beside the dense attention's time and memory; the tensor-parallel MLP
on 4 shards and on (2, 2) dp x tp, and a MoE layer at Switch-Base-8's
expert width, against their single-device forms (the MoE's routing
replayed from the sharded run, its flips counted); BERT-base's 12 blocks
as a 4-stage GPipe and 1F1B pipeline against the sequential stack; DDP
with torch.optim.SGD on a BERT-base classifier against the single-device
step; every S / B / P transition of reshard on 1-D and (2, 2) meshes;
and the TP and ring rank forms at NCCL world size 1.

Then the vision path (the rest of nn/ and the CNNs; cuDNN convolutions,
no kernel of the port): ResNet-50 (resnet50, 1,000 classes) on 32 x 3 x
224 x 224 in float32, its eval logits against the same weights in
float64 and one SGD training step held stage by stage (stem, 16 blocks,
head) against float64 on the float32 run's own stage inputs and output
gradients, with its ReLU branches and max-pool argmaxes replayed: every
gradient, BatchNorm buffer and updated parameter; the whole step against
float64 beside it (train-mode BatchNorm compounds float32 rounding about
1.3x a block); VGG16 and AlexNet at B = 16, eval logits against float64
and the dropout of a seeded generator reproducible; each with its eval
and step times, images/s and peak memory; and each ported module of nn/
(LSTM and GRU at T 128, B 32, 512 -> 1024, Conv3d, ConvTranspose2d,
bilinear interpolate, GroupNorm, InstanceNorm2d, BatchNorm) on the card
against the CPU, forward and gradients.

Then the embedding path and the input pipeline (no kernel of the port;
each phase holds its launches at none): ShardedEmbedding at MLPerf
DLRM's Criteo Terabyte table (40,000,000 x 128) S(0) over four shards of
the card, B = 65,536 seeded ids with about 1% outside the table, its
forward against a dense zero-filled lookup bit for bit, the table's grad
against the dense lookup's, one SGD step, the dense grad's zero-fill
and the same lookup through gather_rows on the flattened table (its
launches counted apart); a MultiTableEmbedding of four CachedEmbeddings
(dim 128, 2^23-row PersistentTables behind 2^17 cache slots on the
card) through 12 steps of the JAX training loop on power-law ids, with
LRU evictions and dirty write-backs, held against the same ids on the
CPU (slots and meta equal), then flush and a snapshot round trip, the
phases in profiler ranges and the losses through SummaryWriter; and
512 seeded 375 x 500 images written into record files, read through
RecordDataset, RandomResizedCrop / flip / Normalize and the DataLoader at
0 and 8 workers (the two passes bit-equal), then ResNet-50 trained from
them, beside resnet_main_path's step.

Then export and the framework's harnesses: the arxiv GCN on each of the
five layouts, spmm_expansion2 on arxiv and the BERT-base encoder with
flash=True (B 8, T 512) exported with the kernels kept in the program
(each kernel a torch.library op, its ofs nodes counted against the
eager launches), saved, loaded in this process and in a fresh python3,
and held against eager with the launches held exactly (export_main_path);
the ops' dispatch cost on the tiered GCN forward and a BERT-base
masked-LM step in fresh processes, beside the parent commit's when
``--parent DIR`` names its checkout (op_overhead); each torch-twin
converter's module on the card against torch's own, flash MHA at
BERT-base width among them, and autoprof's table of them
(autotest_card); and the entry points, entry() with the
products-small canary and dryrun_multichip(4) (entry_main_path).

Last, the microbenchmarks (of_spmm_tpu_torch/tools/): the SpMM inner
loop (microbench_blockfma, microbench_mxu, microbench_cond, proto_fused)
and the gathers (microbench_gather, microbench_gather2 with window and
twosided, microbench_dyngather): each tool's entry point at its default
size, the TPU tool's full width, then its kernels against their plain
versions on two small seeded cases (blockfma_b, mxu_step, cond_steps,
onehot, twosided and take_along also at their edges) and the default
inputs, beside the plain versions' and, where one exists, one PyTorch
call's times.

Each phase prints one JSON line. Before the last line come the
``{"kernels": [...]}`` summary and the card's name and power limit as
nvidia-smi reports them; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from of_spmm_tpu_torch import distributed, native
from of_spmm_tpu_torch.data import (
    Compose, DataLoader, Dataset, Normalize, RandomHorizontalFlip, RandomResizedCrop,
    RecordDataset, RecordWriter, load_graph, random_features)
from of_spmm_tpu_torch.data import vision as vision_data
from of_spmm_tpu_torch.embedding import CachedEmbedding, MultiTableEmbedding, PersistentTable
from of_spmm_tpu_torch.amp import DEFAULT_POLICY
from of_spmm_tpu_torch.autoprof import profile_module, table
from of_spmm_tpu_torch.entry import dryrun_multichip, entry
from of_spmm_tpu_torch.export import export_model, ir_stats, load_model
from of_spmm_tpu_torch.examples.train_gcn import make_graph, make_optimizer, train, train_step
from of_spmm_tpu_torch.examples import train_bert, train_dist
from of_spmm_tpu_torch.graph import compute_call
from of_spmm_tpu_torch.optim.indexed_slices import IndexedSlices, sparse_adam_update
from of_spmm_tpu_torch.models import (
    GAT, GCN, GraphSAGE, ShardedEmbedding, alexnet, bert_base, mean_adjacency,
    normalized_adjacency, resnet50, vgg16)
from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch import optim
from of_spmm_tpu_torch.nn import MultiheadAttention, gelu
from of_spmm_tpu_torch.nn.losses import cross_entropy
from of_spmm_tpu_torch.ops import (
    make_operator, place_operator, place_plan, place_spgemm_plan, spgemm, spgemm_device,
    spgemm_numeric, spgemm_numeric_padded, spgemm_numeric_products, spgemm_symbolic,
    spgemm_symbolic_padded, spgemm_symbolic_products, spmm, spmm_expansion2, spmm_internal)
from of_spmm_tpu_torch.ops import reference as ref
from of_spmm_tpu_torch.ops.autograd import SpmmOperator, gather
from of_spmm_tpu_torch.ops.cuda import expansion as ekernels
from of_spmm_tpu_torch.ops.cuda import expansion2 as e2kernels
from of_spmm_tpu_torch.ops.cuda import flash_attention as fakernels
from of_spmm_tpu_torch.ops.cuda import fused as fkernels
from of_spmm_tpu_torch.ops.cuda import microbench_blockfma as kblockfma
from of_spmm_tpu_torch.ops.cuda import microbench_cond as kcond
from of_spmm_tpu_torch.ops.cuda import microbench_dyngather as kdyn
from of_spmm_tpu_torch.ops.cuda import microbench_gather as kgather
from of_spmm_tpu_torch.ops.cuda import microbench_gather2 as kgather2
from of_spmm_tpu_torch.ops.cuda import microbench_mxu as kmxu
from of_spmm_tpu_torch.ops.cuda import panels as pkernels
from of_spmm_tpu_torch.ops.cuda import proto_fused as kproto
from of_spmm_tpu_torch.ops.cuda import ranges as rkernels
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
from of_spmm_tpu_torch.ops.flash_attention import flash_attention
from of_spmm_tpu_torch.parallel import (
    MoELayer, PipelineModule, RankGroup, RingAttention, SequenceParallelAttention, ShardMesh,
    check_consistent, ddp_train_step, dist_spmm, dist_spmm_allgather, exchange, expert_capacity,
    init_tp_mlp, make_tp_mlp, pad_x_for_plan, partition_rows, pipeline_train_step_1f1b, reshard,
    shard_tp_mlp, stack_stage_params, to_global)
from of_spmm_tpu_torch.sparse import staged_windows
from of_spmm_tpu_torch.sparse.expansion import (
    ExpansionPlan, attach_stage_rows, build_expansion_plan, plan_memory_report)
from of_spmm_tpu_torch.sparse.expansion2 import build_expansion2_plan
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.fused import FusedPlan, build_fused_plan
from of_spmm_tpu_torch.sparse.panels import (
    C_SBIG, C_TFIRST, C_TILE, UNIT_EDGES, PanelPlan, attach_windows, build_panels_plan,
    ensure_masks, work_units)
from of_spmm_tpu_torch.sparse.ranges import RangesPlan, build_ranges_plan
from of_spmm_tpu_torch.sparse.reorder import locality_stats, reorder_locality
from of_spmm_tpu_torch.sparse.tiled import TieredEll
from of_spmm_tpu_torch.testing import ATOL as AUTOTEST_ATOL
from of_spmm_tpu_torch.testing import RTOL as AUTOTEST_RTOL
from of_spmm_tpu_torch.testing import check_module_against_torch
from of_spmm_tpu_torch.tools import microbench_blockfma as tblockfma
from of_spmm_tpu_torch.tools import microbench_cond as tcond
from of_spmm_tpu_torch.tools import microbench_dyngather as tdyn
from of_spmm_tpu_torch.tools import microbench_gather as tgather
from of_spmm_tpu_torch.tools import microbench_gather2 as tgather2
from of_spmm_tpu_torch.tools import microbench_mxu as tmxu
from of_spmm_tpu_torch.tools import proto_fused as tproto
from of_spmm_tpu_torch.train import dist_gcn_apply, make_dist_train_step
from of_spmm_tpu_torch.utils import SummaryWriter, profiler, read_events
from of_spmm_tpu_torch.utils.roofline import (
    AttentionTraffic, ExpansionTraffic, PanelTraffic, SpmmTraffic, StagedTraffic, detect_peak_bw,
    WARMUP_CALLS, detect_peak_fp32, detect_peak_tensor16, detect_peak_tf32, spmm_report, time_cuda,
    wall_ms)

SOURCES = {
    "bucket_spmm": "of_spmm_tpu_torch/csrc/spmm.cu",
    "gather_rows": "of_spmm_tpu_torch/csrc/spmm.cu",
    "panel_spmm": "of_spmm_tpu_torch/csrc/panels.cu",
    "fused_spmm": "of_spmm_tpu_torch/csrc/fused.cu",
    "ranges_spmm": "of_spmm_tpu_torch/csrc/ranges.cu",
    "expansion_spmm": "of_spmm_tpu_torch/csrc/expansion.cu",
    "expansion2_spmm": "of_spmm_tpu_torch/csrc/expansion2.cu",
    "flash_attention": "of_spmm_tpu_torch/csrc/flash_attention.cu",
    "microbench_blockfma_a": "of_spmm_tpu_torch/csrc/microbench_blockfma.cu",
    "microbench_blockfma_b": "of_spmm_tpu_torch/csrc/microbench_blockfma.cu",
    "microbench_mxu": "of_spmm_tpu_torch/csrc/microbench_mxu.cu",
    "microbench_cond": "of_spmm_tpu_torch/csrc/microbench_cond.cu",
    "proto_fused": "of_spmm_tpu_torch/csrc/proto_fused.cu",
    # take_fused and dma_deep launch microbench_gather.cu's ELL kernels
    **{k: "of_spmm_tpu_torch/csrc/microbench_gather.cu"
       for k in ("gather_vmem_loop", "gather_vmem_take", "gather_onehot", "gather_block_slice",
                 "gather_row_dma", "gather2_take_fused", "gather2_dma_deep")},
    **{k: "of_spmm_tpu_torch/csrc/microbench_gather2.cu"
       for k in ("gather2_onehot_pair", "gather2_window_pair", "gather2_twosided")},
    "dyngather_take_along": "of_spmm_tpu_torch/csrc/microbench_dyngather.cu",
    "dyngather_smem_cap": "of_spmm_tpu_torch/csrc/microbench_dyngather.cu",
}
REPLACES = {
    "bucket_spmm": "of_spmm_tpu/ops/pallas/spmm.py:46",
    "gather_rows": "of_spmm_tpu/ops/pallas/spmm.py:146",
    "panel_spmm": "of_spmm_tpu/ops/pallas/panels.py:49",
    "fused_spmm": "of_spmm_tpu/ops/pallas/fused.py:49",
    "ranges_spmm": "of_spmm_tpu/ops/pallas/ranges.py:46",
    "expansion_spmm": "of_spmm_tpu/ops/pallas/expansion.py:72",
    "expansion2_spmm": "of_spmm_tpu/ops/pallas/expansion2.py:46",
    "flash_attention": "of_spmm_tpu/ops/pallas/flash_attention.py:36",
    "microbench_blockfma_a": "tools/microbench_blockfma.py:61",
    "microbench_blockfma_b": "tools/microbench_blockfma.py:98",
    "microbench_mxu": "tools/microbench_mxu.py:88",
    "microbench_cond": "tools/microbench_cond.py:105",
    "proto_fused": "tools/proto_fused.py:131",
    "gather_vmem_loop": "tools/microbench_gather.py:138",
    "gather_vmem_take": "tools/microbench_gather.py:175",
    "gather_onehot": "tools/microbench_gather.py:219",
    "gather_block_slice": "tools/microbench_gather.py:263",
    "gather_row_dma": "tools/microbench_gather.py:314",
    "gather2_onehot_pair": "tools/microbench_gather2.py:57",
    "gather2_take_fused": "tools/microbench_gather2.py:95",
    "gather2_dma_deep": "tools/microbench_gather2.py:150",
    "gather2_window_pair": "tools/microbench_gather2.py:210",
    "gather2_twosided": "tools/microbench_gather2.py:294",
    "dyngather_take_along": "tools/microbench_dyngather.py:54",
    "dyngather_smem_cap": "tools/microbench_dyngather.py:85",
}
# the engines whose plan is a FusedPlan / RangesPlan: kernel module, plan type
STAGED = {"fused": (fkernels, FusedPlan), "ranges": (rkernels, RangesPlan)}
# the one-hot expansion kernels: wrapper, plain version
EXPANSION = {"expansion_spmm": (ekernels.expansion_spmm, ekernels.expansion_spmm_torch),
             "expansion2_spmm": (e2kernels.expansion2_spmm, e2kernels.expansion2_spmm_torch)}
EXPANSION_WIDTHS = (40, 128, 256, 7)  # d % 128 != 0; float4 and scalar paths
BUCKET_WIDTHS = (3, 5, 9, 17, 33, 64, 153, 256)
FEATURE_WIDTHS = (128, 256, 60)
STAGED_WIDTHS = (128, 256, 60, 7)  # the fused and ranges kernels: float4 and scalar paths
GCN_DIMS = (128, 256, 256, 40)  # OGB's GCN baseline for ogbn-arxiv: 3 layers, hidden 256
REORDER_SEED = 123  # bench.py --shuffled's permutation seed
REORDER_METHOD = "match"  # bench.py --shuffled's reorder: multilevel heavy-edge matching
REORDER_LAYOUTS = ("panels", "fused", "ranges")  # the layouts make_operator(reorder=) takes
REORDER_GRAD_LAYOUT = "panels"  # the reordered layout whose backward is checked
SPGEMM_PADDED_WIDTH = 512  # spgemm_symbolic_padded's default max_width
SPGEMM_PADDED_MAX_BYTES = 8 << 30  # the padded form runs at arxiv when its plan fits this
SPGEMM_SMALL_SEED, SPGEMM_SMALL_N, SPGEMM_SMALL_NNZ = 4, 20_000, 200_000  # else this one
SPGEMM_VALUES_SEED = 5  # new values for the reused plans
SPGEMM_COMPOSE_LAYOUTS = ("panels", "tiered")  # operators built from spgemm_device's C
MAIN_PATH_REL_TOL = 1e-4
# the training phases: every layout, the timed steps, the example's epochs
TRAIN_LAYOUTS = ("tiered", "panels", "fused", "ranges", "expansion")
TRAIN_STEPS, TRAIN_EPOCHS, TRAIN_LR = 20, 5, 1e-2
GAT_HEADS, GAT_HIDDEN = 4, 8
# the TrainGraph phases: the GCN example's graph for GRAPH_STEPS steps per
# precision (PR 13's step beside its first GRAPH_REF_STEPS, the resume
# check saving after GRAPH_RESUME_AT), the AMP step's bar against the
# plain version; the BERT example at its defaults; BERT-base masked LM
GRAPH_STEPS, GRAPH_REF_STEPS, GRAPH_RESUME_AT, GRAPH_AMP_TOL, RESUME_TOL = 20, 5, 10, 1e-2, 1e-6
BERT_EXAMPLE_STEPS = 20
MLM_BATCH, MLM_SEQ, MLM_VOCAB, MLM_LR = 8, 128, 30522, 1e-4
MLM_AMP_STEPS, MLM_ZERO_STEPS, MLM_ZERO_SHARDS, MLM_TIME_ITERS, MLM_AMP_TOL = 10, 2, 4, 5, 1e-2
# the kernels a training step on each layout launches: kernel -> layout
TRAIN_KERNELS = {"bucket_spmm": "tiered", "gather_rows": "tiered", "panel_spmm": "panels",
                 "fused_spmm": "fused", "ranges_spmm": "ranges", "expansion_spmm": "expansion"}
PANEL_WIDTHS = (128, 256, 60, 7)  # the panel kernel: float4 and scalar paths
# the distributed phase: S shards of arxiv on one card, the plans it drives
# (explicit hubs: replicate_hubs="auto" picks none on arxiv), the width
DIST_SHARDS, DIST_HUBS, DIST_D, DIST_ITERS = 4, 1024, 128, 10
DIST_PLANS = (
    ("P1", {}),
    ("P2", dict(ragged=True, refine_slack=0.2, replicate_hubs=DIST_HUBS)),
    ("P3", dict(ragged=True, local_engine="panels")),
    ("P4", dict(ragged=True, split_boundary=True, replicate_hubs=DIST_HUBS,
                local_engine="panels")),
)
DIST_GCN_PLANS = ("P1", "P3")  # dist_gcn_apply on these; the training step on P1
# the distributed example: its shards and steps on arxiv; the launcher's time limit
TRAIN_DIST_SHARDS, TRAIN_DIST_STEPS, LAUNCH_TIMEOUT = 4, 20, 300
# the parallel strategies on PAR_SHARDS shards of one card: BERT-base's
# attention and MLP widths, Switch-Base-8's experts, BERT-base's blocks in
# a pipeline, a BERT-base classifier under DDP, the reshard tensor
PAR_SHARDS, PAR_ITERS = 4, 10
PAR_EMBED, PAR_HEADS, PAR_FFN = 768, 12, 3072
PAR_ATTN_BATCH, PAR_ATTN_SEQ, RING_LONG_SEQ = 8, 512, 4096
MOE_EXPERTS, MOE_TOPK, MOE_CF, MOE_TOKENS = 8, 2, 1.25, 4096
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 512
DDP_BATCH, DDP_SEQ, DDP_LR = 8, 128, 1e-2
RESHARD_SHAPE = (4096, 768)
# the vision path: ResNet-50 at B 32 x 3 x 224 x 224 (eval, one SGD step),
# VGG16 and AlexNet at B 16; the nn/ modules each at one size a user runs
RESNET_BATCH, VISION_BATCH, VISION_SIZE, VISION_CLASSES = 32, 16, 224, 1000
VISION_LR, VISION_MOMENTUM, VISION_ITERS = 0.1, 0.9, 10
RNN_T, RNN_B, RNN_I, RNN_H = 128, 32, 512, 1024
# the embedding path: MLPerf DLRM's Criteo Terabyte table (--max-ind-range=
# 40000000, sparse feature size 128) S(0) over 4 shards of the card, a
# batch of ids with about 1% outside the table, one SGD step; the tiered
# cache: 4 of DLRM's 26 tables (independent: a cut), each 2^23 rows behind
# 2^17 slots, B ids a table a step from a power law; the input pipeline:
# ImageNet-sized uint8 images in record files into ResNet-50
SHARDED_ROWS, SHARDED_DIM, SHARDED_SHARDS, SHARDED_BATCH = 40_000_000, 128, 4, 65_536
SHARDED_OUT_OF_RANGE, SHARDED_LR, SHARDED_ITERS = 0.01, 0.1, 5
CACHE_TABLES, CACHE_DIM, CACHE_TABLE_ROWS, CACHE_SLOTS = 4, 128, 1 << 23, 1 << 17
CACHE_BATCH, CACHE_STEPS, CACHE_ZIPF, CACHE_LR = 65_536, 12, 1.05, 1.0
RECORD_IMAGES, RECORD_SHAPE, RECORD_FILES, RECORD_BATCH = 512, (375, 500, 3), 4, 32
RECORD_WORKERS, RECORD_STEPS, RECORD_SEED = (0, 8), 8, 51
# kBatch, kListCap, kChunk of csrc/panels.cu and csrc/staged_spmm.cuh
PANEL_BATCH, PANEL_LIST, PANEL_CHUNK = 8, 4096, 8
UNIT_CAPS = (2048, 4096, 8192, 16384, 65536)  # work-unit edge caps the panel phases time
BUCKET_CAPS = (1024, 2048, 4096, 16384)  # padded slots per unit the bucket phases time
BUCKET_SMALL_CAP = 256  # a cap below the widest rows: each is a unit alone
EXPANSION_CAPS = (2048, 8192, 16384)  # lanes per unit the expansion phases time
EXPANSION_SMALL_CAP = 512  # hub blocks cut into several units
EXPANSION_WARPS, EXPANSION_CHUNK = 16, 32  # csrc/expansion.cuh: warps, lanes a warp takes
STAGED_CAPS = (2048, 8192, 16384)  # work-unit selection caps the fused and ranges phases time
# flash_attention against its plain version, |k - p| <= atol + rtol |p| in
# the working type: bf16 / fp16 are looser because the kernel sums in
# another order and rounds P to that type before P V
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2),
             torch.float16: (1e-2, 1e-2)}
# (BH, Tq, Tk, d, block_q, block_k, causal): the JAX tests' shapes, T = 100
# at the default blocks, Tq != Tk both ways, and the head widths of the
# repository (8, 32, 64, 128) up to the kernel's limit (256), with 40 and
# 80 (padded to 48 and 80 by the bf16 / fp16 kernel); T = 100 and 160
# leave ragged ends of the kernel's 64-row tiles
FLASH_CASES = ((6, 128, 128, 128, 128, 128, False), (6, 128, 128, 128, 128, 128, True),
               (6, 384, 384, 128, 128, 128, False), (6, 384, 384, 128, 128, 128, True),
               (6, 100, 100, 64, 256, 256, False), (6, 100, 100, 64, 256, 256, True),
               *((6, 128, 256, 64, 128, 128, c) for c in (False, True)),
               *((6, 256, 128, 64, 128, 128, c) for c in (False, True)),
               *((4, 160, 160, d, 256, 256, c) for d in (8, 32, 40, 64, 80, 128, 256)
                 for c in (False, True)))
FLASH_NO_KEY_WIDTHS = (8, 64, 256)  # Tk = 0 cases: each type's output must be zeros
BERT_BATCH, BERT_SEQ = 8, 512  # BERT-base attention: BH = 96 heads of d = 64
GRAD_TOL = 2e-4  # tests/test_flash_attention.py's bar for the flash gradients
# the microbenchmark kernels against their plain versions: elementwise
# 1e-5 + 1e-4|p| where every term is positive (blockfma, proto_fused);
# normwise max |k - p| <= 1e-4 max |p| where long float32 sums of both
# signs are taken in another order (mxu: the kernels' count times window
# products against the plain version's float64 sum of up to 2,048,000
# lanes a row; cond: the plain version's 4,096 terms a tile against the
# kernel's 256 count times window terms)
MICROBENCH_NORM_TOL = 1e-4
# two small seeded cases per tool, beside its default size (seed 0); then
# blockfma_b's, mxu_step's and cond_steps' edges (tools' B_EDGES and EDGES:
# one row a step, rows no slot names, K 8 and 512, an odd R; a count at its
# ceiling S G 128, R 500 and 300, a window of one block, one step;
# full-range masks with counts at G, mixed gcnt, G 4 and 36) on
# NaN-poisoned output memory
BLOCKFMA_SMALL = ((64, 256, 32, 1), (1000, 8192, 64, 2))  # C, T, K, seed
MXU_SMALL = ((3, 1), (50, 2))                            # S, seed
COND_SMALL = ((3, 1), (40, 2))                           # steps, seed
EDGE_SEEDS = (3, 4)
# N R T S TILES seed; then the redesign's edges: an R that no power-of-two
# slice divides, with a few empty rows (3,200 lanes a tile), mostly empty
# rows, and the sort's fallbacks (a tile's 102,400 lanes past a block's
# shared memory; S = 64,000 scols past what is left of it); every kernel
# output lands on NaN-poisoned memory
PROTO_SMALL = ((4096, 128, 256, 1600, 2, 1), (50_000, 512, 1024, 3200, 5, 2),
               (4096, 1000, 128, 1600, 3, 3), (4096, 8192, 128, 1600, 2, 4),
               (4096, 1000, 4096, 1600, 1, 5), (4096, 512, 1024, 64000, 1, 6))
# the variant whose time stands in the kernels line: the TPU function's
# default size where its tool's main() runs it, else main()'s first run
MICROBENCH_MAIN = {"microbench_blockfma_a": "A", "microbench_blockfma_b": "B",
                   "microbench_mxu": "chain2", "microbench_cond": "nocond",
                   "proto_fused": "fused",
                   "gather_vmem_loop": "C=8192", "gather_vmem_take": "C=8192",
                   "gather_onehot": "C=512 float32", "gather_block_slice": "C=8192",
                   "gather_row_dma": "W=16", "gather2_onehot_pair": "C=128",
                   "gather2_take_fused": "C=16384", "gather2_dma_deep": "W=32",
                   "gather2_window_pair": "TILE=1024 CW=128",
                   "gather2_twosided": "TILE=1024 CW=256 R=256",
                   "dyngather_take_along": "tala_eq C=2048 T=2048",
                   "dyngather_smem_cap": "largest that works"}
# the microbenchmark kernels that no one PyTorch call computes: why
LIBRARY_NONE = {
    "microbench_cond": "none: per step the count matrix of the groups run (each mask "
                       "word's bits unpacked and summed over the groups) times the window, "
                       "then the halves added; an unpack, a sum, a bmm and an add, not one "
                       "call",
    "dyngather_smem_cap": "none: it probes the opt-in shared-memory limit of a launch; "
                          "its result is a copy of its input",
}
# the gather kernels against their plain versions: bit-exact where the
# kernel moves values (row gathers, one-hot products: 1 x v plus zeros, the
# hi + lo add in float32), elementwise 1e-5 + 1e-4|p| where it sums
# positive terms in another order (the ELL forms, block_slice), normwise
# 1e-4 max|p| for twosided (lanes and blocks' partials added with atomics
# in no fixed order)
GATHER_EXACT = ("gather_vmem_take", "gather_onehot", "gather2_onehot_pair",
                "gather2_window_pair", "dyngather_take_along", "dyngather_smem_cap")
# two small seeded cases per kernel (seeds 1 and 2), beside every row of
# its tool's run at the default size (seed 0): odd widths, partial waves,
# windows that are not a multiple of 128; take_along also at its
# redesign's edges (C 65,536: the direct L2 kernel; C 15,000: 3 lanes a
# slice, the last of 2; C 5,000: 8; T 1,001 rows: a partial last block;
# each output on NaN-poisoned memory); onehot, onehot_pair, window_pair
# and twosided also at their redesign's edges (seeds 3 and 4,
# outside=True: indices below 0 and at or past the window,
# tools/microbench_gather.with_outside; for twosided R = 1000 and 1024,
# whose (R, 128) partials exceed a block's shared memory and are sliced
# unevenly, last blocks partial)
GATHER_SMALL = {
    "gather_vmem_loop": (dict(C=64, T=2048, K=16), dict(C=1000, T=1 << 16, K=128)),
    "gather_vmem_take": (dict(C=64, T=2048), dict(C=5000, T=1 << 16)),
    "gather_onehot": (dict(C=64, T=2048, dtype="float32"),
                      dict(C=300, T=1 << 14, dtype="bfloat16"),
                      dict(C=300, T=1 << 14, dtype="float32", outside=True),
                      dict(C=64, T=2048, dtype="bfloat16", outside=True)),
    "gather_block_slice": (dict(C=64, T=2048, K=8), dict(C=3000, T=1 << 17, K=64)),
    "gather_row_dma": (dict(table_rows=300, T=2048, W=16),
                       dict(table_rows=100_000, T=1 << 15, W=7)),
    "gather2_onehot_pair": (dict(C=64, T=2048), dict(C=200, T=1 << 14),
                            dict(C=200, T=1 << 14, outside=True)),
    "gather2_take_fused": (dict(C=64, T=2048, K=8), dict(C=5000, T=1 << 16, K=8)),
    "gather2_dma_deep": (dict(table_rows=300, T=2048, W=128),
                         dict(table_rows=100_000, T=1 << 15, W=48)),
    "gather2_window_pair": (dict(TILE=1024, CW=128, T=2048, U=300),
                            dict(TILE=256, CW=100, T=1 << 14, U=2000),
                            dict(TILE=256, CW=100, T=1 << 14, U=2000, outside=True)),
    "gather2_twosided": (dict(TILE=512, CW=128, R=64, T=4096),
                         dict(TILE=256, CW=200, R=300, T=1 << 14),
                         dict(TILE=256, CW=200, R=1000, T=256 * 501, outside=True),
                         dict(TILE=1024, CW=256, R=1024, T=1024 * 75, outside=True)),
    "dyngather_take_along": (dict(C=64, T=32, shape="ne", steps=2),
                             dict(C=5000, T=300, shape="bcast", steps=3),
                             dict(C=65536, T=300, shape="ne", steps=3),
                             dict(C=15000, T=1000, shape="ne", steps=2),
                             dict(C=5000, T=0, shape="eq", steps=4),
                             dict(C=2048, T=1001, shape="ne", steps=5)),
    "dyngather_smem_cap": (dict(nbytes=4096), dict(nbytes=49168)),
}

# A bucket column one past the end of x: the kernel must stop with a
# device-side assertion. Run in a child process, because the assertion
# leaves that process's CUDA context unusable.
BAD_COLUMN_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
x = torch.zeros((16, 8), device="cuda")
cols = torch.zeros((4, 3), dtype=torch.int32, device="cuda")
cols[2, 1] = 16
kernels.bucket_spmm(cols, torch.ones((4, 3), device="cuda"), x)
torch.cuda.synchronize()
print("no error")
"""

# A panel plan whose take table names rows past the end of x: the panel
# kernel must stop with a device-side assertion (child process, as above).
BAD_WINDOW_PROBE = """
import numpy as np, torch
from of_spmm_tpu_torch.ops import make_operator, spmm_internal
from of_spmm_tpu_torch.sparse.formats import CSR
rng = np.random.default_rng(0)
dense = ((rng.random((256, 1024)) < 0.05) * rng.standard_normal((256, 1024))).astype(np.float32)
op = make_operator(CSR.from_dense(dense), layout="panels")  # per-edge: every row scattered
for seg in op.binned.segments:
    seg.stage_take.fill_(1 << 30)
spmm_internal(op, torch.zeros((1024, 8), device="cuda"))
torch.cuda.synchronize()
print("no error")
"""

# A row index one past the end of the tier: the gather kernels must stop
# with a device-side assertion (child process, as above).
BAD_GATHER_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import microbench_gather as kgather
cols = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
cols[0, 77] = 64
kgather.vmem_take(cols, torch.zeros((64, 128), device="cuda"))
torch.cuda.synchronize()
print("no error")
"""

# A window_pair step whose CW-row window runs past the table's end: the
# row gather must stop with a device-side assertion (child process, as
# above).
BAD_PAIR_WINDOW_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import microbench_gather2 as kgather2
bases = torch.tensor([[0], [200]], dtype=torch.int32, device="cuda")
lidx = torch.zeros((4, 128), dtype=torch.int32, device="cuda")
hi = torch.zeros((256, 128), dtype=torch.bfloat16, device="cuda")
kgather2.window_pair(bases, lidx, hi, hi.clone(), 128)
torch.cuda.synchronize()
print("no error")
"""

# A ranges plan whose window provenance names rows past the end of x: the
# kernel (shared with the fused engine) must stop with a device-side
# assertion (child process, as above).
BAD_STAGED_PROBE = """
import numpy as np, torch
from of_spmm_tpu_torch.ops import make_operator, spmm_internal
from of_spmm_tpu_torch.sparse.formats import CSR
rng = np.random.default_rng(0)
dense = ((rng.random((4096, 8192)) < 0.001) * rng.standard_normal((4096, 8192))).astype(np.float32)
op = make_operator(CSR.from_dense(dense), layout="ranges")  # thin blocks: scattered rows
assert op.binned.n_scattered > 0
for seg in op.binned.segments:
    seg.windows.staged_rows.fill_(1 << 30)
spmm_internal(op, torch.zeros((8192, 8), device="cuda"))
torch.cuda.synchronize()
print("no error")
"""


# An expansion plan whose staged rows name X rows past the end of x: the
# kernel (shared by both expansion engines) must stop with a device-side
# assertion (child process, as above). {v} is "" or "2".
BAD_EXPANSION_PROBE = """
import numpy as np, torch
from of_spmm_tpu_torch.ops import place_plan, spmm_expansion{v}
from of_spmm_tpu_torch.sparse.expansion{v} import build_expansion{v}_plan
from of_spmm_tpu_torch.sparse.formats import CSR
rng = np.random.default_rng(0)
dense = ((rng.random((256, 1024)) < 0.05) * rng.standard_normal((256, 1024))).astype(np.float32)
plan = place_plan(build_expansion{v}_plan(CSR.from_dense(dense)), "cuda")
for g in plan.groups:
    g.stage_row.fill_(1 << 30)
spmm_expansion{v}(plan, torch.zeros((1024, 8), device="cuda"))
torch.cuda.synchronize()
print("no error")
"""


# mxu_step with one index outside its range ({bad}: a window block past
# the window, a lane index of 128, a tile row of R): the kernel must stop
# with a device-side assertion (child process, as above).
BAD_MXU_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import microbench_mxu as kmxu
blk = torch.zeros((4, 1, 2), dtype=torch.int32, device="cuda")
lidx = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
lrow = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
win = torch.zeros((256, 256), dtype=torch.bfloat16, device="cuda")
{{"blk": blk, "lidx": lidx, "lrow": lrow}}["{bad}"].view(-1)[5] = {{"blk": 2, "lidx": 128, "lrow": 500}}["{bad}"]
kmxu.mxu_step("chain2", blk, lidx, lrow, win, 500)
torch.cuda.synchronize()
print("no error")
"""

# take_along with an index one past the table ({C} rows: 64 stages a slice
# in shared memory, 65,536 takes the direct L2 kernel): the kernel must stop
# with a device-side assertion (child process, as above).
BAD_TAKE_ALONG_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import microbench_dyngather as kdyn
idx = torch.zeros((4, 128), dtype=torch.int32, device="cuda")
idx[2, 77] = {C}
kdyn.take_along(idx, torch.zeros(({C}, 128), device="cuda"), 3)
torch.cuda.synchronize()
print("no error")
"""


# blockfma_a's sliced kernel (a 4-column slice of the {C}-row tier in each
# block's shared memory) with a start at C - 7, its last 8-row block past
# the tier: it must stop with a device-side assertion (child process, as
# above).
BAD_SLICED_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import microbench_blockfma as kb
starts = torch.zeros((64, 32), dtype=torch.int32, device="cuda")
starts[37, 5] = {C} - 7
assert kb.a_stages({C}, kb.smem_optin(starts.device)) > 0
kb.blockfma_a(starts, torch.ones((64, 256), device="cuda"), torch.zeros(({C}, 128), device="cuda"))
torch.cuda.synchronize()
print("no error")
"""


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|: the normwise relative error of a against b."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """|k - p| <= 1e-5 + 1e-4 |p| elementwise; returns max |k - p|."""
    err = (got - want).abs()
    bad = err > 1e-5 + 1e-4 * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of tolerance, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_bucket(R, K, n_x, gen, device):
    """A padded-ELL bucket like the planner's: each row a random length,
    trailing slots col 0 / val 0, values positive with row sums <= 1 as
    in a normalized adjacency."""
    cols = torch.randint(0, n_x, (R, K), generator=gen, dtype=torch.int32)
    vals = torch.rand((R, K), generator=gen) / K
    lens = torch.randint(1, K + 1, (R, 1), generator=gen)
    pad = torch.arange(K)[None, :] >= lens
    cols[pad], vals[pad] = 0, 0.0
    return cols.to(device), vals.to(device)


def _bound(nbytes: int, nops: int, peak_bw: float, peak_fp32: float):
    """Least time for the work (ms) and what sets it: bytes over HBM
    bandwidth or float32 operations over the non-tensor-core peak."""
    t_bytes, t_ops = nbytes / peak_bw * 1e3, nops / peak_fp32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_figures(plan, work, n_cols: int, d: int, gen, peak_bw: float,
                   peak_fp32: float) -> dict:
    """Each kernel over all its launches in one SpMM of a tiered plan at
    width d: its launches (counted over one such SpMM), its time, its
    plain version's, the one PyTorch call that computes the same function,
    and the bound of that work.

    The bucket phase's function is X -> the concatenation of every
    bucket's partial rows (one launch over the plan's work list ``work``);
    its library call is torch.sparse.mm with one CSR holding every
    bucket's entries (tier offsets applied). The gather phase's is the
    finish's row gathers from that concatenation; its library call is
    torch.index_select (indices clamped into range: index_select has no
    zero-fill). The bound counts each bucket's cols and vals, the X rows
    they reference and the partial rows once; the work list (a few KB)
    stays out of it.
    """
    dev = torch.device("cuda", 0)
    x = torch.randn((n_cols, d), generator=gen).to(dev)
    buckets = kernels.plan_buckets(plan)
    cat = torch.empty((plan.n_ell_rows, d), device=dev)

    def run_plain():
        r0 = 0
        for c, v, o in buckets:
            kernels.bucket_spmm_torch(c, v, x, o, out=cat[r0:r0 + c.shape[0]])
            r0 += c.shape[0]

    with torch.inference_mode():
        kernels.reset_launch_counts()
        kernels.bucket_spmm_plan(plan, x, work, out=cat)
        bucket_launches = kernels.LAUNCHES["bucket_spmm"]
        bucket_ms = time_cuda(lambda: kernels.bucket_spmm_plan(plan, x, work, out=cat), iters=20)
        bucket_plain_ms = time_cuda(run_plain, iters=5)
        rows_l, cols_l, vals_l = [], [], []
        r0 = 0
        for c, v, o in buckets:
            r, k = (v != 0).nonzero(as_tuple=True)
            rows_l.append(r + r0)
            cols_l.append(c[r, k].long() + o)
            vals_l.append(v[r, k])
            r0 += c.shape[0]
        cols_all = torch.cat(cols_l)
        ell_csr = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows_l), cols_all]), torch.cat(vals_l),
            (plan.n_ell_rows, n_cols), check_invariants=False).coalesce().to_sparse_csr()
        kernels.bucket_spmm_plan(plan, x, work, out=cat)
        bucket_lib_err = rel_err(torch.sparse.mm(ell_csr, x), cat)
        bucket_lib_ms = time_cuda(lambda: torch.sparse.mm(ell_csr, x), iters=20)
        bucket_bytes = (sum(c.numel() * 8 for c, _, _ in buckets)  # cols + vals
                        + int(torch.unique(cols_all).numel()) * d * 4  # X rows read once
                        + plan.n_ell_rows * d * 4)  # partial rows written once
        bucket_ops = 2 * int(cols_all.numel()) * d

        kernels.bucket_spmm_plan(plan, x, work, out=cat)
        fin = plan.finish
        gidx = [fin.pos] + ([fin.extra_idx] if fin.extra_idx.shape[0] else [])
        kernels.reset_launch_counts()
        for i in gidx:
            kernels.gather_rows(cat, i)
        gather_launches = kernels.LAUNCHES["gather_rows"]
        gather_ms = time_cuda(lambda: [kernels.gather_rows(cat, i) for i in gidx], iters=20)
        gather_plain_ms = time_cuda(lambda: [kernels.gather_rows_torch(cat, i) for i in gidx],
                                    iters=20)
        clamped = [i.clamp(0, plan.n_ell_rows - 1) for i in gidx]
        gather_lib_ms = time_cuda(lambda: [torch.index_select(cat, 0, i) for i in clamped],
                                  iters=20)
        m_rows = sum(int(i.numel()) for i in gidx)
        in_range = torch.cat([i[(i >= 0) & (i < plan.n_ell_rows)] for i in gidx])
        gather_bytes = (m_rows * 4 + int(torch.unique(in_range).numel()) * d * 4
                        + m_rows * d * 4)
    b_bound, b_by = _bound(bucket_bytes, bucket_ops, peak_bw, peak_fp32)
    g_bound, g_by = _bound(gather_bytes, 0, peak_bw, peak_fp32)
    return {
        "d": d, "scope": "all launches of one SpMM",
        "bucket_spmm": {"launches": bucket_launches, "ms": bucket_ms, "plain_ms": bucket_plain_ms,
                        "library": "torch.sparse.mm", "library_ms": bucket_lib_ms,
                        "library_rel_err": bucket_lib_err, "bytes": bucket_bytes,
                        "flops": bucket_ops, "bound_ms": b_bound, "bound_by": b_by},
        "gather_rows": {"launches": gather_launches, "ms": gather_ms, "plain_ms": gather_plain_ms,
                        "library": "torch.index_select", "library_ms": gather_lib_ms,
                        "bytes": gather_bytes, "bound_ms": g_bound, "bound_by": g_by},
    }


def bucket_check(plan, work, x: torch.Tensor, what: str) -> float:
    """The one-launch bucket kernel on a plan against its plain version
    bucket by bucket; returns max |k - p|."""
    got = kernels.bucket_spmm_plan(plan, x, work)
    want = torch.cat([kernels.bucket_spmm_torch(c, v, x, o)
                      for c, v, o in kernels.plan_buckets(plan)])
    torch.cuda.synchronize()
    return check_close(got, want, what)


def bucket_cases(rng):
    """Placed plans beside the arxiv plan that cover what the one-launch
    bucket kernel meets: a relabeled binned plan with rows split across
    ELL rows, and a small tiered plan with several tiers, a cold tier and
    rows split across tiers (finish.extra_rids non-empty). Yields (name,
    operator); raises if a plan lacks what it is here for."""
    n = 3000
    dense = (rng.random((n, n)) < 0.004) * rng.standard_normal((n, n))
    dense[[5, 700]] = rng.standard_normal((2, n))  # rows wider than the widest bucket
    op = make_operator(CSR.from_dense(dense.astype(np.float32)), layout="binned")
    if not (op.relabeled and op.binned.has_split_rows):
        raise AssertionError("binned case is not relabeled or has no split rows")
    yield "binned (relabeled, split rows)", op
    dense = (rng.random((2000, 5000)) < 0.01) * rng.standard_normal((2000, 5000))
    dense[[3, 1500]] = rng.standard_normal((2, 5000))
    op = make_operator(CSR.from_dense(dense.astype(np.float32)), layout="tiered",
                       tier_size=1024)
    plan = op.binned
    if not (len(plan.tiers) > 2 and plan.finish.extra_rids.shape[0]):
        raise AssertionError("tiered case has too few tiers or no rows split across tiers")
    yield "tiered (several tiers, rows split across tiers)", op


def bucket_cap_sweep(plan, x: torch.Tensor, want: torch.Tensor) -> list:
    """bucket_spmm over a plan with its work list cut at each of
    BUCKET_CAPS: units, time, and the error against the plain version
    ``want`` (the launches here are outside every main-path count)."""
    rows = []
    with torch.inference_mode():
        for cap in BUCKET_CAPS:
            w = kernels.bucket_work(plan, cap)
            err = check_close(kernels.bucket_spmm_plan(plan, x, w), want,
                              f"bucket_spmm at cap {cap}")
            rows.append({"cap": cap, "units": int(w.units.shape[0]),
                         "ms": time_cuda(lambda: kernels.bucket_spmm_plan(plan, x, w), iters=20),
                         "max_abs_err": err})
    return rows


def bucket_load(plan, work) -> dict:
    """How the bucket kernel's work falls on its blocks and warps: units,
    the heaviest unit's slots, and the slots of one row the busiest warp
    walks in sequence (a chunk of 32), beside the first design's (one
    warp a row: the widest bucket's width) and its launches (one per
    bucket)."""
    widths = np.array([c.shape[1] for c, _, _ in kernels.plan_buckets(plan)])
    units = work.units.cpu().numpy().astype(np.int64)
    slots = units[:, 2] * widths[units[:, 0]]
    return {"buckets": int(widths.shape[0]), "units": int(units.shape[0]),
            "cap": kernels.BUCKET_UNIT_SLOTS,
            "unit_slots_max": int(slots.max()) if slots.size else 0,
            "unit_slots_min": int(slots.min()) if slots.size else 0,
            "row_slots_per_warp_max": int(min(32, widths.max())) if widths.size else 0,
            "first_design_row_slots_per_warp_max": int(widths.max()) if widths.size else 0,
            "first_design_launches": int(widths.shape[0])}


def expect_device_assert(code: str, what: str) -> None:
    """Run ``code`` in a child process; it must stop with a device-side
    assertion (which leaves the child's CUDA context unusable)."""
    probe = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    if probe.returncode == 0 or "device-side assert" not in probe.stdout + probe.stderr:
        raise AssertionError(f"{what} did not stop with a device-side assertion "
                             f"(rc {probe.returncode}):\n"
                             f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")


def expect_device_asserts(probes: list) -> None:
    """expect_device_assert for each (code, what) of ``probes``, the child
    processes run at once."""
    with ThreadPoolExecutor(len(probes)) as pool:
        for f in [pool.submit(expect_device_assert, code, what) for code, what in probes]:
            f.result()


def rank1_graph(n: int, m: int, rng, per_row: float = 0.0, band: int = 0,
                hubs: int = 0) -> CSR:
    """A seeded pattern (random entries, a band of ``band`` entries per row
    around the diagonal, ``hubs`` columns each row meets with probability
    0.6) with symmetric-normalized, hence rank-1, values."""
    rows, cols = [], []
    if per_row:
        k = rng.poisson(per_row, n)
        rows.append(np.repeat(np.arange(n), k))
        cols.append(rng.integers(0, m, int(k.sum())))
    if band:
        r = np.repeat(np.arange(n), band)
        rows.append(r)
        cols.append(np.clip(r * m // n - 64 + rng.integers(0, 128, r.shape[0]), 0, m - 1))
    if hubs:
        hub = rng.choice(m, hubs, replace=False)
        r, h = np.nonzero(rng.random((n, hubs)) < 0.6)
        rows.append(r)
        cols.append(hub[h])
    key = np.unique(np.concatenate(rows).astype(np.int64) * m
                    + np.concatenate(cols).astype(np.int64))
    r, c = key // m, key % m
    dr = np.bincount(r, minlength=n).astype(np.float64)
    dc = np.bincount(c, minlength=m).astype(np.float64)
    vals = (dr[r] ** -0.5 * dc[c] ** -0.5).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(r.astype(np.int32), c.astype(np.int32), vals, (n, m)))


def panel_cases(rng):
    """Placed panel plans that cover, between them, every shape the kernel
    meets: hot rows, several ranges (one at the clamped top end of X),
    several segments, direct rows, tiles split into scattered pieces, big
    (SCQ) scattered chunks, hub-heavy tiles cut into several work units
    (added with atomics), and the per-edge mode. Yields (name, plan);
    raises if a plan lacks what it is here for."""
    dev = torch.device("cuda", 0)

    def placed(csr, **kw):
        plan = build_panels_plan(csr, **kw)
        return place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=csr.shape),
                              dev).binned

    m = 6000
    plan = placed(rank1_graph(6000, m, rng, per_row=3, band=24, hubs=40), T=512,
                  hot_budget=512, hot_min_run=2, range_cap=1024, seg_steps=24, direct_quota=8)
    top = (m - plan.RC) // 128 * 128
    if not (plan.n_hot and plan.n_ranges > 2 and len(plan.segments) > 1 and plan.n_direct
            and any(bool((s.rcopy[:, 0, :] == top).any()) for s in plan.segments)):
        raise AssertionError("hot/ranges/segments/direct case lacks a feature")
    yield "hot+ranges(top end)+segments+direct", plan
    plan = placed(rank1_graph(512, 4096, rng, per_row=300), T=256, hot_budget=0,
                  range_cap=256, s_cap=256)
    first_steps = sum(int(((s.ctrl[:, 0, C_TILE] >= 0) & (s.ctrl[:, 0, C_TFIRST] == 1)).sum())
                      for s in plan.segments)
    if first_steps <= sum(s.n_tiles for s in plan.segments):
        raise AssertionError("pieces case has no tile split into pieces")
    yield "scattered pieces", plan
    plan = placed(rank1_graph(512, 32768, rng, per_row=600), T=256, hot_budget=0,
                  range_cap=256, s_cap=8192)
    if not any(bool((s.ctrl[:, 0, C_SBIG] > 0).any()) for s in plan.segments):
        raise AssertionError("big-chunk case stages no SCQ chunk")
    yield "big scattered chunks", plan
    plan = placed(rank1_graph(2000, 6000, rng, per_row=3, band=8, hubs=200))
    if not any(int(s.windows.split_tiles.shape[0]) for s in plan.segments):
        raise AssertionError("hub case cuts no tile into several work units")
    yield "hub tiles cut into work units", plan
    n, mm, nnz = 3000, 4000, 60_000
    coo = COO.from_arrays(rng.integers(0, n, nnz).astype(np.int32),
                          rng.integers(0, mm, nnz).astype(np.int32),
                          rng.standard_normal(nnz).astype(np.float32), (n, mm))
    plan = make_operator(CSR.from_coo(coo), layout="panels").binned  # the per-edge fallback
    if not plan.per_edge:
        raise AssertionError("random-valued matrix did not plan per edge")
    yield "per-edge values", plan


def panel_figures(plan: PanelPlan, sp: torch.Tensor, x_rows: int, nnz: int, d: int, gen,
                  peak_bw: float, peak_fp32: float) -> dict:
    """panel_spmm over one SpMM (all its launches) at width d: its time,
    its plain version's, torch.sparse.mm on the CSR of the same matrix
    (``sp``), and the bound of that work (utils/roofline.py PanelTraffic).
    ``launches`` is counted over one such SpMM."""
    dev = torch.device("cuda", 0)
    x = torch.randn((plan.shape[1], d), generator=gen).to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        y = pkernels.panel_spmm(plan, x)
        launches = kernels.LAUNCHES["panel_spmm"]
        lib_err = rel_err(torch.sparse.mm(sp, x), y)
        ms = time_cuda(lambda: pkernels.panel_spmm(plan, x), iters=20)
        plain_ms = time_cuda(lambda: pkernels.panel_spmm_torch(plan, x), iters=3)
        lib_ms = time_cuda(lambda: torch.sparse.mm(sp, x), iters=20)
    traffic = PanelTraffic.from_plan(plan, d, x_rows, nnz)
    bound, by = _bound(traffic.bytes, traffic.flops, peak_bw, peak_fp32)
    return {"d": d, "scope": "all launches of one SpMM", "launches": launches,
            "ms": ms, "plain_ms": plain_ms, "library": "torch.sparse.mm", "library_ms": lib_ms,
            "library_rel_err": lib_err, "bytes": traffic.bytes, "flops": traffic.flops,
            "bound_ms": bound, "bound_by": by}


def unit_warp_edges(slot_edges: np.ndarray) -> int:
    """Edges the busiest warp of a panel block walks over one work unit
    whose slots hold ``slot_edges`` mask bits (or selections, for a fused
    or ranges block): per batch of PANEL_BATCH slots the batch's edges are
    listed PANEL_LIST at a time and dealt to the 16 warps in chunks of
    PANEL_CHUNK, round robin, so warp 0 has the most (csrc/panels.cu,
    csrc/staged_spmm.cuh)."""
    total = 0
    for b0 in range(0, slot_edges.shape[0], PANEL_BATCH):
        n = int(slot_edges[b0:b0 + PANEL_BATCH].sum())
        for r0 in range(0, n, PANEL_LIST):
            k = min(PANEL_LIST, n - r0)
            starts = np.arange(0, k, 16 * PANEL_CHUNK)
            total += int(np.minimum(PANEL_CHUNK, k - starts).sum())
    return total


def tile_load(plan: PanelPlan) -> dict:
    """How the panel kernel's work falls on its blocks and warps, counted
    on the host from a compact plan's edges: edges (mask bits) per
    128-row output tile and per row; the work list (sparse/panels.py
    work_units at the edge cap E): units (one block each), the heaviest
    unit, the tiles cut into several units, and the edges of the busiest
    warp of any block; and, for the first design (one block per tile,
    8 fixed rows per warp), that design's busiest warp."""
    G = plan.T // 128
    E = UNIT_EDGES
    rows, tile0 = [], 0
    n_units = split = unit_max = warp_max = 0
    for seg in plan.segments:
        slot = np.repeat(np.arange(seg.mask_counts.shape[0]), seg.mask_counts.astype(np.int64))
        tile = tile0 + seg.ctrl[slot // G, 0, C_TILE].astype(np.int64)
        rows.append(tile * 128 + (seg.mask_edges.astype(np.int64) & 255))
        tile0 += seg.n_tiles
        slots, units, split_tiles = work_units(seg.ctrl[:, 0, C_TILE], seg.mask_counts, G,
                                               seg.n_tiles, E)
        edges = seg.mask_counts.astype(np.int64)[slots]
        n_units += units.shape[0]
        split += split_tiles.shape[0]
        for _tile, a, b in units:
            unit_max = max(unit_max, int(edges[a:b].sum()))
            warp_max = max(warp_max, unit_warp_edges(edges[a:b]))
    per_row = np.bincount(np.concatenate(rows), minlength=tile0 * 128)
    per_tile = per_row.reshape(tile0, 128).sum(1)
    per_warp = per_row.reshape(tile0, 16, 8).sum(2)
    return {"tiles": tile0, "tile_edges_mean": float(per_tile.mean()),
            "tile_edges_p99": float(np.percentile(per_tile, 99)),
            "tile_edges_max": int(per_tile.max()), "heaviest_tile": int(per_tile.argmax()),
            "row_edges_max": int(per_row.max()), "E": E, "units": n_units,
            "unit_edges_max": unit_max, "split_tiles": split, "warp_edges_max": warp_max,
            "fixed_rows_warp_edges_max": int(per_warp.max())}


def with_unit_cap(plan: PanelPlan, cap: int) -> PanelPlan:
    """The placed panel plan with its work list cut again at edge cap
    ``cap`` (sparse/panels.py work_units; each slot's edges counted from
    its masks on the card)."""
    segs = []
    for seg in plan.segments:
        counts = sum(((seg.masks >> b) & 1).sum((1, 2)) for b in range(32))
        slots, units, split = work_units(seg.ctrl[:, 0, C_TILE].cpu().numpy(),
                                         counts.cpu().numpy(), plan.T // 128, seg.n_tiles, cap)
        dev = seg.masks.device
        win = dataclasses.replace(seg.windows, unit_slots=torch.from_numpy(slots).to(dev),
                                  units=torch.from_numpy(units).to(dev),
                                  split_tiles=torch.from_numpy(split).to(dev))
        segs.append(dataclasses.replace(seg, windows=win))
    return dataclasses.replace(plan, segments=tuple(segs))


def unit_cap_sweep(plan: PanelPlan, x: torch.Tensor, want: torch.Tensor) -> list:
    """panel_spmm with the work list cut at each of UNIT_CAPS: units,
    split tiles, time, and the error against the plain version ``want``
    (the launches here are outside every main-path count)."""
    rows = []
    with torch.inference_mode():
        for cap in UNIT_CAPS:
            p = with_unit_cap(plan, cap)
            err = check_close(pkernels.panel_spmm(p, x), want, f"panel_spmm at E={cap}")
            rows.append({"E": cap,
                         "units": sum(int(s.windows.units.shape[0]) for s in p.segments),
                         "split_tiles": sum(int(s.windows.split_tiles.shape[0])
                                            for s in p.segments),
                         "ms": time_cuda(lambda: pkernels.panel_spmm(p, x), iters=20),
                         "max_abs_err": err})
    return rows


def torch_csr(csr: CSR, dev) -> torch.Tensor:
    """The CSR as a torch sparse CSR tensor on ``dev`` (for torch.sparse.mm,
    the library yardstick; the port never calls it)."""
    return torch.sparse_csr_tensor(torch.from_numpy(csr.indptr.astype(np.int64)),
                                   torch.from_numpy(csr.cols.astype(np.int64)),
                                   torch.from_numpy(csr.vals), csr.shape,
                                   check_invariants=False).to(dev)


def staged_cases(engine: str, rng):
    """Placed fused or ranges plans that cover, between them, what the
    arxiv plan does not: one-hot lanes with general values, duplicate
    edges, several segments, virtual tiles from a small s_cap; for fused
    rows staging, window mode (split window blocks) and 256-row tiles (two
    row passes per unit), for ranges scattered overflow pieces and ranges
    at the clamped top end of X (one wider than x itself, which reads the
    TPU wrapper's zero padding); for both a hub-heavy plan whose work list
    is cut at a small selection cap, so that most tiles are split into
    several units. Yields (name, plan); raises if a plan lacks what it is
    here for."""
    dev = torch.device("cuda", 0)
    build = build_fused_plan if engine == "fused" else build_ranges_plan

    def placed(csr, **kw):
        plan = build(csr, **kw)
        return place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=csr.shape),
                              dev).binned

    def n_virtual(plan):
        return sum(int(((s.ctrl[:, 0, 0] >= 0) & (s.ctrl[:, 0, 1] == 1)).sum())
                   for s in plan.segments) - sum(s.n_tiles for s in plan.segments)

    def n_split(plan):
        return sum(int(s.windows.split_tiles.shape[0]) for s in plan.segments)

    n, nnz = 3000, 60_000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    rows, cols = np.concatenate([rows, rows[:5000]]), np.concatenate([cols, cols[:5000]])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    general = CSR.from_coo(COO.from_arrays(rows, cols, vals, (n, n)))  # duplicates summed
    if engine == "fused":
        plan = placed(general, T=512, hot_budget=256, hot_min_run=1, seg_steps=24)
        if plan.multihot or len(plan.segments) < 2:
            raise AssertionError("general case is multi-hot or has one segment")
        yield "general values+duplicates+segments", plan
        plan = placed(rank1_graph(4000, 4000, rng, per_row=6, hubs=40), T=256,
                      hot_budget=256, hot_min_run=2, staging="rows", s_cap=256)
        if not plan.multihot or plan.staging != "rows" or not n_virtual(plan):
            raise AssertionError("rows case lacks multi-hot lanes or virtual tiles")
        yield "rows staging+virtual tiles", plan
        plan = placed(rank1_graph(4096, 4096, rng, per_row=4, band=16, hubs=24), R=256, T=512,
                      hot_budget=128, hot_min_run=1, stage_tier=256, s_cap=512, window=True,
                      seg_steps=40)
        if not (plan.window and n_virtual(plan) and len(plan.segments) > 1 and n_split(plan)):
            raise AssertionError("window case lacks virtual tiles, segments or split blocks")
        yield "window mode+virtual tiles+segments", plan
        plan = with_selection_cap(placed(rank1_graph(3000, 3000, rng, per_row=4, band=16,
                                                     hubs=32), R=256, T=512, hot_budget=256,
                                         hot_min_run=1), 256)
        if not (plan.R > 128 and not plan.window and n_split(plan) > 4):
            raise AssertionError("split case lacks 256-row tiles or split tiles")
        yield "split units (E=256)+256-row tiles", plan
        return
    m = 6000
    plan = placed(rank1_graph(6000, m, rng, per_row=3, band=24, hubs=40), T=512,
                  hot_budget=512, hot_min_run=2, range_cap=1024, seg_steps=24)
    top = (m - plan.RC) // 128 * 128
    if not (plan.n_hot and plan.n_ranges > 2 and len(plan.segments) > 1
            and any(bool((s.rcopy[:, 0, :] == top).any()) for s in plan.segments)):
        raise AssertionError("hot/ranges/segments case lacks a feature")
    yield "hot+ranges(top end)+segments", plan
    plan = placed(rank1_graph(512, 4096, rng, per_row=300), T=256, hot_budget=0,
                  range_cap=256, s_cap=256)
    if not n_virtual(plan):
        raise AssertionError("pieces case has no tile split into pieces")
    yield "scattered pieces", plan
    plan = placed(general, T=256, hot_budget=0, range_cap=1024, seg_steps=40)
    if plan.multihot or len(plan.segments) < 2:
        raise AssertionError("general case is multi-hot or has one segment")
    yield "general values+duplicates+segments", plan
    plan = placed(rank1_graph(700, 100, rng, per_row=5), T=256)
    if not plan.RC > plan.shape[1]:
        raise AssertionError("narrow case has no range past the end of x")
    yield "range wider than x", plan
    plan = with_selection_cap(placed(rank1_graph(4000, 4000, rng, per_row=4, band=16, hubs=32),
                                     T=512, hot_budget=256, hot_min_run=2, range_cap=1024), 256)
    if n_split(plan) <= 4:
        raise AssertionError("split case has too few split tiles")
    yield "split units (E=256)", plan


def staged_figures(engine: str, plan, sp: torch.Tensor, x_rows: int, nnz: int, d: int, gen,
                   peak_bw: float, peak_fp32: float) -> dict:
    """The fused or ranges kernel over one SpMM (all its launches) at width
    d: its time, its plain version's, torch.sparse.mm on the CSR of the
    same matrix (``sp``), and the bound of that work (utils/roofline.py
    StagedTraffic). ``launches`` is counted over one such SpMM."""
    kmod = STAGED[engine][0]
    kernel, plain = getattr(kmod, f"{engine}_spmm"), getattr(kmod, f"{engine}_spmm_torch")
    name = f"{engine}_spmm"
    dev = torch.device("cuda", 0)
    x = torch.randn((plan.shape[1], d), generator=gen).to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        y = kernel(plan, x)
        launches = kernels.LAUNCHES[name]
        lib_err = rel_err(torch.sparse.mm(sp, x), y)
        ms = time_cuda(lambda: kernel(plan, x), iters=20)
        plain_ms = time_cuda(lambda: plain(plan, x), iters=3)
        lib_ms = time_cuda(lambda: torch.sparse.mm(sp, x), iters=20)
    traffic = StagedTraffic.from_plan(plan, d, x_rows, nnz)
    bound, by = _bound(traffic.bytes, traffic.flops, peak_bw, peak_fp32)
    return {"d": d, "scope": "all launches of one SpMM", "launches": launches,
            "ms": ms, "plain_ms": plain_ms, "library": "torch.sparse.mm", "library_ms": lib_ms,
            "library_rel_err": lib_err, "bytes": traffic.bytes, "flops": traffic.flops,
            "real_slots": traffic.real_slots, "bound_ms": bound, "bound_by": by}


def selection_load(plan) -> dict:
    """How the fused or ranges kernel's work falls on its blocks and warps,
    counted on the host from the plan's real lanes: window row selections
    per lane group slot and per control step; the work list
    (sparse/staged_windows.py, cut at sparse/panels.py UNIT_EDGES): units
    (one block each, per column slab), the heaviest unit, the split keys,
    the selections of the busiest warp of any block; and, for the first
    design (one block per slot, each warp walking its 32 lanes alone),
    that design's busiest warp and the lanes it added into Y with atomics
    (real lanes per output row)."""
    G = plan.T // 128
    sent = staged_windows.geometry(plan)[4]
    per_slot, warp_first, lanes = [], 0, 0
    n_units = split = unit_max = warp_max = 0
    for seg in plan.segments:
        lrow = seg.lrow.cpu().numpy()
        real = lrow < sent
        if plan.multihot:
            lane_sel = (np.bitwise_count(seg.lidx.cpu().numpy().view(np.uint32)).sum(1)
                        * real).astype(np.int64)
        else:
            lane_sel = real.astype(np.int64)
        lanes += int((lane_sel > 0).sum())
        warp_first = max(warp_first, int(lane_sel.reshape(-1, 4, 32).sum(2).max()))
        n = lane_sel.sum(1)
        per_slot.append(n)
        win = seg.windows
        units = win.units.cpu().numpy()
        sel = n[win.unit_slots.cpu().numpy()]
        n_units += units.shape[0]
        split += int(win.split_tiles.shape[0])
        for _key, a, b in units:
            unit_max = max(unit_max, int(sel[a:b].sum()))
            warp_max = max(warp_max, unit_warp_edges(sel[a:b]))
    per_slot = np.concatenate(per_slot).astype(np.int64)
    per_step = per_slot.reshape(-1, G).sum(1)
    live = per_slot > 0
    return {"selections": int(per_slot.sum()), "real_slots": int(live.sum()),
            "slot_selections_mean": float(per_slot[live].mean()),
            "slot_selections_p99": float(np.percentile(per_slot[live], 99)),
            "slot_selections_max": int(per_slot.max()),
            "step_selections_mean": float(per_step[per_step > 0].mean()),
            "step_selections_p99": float(np.percentile(per_step[per_step > 0], 99)),
            "step_selections_max": int(per_step.max()),
            "E": UNIT_EDGES, "units": n_units, "unit_selections_max": unit_max,
            "split_tiles": split, "warp_selections_max": warp_max,
            "first_design_warp_selections_max": warp_first,
            "first_design_atomic_rows_per_output_row": lanes / plan.shape[0]}


def with_selection_cap(plan, cap: int, counts=None):
    """The placed fused or ranges plan with its work list cut again at
    selection cap ``cap`` (sparse/staged_windows.py unit_keys,
    sparse/panels.py work_units); ``counts`` are the segments' per-slot
    selections (staged_windows.slot_selections) when known."""
    segs = []
    for i, seg in enumerate(plan.segments):
        key, n_keys = staged_windows.unit_keys(plan, seg)
        n = staged_windows.slot_selections(plan, seg) if counts is None else counts[i]
        slots, units, split = work_units(key, n, plan.T // 128, n_keys, cap)
        dev = seg.lidx.device
        win = dataclasses.replace(seg.windows, unit_slots=torch.from_numpy(slots).to(dev),
                                  units=torch.from_numpy(units).to(dev),
                                  split_tiles=torch.from_numpy(split).to(dev))
        segs.append(dataclasses.replace(seg, windows=win))
    return dataclasses.replace(plan, segments=tuple(segs))


def selection_cap_sweep(engine: str, plan, x: torch.Tensor, want: torch.Tensor) -> list:
    """The fused or ranges kernel with the work list cut at each of
    STAGED_CAPS: units, split keys, time, and the error against the plain
    version ``want`` (the launches here are outside every main-path
    count)."""
    kernel = getattr(STAGED[engine][0], f"{engine}_spmm")
    counts = [staged_windows.slot_selections(plan, s) for s in plan.segments]
    rows = []
    with torch.inference_mode():
        for cap in STAGED_CAPS:
            p = with_selection_cap(plan, cap, counts)
            err = check_close(kernel(p, x), want, f"{engine}_spmm at E={cap}")
            rows.append({"E": cap,
                         "units": sum(int(s.windows.units.shape[0]) for s in p.segments),
                         "split_tiles": sum(int(s.windows.split_tiles.shape[0])
                                            for s in p.segments),
                         "ms": time_cuda(lambda: kernel(p, x), iters=20),
                         "max_abs_err": err})
    return rows


def plan_shape(plan) -> dict:
    """The shape of a fused or ranges plan, for the phase lines."""
    out = {"T": plan.T, "R": plan.R, "hot_rows": plan.n_hot, "multihot": plan.multihot,
           "segments": len(plan.segments), "steps": sum(s.n_steps for s in plan.segments),
           "S_buf": plan.S_buf, "lanes": plan.n_lanes}
    if isinstance(plan, RangesPlan):
        out.update(RC=plan.RC, ranges=plan.n_ranges, scattered_rows=plan.n_scattered)
    else:
        out.update(staging=plan.staging, staged_rows=plan.n_staged)
    return out


def staged_main_path(engine: str, a_hat: CSR, cfg, x: torch.Tensor, model: GCN,
                     tiered_logits: torch.Tensor, gen, peak_bw: float, peak_fp32: float):
    """GCN inference on arxiv through layout=engine: the plan, the window
    replay and the placement timed apart, then the user's entry point
    drives it; logits against impl="torch" and the tiered CUDA logits;
    the kernel at the main path's widths against its plain version.
    Returns (launches of one forward, max abs err, the phase's fields,
    the kernel's figures at d = 128)."""
    dev = torch.device("cuda", 0)
    kmod, plan_type = STAGED[engine]
    name = f"{engine}_spmm"
    t0 = time.perf_counter()
    plan = (build_fused_plan if engine == "fused" else build_ranges_plan)(a_hat)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged_windows.attach_windows(plan)
    t_win = time.perf_counter() - t0
    t0 = time.perf_counter()
    place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=a_hat.shape), dev)
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    del plan
    t0 = time.perf_counter()
    op = make_operator(a_hat, layout=engine)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    sp = op.binned
    if not isinstance(sp, plan_type) or not op.transpose_aliased or not sp.multihot:
        raise AssertionError(f"ogbn-arxiv should plan as an aliased rank-1 {engine} operator")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        logits = model(op, x)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in launches}
        expected[name] = 3 * len(sp.segments)
        if launches != expected:
            raise AssertionError(f"{engine} main path launches {launches}, expected {expected}")
        want = model(op, x, impl="torch")
        torch.cuda.synchronize()
    if logits.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(logits).all():
        raise AssertionError(f"{engine} logits {tuple(logits.shape)} not finite or wrong shape")
    vs_plain, vs_tiered = rel_err(logits, want), rel_err(logits, tiered_logits)
    if vs_plain > MAIN_PATH_REL_TOL or vs_tiered > MAIN_PATH_REL_TOL:
        raise AssertionError(f"{engine} GCN logits: rel err {vs_plain} vs impl=torch, "
                             f"{vs_tiered} vs the tiered CUDA path")
    err = 0.0
    with torch.inference_mode():
        for d in sorted(set(GCN_DIMS[:-1])):
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            err = max(err, check_close(getattr(kmod, name)(sp, xd),
                                       getattr(kmod, f"{name}_torch")(sp, xd),
                                       f"arxiv {name} d={d}"))
        torch.cuda.synchronize()
        fwd_ms = time_cuda(lambda: model(op, x), iters=20)
        fwd_wall_ms = wall_ms(lambda: model(op, x), iters=20)
        spmm_rows = []
        for layer, d in enumerate(GCN_DIMS[:-1]):
            h = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            ms = time_cuda(lambda: spmm_internal(op, h), iters=20)
            rep = spmm_report(ms, SpmmTraffic(a_hat.nnz, cfg.n_nodes, cfg.n_nodes, d), peak_bw)
            spmm_rows.append({"layer": layer, "d": d, **{k: round(v, 4) for k, v in rep.items()}})
    fig = staged_figures(engine, sp, torch_csr(a_hat, dev), int(np.unique(a_hat.cols).size),
                         a_hat.nnz, 128, gen, peak_bw, peak_fp32)
    h = torch.randn((cfg.n_nodes, 128), generator=gen).to(dev)
    with torch.inference_mode():
        h_want = getattr(kmod, f"{name}_torch")(sp, h)
        # the kernel's time at each tested width: what does not scale with
        # d (the work list, the window rows' resolve, the barriers) shows
        # at d = 7
        fig["ms_by_width"] = {}
        for d in STAGED_WIDTHS:
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            fig["ms_by_width"][d] = time_cuda(lambda: getattr(kmod, name)(sp, xd), iters=20)
    fig["selection_cap_sweep"] = selection_cap_sweep(engine, sp, h, h_want)
    fields = dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", n_nodes=cfg.n_nodes,
                  nnz=a_hat.nnz, dims=GCN_DIMS, layout=engine, **plan_shape(sp),
                  selection_load=selection_load(sp),
                  plan_seconds=round(t_plan, 4), windows_seconds=round(t_win, 4),
                  placement_seconds=round(t_place, 4), make_operator_seconds=round(t_op, 4),
                  launches_per_forward=launches, logits_rel_err_vs_torch=vs_plain,
                  logits_rel_err_vs_tiered=vs_tiered, forward_ms=round(fwd_ms, 4),
                  forward_wall_ms=round(fwd_wall_ms, 4), spmm=spmm_rows)
    return launches, err, fields, fig


def staged_scale(engine: str, pa: CSR, px: torch.Tensor, p_sparse: torch.Tensor, gen,
                 peak_bw: float, peak_fp32: float) -> dict:
    """One SpMM at d = 128 on products-small through layout=engine, against
    impl="torch" and torch.sparse.mm, with the kernel's figures."""
    t0 = time.perf_counter()
    op = make_operator(pa, layout=engine)
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    plan = op.binned
    if len(plan.segments) < 2:
        raise AssertionError(f"products-small should plan {engine} in several segments")
    with torch.inference_mode():
        y = spmm_internal(op, px)
        y_plain = spmm_internal(op, px, impl="torch")
        y_lib = torch.sparse.mm(p_sparse, px)
        torch.cuda.synchronize()
    err, lib_err = rel_err(y, y_plain), rel_err(y, y_lib)
    if err > MAIN_PATH_REL_TOL or lib_err > MAIN_PATH_REL_TOL or not torch.isfinite(y).all():
        raise AssertionError(f"products-small {engine} SpMM: rel err {err} vs impl=torch, "
                             f"{lib_err} vs torch.sparse.mm")
    fig = staged_figures(engine, plan, p_sparse, int(np.unique(pa.cols).size), pa.nnz, 128,
                         gen, peak_bw, peak_fp32)
    return dict(graph="products-small (synthetic, symmetrized, self-loops)",
                n_nodes=pa.shape[0], nnz=pa.nnz, layout=engine, **plan_shape(plan),
                selection_load=selection_load(plan),
                make_operator_seconds=round(t_op, 2), rel_err_vs_torch=err,
                rel_err_vs_torch_sparse_mm=lib_err, **fig,
                selection_cap_sweep=selection_cap_sweep(engine, plan, px, y_plain))


def random_csr(n: int, m: int, nnz: int, rng, rank1: bool, empty=None) -> CSR:
    """A seeded random matrix: standard-normal values with duplicate
    entries (summed), or symmetric-normalized (rank-1) values; rows in the
    slice ``empty`` hold nothing."""
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, m, nnz)
    if empty is not None:
        keep = (rows < empty.start) | (rows >= empty.stop)
        rows, cols = rows[keep], cols[keep]
    if rank1:
        key = np.unique(rows * m + cols)
        rows, cols = key // m, key % m
        dr = np.bincount(rows, minlength=n).astype(np.float64)
        dc = np.bincount(cols, minlength=m).astype(np.float64)
        vals = (dr[rows] ** -0.5 * dc[cols] ** -0.5).astype(np.float32)
    else:
        dup = rows.shape[0] // 10
        rows, cols = np.concatenate([rows, rows[:dup]]), np.concatenate([cols, cols[:dup]])
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows.astype(np.int32), cols.astype(np.int32), vals,
                                        (n, m)))


def expansion_shape(plan) -> dict:
    """The shape of an expansion plan (either engine), for the phase lines."""
    lanes = plan.n_steps * (plan.TILE if isinstance(plan, ExpansionPlan) else plan.G * 128)
    out = {"R": plan.R, "groups": len(plan.groups), "steps": plan.n_steps, "lanes": lanes,
           "staged_rows": plan.n_staged,
           "tiers": max(len(g.stage_tier_ptr) - 1 for g in plan.groups)}
    if isinstance(plan, ExpansionPlan):
        out.update(TILE=plan.TILE, CW=plan.CW)
    else:
        out.update(G=plan.G, rank1=plan.rank1)
    return out


def expansion_cases(rng):
    """Placed plans of both expansion engines that cover, between them,
    what the arxiv plans do not: several groups (small stage_budget),
    several tiers (small stage_tier), general values with duplicates
    (v1 always; v2 general mode), empty tiles, non-square matrices.
    Yields (kernel name, case, plan); raises if a plan lacks what it is
    here for."""
    dev = torch.device("cuda", 0)
    general = random_csr(3000, 4000, 60_000, rng, rank1=False)
    empty = random_csr(2000, 6000, 40_000, rng, rank1=True, empty=slice(512, 1024))
    hubs = rank1_graph(6000, 6000, rng, per_row=3, band=24, hubs=40)

    def tiers(plan):
        return max(len(g.stage_tier_ptr) - 1 for g in plan.groups)

    plan = build_expansion_plan(general, R=128, TILE=256, CW=256, stage_tier=512,
                                stage_budget=2048)
    if not (len(plan.groups) > 1 and tiers(plan) > 1):
        raise AssertionError("v1 groups case has one group or one tier")
    yield "expansion_spmm", "general values+duplicates+groups+tiers", place_plan(plan, dev)
    plan = build_expansion_plan(empty)
    if 1 in plan.groups[0].tile_of.tolist() or plan.shape[0] == plan.shape[1]:
        raise AssertionError("v1 empty-tile case has a step on tile 1 or is square")
    yield "expansion_spmm", "empty tile+non-square", place_plan(plan, dev)
    yield "expansion_spmm", "hubs+band, defaults", place_plan(build_expansion_plan(hubs), dev)
    plan = build_expansion2_plan(general, R=128, G=4, stage_tier=512, stage_budget=2048)
    if plan.rank1 or not (len(plan.groups) > 1 and tiers(plan) > 1):
        raise AssertionError("v2 general case is rank-1, one group or one tier")
    yield "expansion2_spmm", "general values+duplicates+groups+tiers", place_plan(plan, dev)
    plan = build_expansion2_plan(empty, stage_tier=2048)
    if not plan.rank1 or tiers(plan) < 2:
        raise AssertionError("v2 empty-tile case is not rank-1 or has one tier")
    yield "expansion2_spmm", "rank-1+empty tile+non-square+tiers", place_plan(plan, dev)
    plan = build_expansion2_plan(hubs, rank1=False, stage_budget=4096)
    if plan.rank1 or len(plan.groups) < 2:
        raise AssertionError("v2 forced-general case is rank-1 or has one group")
    yield "expansion2_spmm", "rank1=False on rank-1 values+groups", place_plan(plan, dev)
    for kname, build in (("expansion_spmm", build_expansion_plan),
                         ("expansion2_spmm", build_expansion2_plan)):
        plan = place_plan(build(hubs), dev, max_lanes=EXPANSION_SMALL_CAP)
        if int(plan.work.split_keys.shape[0]) < 4:
            raise AssertionError(f"{kname} hub case cuts too few blocks into units")
        yield kname, f"hub blocks split into units (E={EXPANSION_SMALL_CAP})", plan


def lane_load(plan) -> dict:
    """How the expansion kernels' work falls on their blocks and warps,
    counted on the host from the placed plan: real lanes (lanes that add
    a row) per 128-lane group slot and per step (the first design ran one
    block per slot, every real lane a float4 atomic row add into a zeroed
    Y); the work list (LaneWork): units (one block each), E, the heaviest
    unit, the split output blocks, the lanes of the busiest warp (16
    warps take a unit's lanes 32 at a time, round robin), and the rows
    the kernel adds into Y with atomics (the rows of split blocks' units)
    and stores (the rest); nothing zeroes Y as a whole."""
    per_slot = []
    for g in plan.groups:
        real = g.lrow < plan.R
        if g.val_hi is not None:
            real &= (ekernels.bf16_tensor_value(g.val_hi)
                     + ekernels.bf16_tensor_value(g.val_lo)) != 0
        per_slot.append(real.sum(1).cpu().numpy())
    per_slot = np.concatenate(per_slot).astype(np.int64)
    per_step = per_slot.reshape(plan.n_steps, -1).sum(1)
    units = plan.work.units.cpu().numpy().astype(np.int64)
    size = units[:, 2] - units[:, 1]
    nwb = -(-plan.R // 128)
    key = np.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
    height = np.minimum(128, plan.R - key % nwb * 128)
    rows = np.clip(plan.n_rows - (key // nwb * plan.R + key % nwb * 128), 0, height)
    split = units[:, 0] < 0
    per_warp = EXPANSION_WARPS * EXPANSION_CHUNK
    warp_max = max((int(np.minimum(EXPANSION_CHUNK, n - np.arange(0, n, per_warp)).sum())
                    for n in size.tolist() if n), default=0)
    return {"lanes_per_step": per_slot.shape[0] // max(plan.n_steps, 1) * 128,
            "real_lanes": int(per_slot.sum()), "real_slots": int((per_slot > 0).sum()),
            "slots": int(per_slot.shape[0]),
            "step_real_lanes_mean": float(per_step.mean()),
            "step_real_lanes_min": int(per_step.min()),
            "step_real_lanes_max": int(per_step.max()),
            "E": plan.work.E, "units": int(units.shape[0]), "unit_lanes_max": int(size.max()),
            "split_keys": int(plan.work.split_keys.shape[0]), "warp_lanes_max": warp_max,
            "atomic_rows": int(rows[split].sum()), "stored_rows": int(rows[~split].sum()),
            "first_design_atomic_rows": int(per_slot.sum()), "y_zeroed_bytes": 0}


def expansion_cap_sweep(name: str, plan, x: torch.Tensor, want: torch.Tensor) -> list:
    """An expansion kernel with the plan's work list cut at each of
    EXPANSION_CAPS: units, split blocks, time, and the error against the
    plain version ``want`` (the launches here are outside every main-path
    count)."""
    kernel = EXPANSION[name][0]
    rows = []
    with torch.inference_mode():
        for cap in EXPANSION_CAPS:
            p = ekernels.with_lane_cap(plan, cap)
            err = check_close(kernel(p, x), want, f"{name} at E={cap}")
            rows.append({"E": cap, "units": int(p.work.units.shape[0]),
                         "split_keys": int(p.work.split_keys.shape[0]),
                         "ms": time_cuda(lambda: kernel(p, x), iters=20), "max_abs_err": err})
            del p
    return rows


def expansion_figures(name: str, plan, sp: torch.Tensor, d: int, gen, peak_bw: float,
                      peak_fp32: float) -> dict:
    """An expansion kernel over one SpMM (all its launches) at width d: its
    time, its plain version's, torch.sparse.mm on the CSR of the same
    matrix (``sp``), and the bound of that work (utils/roofline.py
    ExpansionTraffic). ``launches`` is counted over one such SpMM."""
    kernel, plain = EXPANSION[name]
    dev = torch.device("cuda", 0)
    x = torch.randn((plan.shape[1], d), generator=gen).to(dev)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        y = kernel(plan, x)
        launches = kernels.LAUNCHES[name]
        lib_err = rel_err(torch.sparse.mm(sp, x), y)
        ms = time_cuda(lambda: kernel(plan, x), iters=20)
        plain_ms = time_cuda(lambda: plain(plan, x), iters=3)
        lib_ms = time_cuda(lambda: torch.sparse.mm(sp, x), iters=20)
    traffic = ExpansionTraffic.from_plan(plan, d)
    bound, by = _bound(traffic.bytes, traffic.flops, peak_bw, peak_fp32)
    return {"d": d, "scope": "all launches of one SpMM", "launches": launches,
            "ms": ms, "plain_ms": plain_ms, "library": "torch.sparse.mm", "library_ms": lib_ms,
            "library_rel_err": lib_err, "bytes": traffic.bytes, "plan_bytes": traffic.plan_bytes,
            "zeroing_bytes": traffic.zero_bytes, "x_rows": traffic.x_rows,
            "flops": traffic.flops, "bound_ms": bound, "bound_by": by}


def expansion_main_path(a_hat: CSR, cfg, x: torch.Tensor, model: GCN,
                        tiered_logits: torch.Tensor, gen, peak_bw: float, peak_fp32: float):
    """GCN inference on arxiv through layout="expansion": the plan, the
    staged-row provenance and the placement timed apart, then the user's
    entry point drives it; logits against impl="torch" and the tiered
    CUDA logits; the kernel at the main path's widths against its plain
    version. Returns (launches of one forward, max abs err, the phase's
    fields, the kernel's figures at d = 128)."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    plan = build_expansion_plan(a_hat)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    attach_stage_rows(plan)
    t_attach = time.perf_counter() - t0
    t0 = time.perf_counter()
    place_plan(plan, dev)
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    del plan
    t0 = time.perf_counter()
    op = make_operator(a_hat, layout="expansion")
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    sp = op.binned
    if not isinstance(sp, ExpansionPlan) or not op.transpose_aliased:
        raise AssertionError("ogbn-arxiv should plan as an aliased expansion operator")
    with torch.inference_mode():
        kernels.reset_launch_counts()
        logits = model(op, x)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in launches}
        expected["expansion_spmm"] = 3  # one launch per SpMM
        if launches != expected:
            raise AssertionError(f"expansion main path launches {launches}, expected {expected}")
        want = model(op, x, impl="torch")
        torch.cuda.synchronize()
    if logits.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(logits).all():
        raise AssertionError(f"expansion logits {tuple(logits.shape)} not finite or wrong shape")
    vs_plain, vs_tiered = rel_err(logits, want), rel_err(logits, tiered_logits)
    if vs_plain > MAIN_PATH_REL_TOL or vs_tiered > MAIN_PATH_REL_TOL:
        raise AssertionError(f"expansion GCN logits: rel err {vs_plain} vs impl=torch, "
                             f"{vs_tiered} vs the tiered CUDA path")
    err = 0.0
    with torch.inference_mode():
        for d in sorted(set(GCN_DIMS[:-1])):
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            err = max(err, check_close(ekernels.expansion_spmm(sp, xd),
                                       ekernels.expansion_spmm_torch(sp, xd),
                                       f"arxiv expansion_spmm d={d}"))
        torch.cuda.synchronize()
        fwd_ms = time_cuda(lambda: model(op, x), iters=20)
        fwd_wall_ms = wall_ms(lambda: model(op, x), iters=20)
        spmm_rows = []
        for layer, d in enumerate(GCN_DIMS[:-1]):
            h = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            ms = time_cuda(lambda: spmm_internal(op, h), iters=20)
            rep = spmm_report(ms, SpmmTraffic(a_hat.nnz, cfg.n_nodes, cfg.n_nodes, d), peak_bw)
            spmm_rows.append({"layer": layer, "d": d, **{k: round(v, 4) for k, v in rep.items()}})
    fig = expansion_figures("expansion_spmm", sp, torch_csr(a_hat, dev), 128, gen, peak_bw,
                            peak_fp32)
    h = torch.randn((cfg.n_nodes, 128), generator=gen).to(dev)
    with torch.inference_mode():
        fig["unit_cap_sweep"] = expansion_cap_sweep(
            "expansion_spmm", sp, h, ekernels.expansion_spmm_torch(sp, h))
    del h
    mem = plan_memory_report(sp, d=256)
    fields = dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", n_nodes=cfg.n_nodes,
                  nnz=a_hat.nnz, dims=GCN_DIMS, layout="expansion", **expansion_shape(sp),
                  padding_efficiency=sp.padding_efficiency(a_hat.nnz),
                  lane_load=lane_load(sp), plan_bytes=mem["plan_bytes"],
                  stage_row_bytes=mem["stage_row_bytes"],
                  plan_seconds=round(t_plan, 4), stage_rows_seconds=round(t_attach, 4),
                  placement_seconds=round(t_place, 4), make_operator_seconds=round(t_op, 4),
                  launches_per_forward=launches, logits_rel_err_vs_torch=vs_plain,
                  logits_rel_err_vs_tiered=vs_tiered, forward_ms=round(fwd_ms, 4),
                  forward_wall_ms=round(fwd_wall_ms, 4), spmm=spmm_rows)
    return launches, err, fields, fig


def expansion_scale(pa: CSR, px: torch.Tensor, p_sparse: torch.Tensor, gen, peak_bw: float,
                    peak_fp32: float) -> dict:
    """One SpMM at d = 128 on products-small through layout="expansion",
    against impl="torch" and torch.sparse.mm, with the kernel's figures."""
    t0 = time.perf_counter()
    op = make_operator(pa, layout="expansion")
    torch.cuda.synchronize()
    t_op = time.perf_counter() - t0
    plan = op.binned
    with torch.inference_mode():
        y = spmm_internal(op, px)
        y_plain = spmm_internal(op, px, impl="torch")
        y_lib = torch.sparse.mm(p_sparse, px)
        torch.cuda.synchronize()
    err, lib_err = rel_err(y, y_plain), rel_err(y, y_lib)
    if err > MAIN_PATH_REL_TOL or lib_err > MAIN_PATH_REL_TOL or not torch.isfinite(y).all():
        raise AssertionError(f"products-small expansion SpMM: rel err {err} vs impl=torch, "
                             f"{lib_err} vs torch.sparse.mm")
    fig = expansion_figures("expansion_spmm", plan, p_sparse, 128, gen, peak_bw, peak_fp32)
    return dict(graph="products-small (synthetic, symmetrized, self-loops)",
                n_nodes=pa.shape[0], nnz=pa.nnz, layout="expansion", **expansion_shape(plan),
                padding_efficiency=plan.padding_efficiency(pa.nnz), lane_load=lane_load(plan),
                make_operator_seconds=round(t_op, 2), rel_err_vs_torch=err,
                rel_err_vs_torch_sparse_mm=lib_err, **fig,
                unit_cap_sweep=expansion_cap_sweep("expansion_spmm", plan, px, y_plain))


def expansion2_run(graph: str, a: CSR, tiered_op, widths, gen, peak_bw: float,
                   peak_fp32: float, sweep: bool = False):
    """spmm_expansion2 on one graph, as tools/bench_expansion2.py drives
    the JAX package's: the plan and its placement timed, then per width
    one SpMM through the entry point against the kernel's plain version
    and the tiered SpMM, and its time (with ``sweep``, also at each of
    EXPANSION_CAPS at the first width). Returns (the launches of the
    SpMMs, max abs err, the phase's fields, the kernel's figures at the
    first width)."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    plan = build_expansion2_plan(a)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    placed = place_plan(plan, dev)
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    del plan
    if not placed.rank1:
        raise AssertionError(f"{graph}: the normalized adjacency should plan rank-1")
    xs = [torch.randn((a.shape[1], d), generator=gen).to(dev) for d in widths]
    rows, err = [], 0.0
    with torch.inference_mode():
        kernels.reset_launch_counts()
        ys = [spmm_expansion2(placed, xd) for xd in xs]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in launches}
        expected["expansion2_spmm"] = len(widths)  # one launch per SpMM
        if launches != expected:
            raise AssertionError(f"{graph} spmm_expansion2 launches {launches}, "
                                 f"expected {expected}")
        for d, xd, y in zip(widths, xs, ys):
            err = max(err, check_close(y, e2kernels.expansion2_spmm_torch(placed, xd),
                                       f"{graph} expansion2_spmm d={d}"))
            vs_tiered = rel_err(y, spmm_internal(tiered_op, xd))
            if vs_tiered > MAIN_PATH_REL_TOL or not torch.isfinite(y).all():
                raise AssertionError(f"{graph} spmm_expansion2 d={d}: rel err {vs_tiered} "
                                     f"vs the tiered SpMM")
            ms = time_cuda(lambda: spmm_expansion2(placed, xd), iters=20)
            tiered_ms = time_cuda(lambda: spmm_internal(tiered_op, xd), iters=20)
            rep = spmm_report(ms, SpmmTraffic(a.nnz, a.shape[0], a.shape[1], d), peak_bw)
            rows.append({"d": d, "rel_err_vs_tiered": vs_tiered, "tiered_ms": tiered_ms,
                         **{k: round(v, 4) for k, v in rep.items()}})
    fig = expansion_figures("expansion2_spmm", placed, torch_csr(a, dev), widths[0], gen,
                            peak_bw, peak_fp32)
    if sweep:
        with torch.inference_mode():
            fig["unit_cap_sweep"] = expansion_cap_sweep(
                "expansion2_spmm", placed, xs[0], e2kernels.expansion2_spmm_torch(placed, xs[0]))
    mem = plan_memory_report(placed, d=widths[0])
    fields = dict(graph=graph, n_nodes=a.shape[0], nnz=a.nnz, **expansion_shape(placed),
                  padding_efficiency=placed.padding_efficiency(a.nnz),
                  lane_load=lane_load(placed), plan_bytes=mem["plan_bytes"],
                  stage_row_bytes=mem["stage_row_bytes"], plan_seconds=round(t_plan, 4),
                  placement_seconds=round(t_place, 4), launches=launches, spmm=rows)
    return launches, err, fields, fig


def spmm_launches(plan) -> dict:
    """The kernel launches of one SpMM through a placed plan."""
    if isinstance(plan, TieredEll):
        return {"bucket_spmm": 1, "gather_rows": 1 + (int(plan.finish.extra_rids.shape[0]) > 0)}
    if isinstance(plan, ExpansionPlan):
        return {"expansion_spmm": 1}
    name = {PanelPlan: "panel_spmm", FusedPlan: "fused_spmm", RangesPlan: "ranges_spmm"}[
        type(plan)]
    return {name: len(plan.segments)}


def step_launches(op: SpmmOperator, n_fwd: int, n_bwd: int) -> dict:
    """Every kernel's launches over n_fwd SpMMs on the forward plan and
    n_bwd on the transpose plan (the backward's), zero for the others."""
    want = {k: 0 for k in kernels.LAUNCHES}
    for plan, n in ((op.binned, n_fwd), (op.binned_t, n_bwd)):
        for k, c in spmm_launches(plan).items():
            want[k] += n * c
    return want


class ReluMasks:
    """Holds the ReLU (or, with ``leaky``, the leaky ReLU) derivative of
    one forward fixed for another.

    Two float32 forwards of one step (the kernels and the plain versions,
    or the card and the CPU) differ in the last bits, so a unit whose
    pre-activation lies within that of 0 takes the other branch in one of
    them: at arxiv's width a few of 87M units do (pre-activations down to
    1e-9), and each moves a weight's grad by up to 3e-4 max-relative; in
    GAT on cora one attention score of 53K lies 6.9e-6 from 0, and its
    flip moves the grad of a_dst (a sum that cancels) by 2e-3. Under
    ``record()`` torch.relu (F.leaky_relu) keeps each call's mask
    (h > 0); under ``replay()`` its i-th call returns h times mask_i's
    slope (1 or 0, or the negative slope), so a comparison holds the
    arithmetic of the two paths and not that coin flip. ``margin()`` is
    the recorded forward's least |h|: how near 0 its nearest unit lay."""

    def __init__(self, leaky: bool = False):
        self.masks, self.margins = [], []
        self.owner, self.name = (F, "leaky_relu") if leaky else (torch, "relu")

    @contextlib.contextmanager
    def _patched(self, fn):
        orig = getattr(self.owner, self.name)
        setattr(self.owner, self.name, fn)
        try:
            yield self
        finally:
            setattr(self.owner, self.name, orig)

    def record(self):
        orig = getattr(self.owner, self.name)

        def recording(h, *args, **kwargs):
            self.masks.append((h > 0).detach())
            self.margins.append(h.detach().abs().min())
            return orig(h, *args, **kwargs)
        return self._patched(recording)

    def replay(self):
        masks = iter(self.masks)

        def replaying(h, negative_slope=0.01):
            m = next(masks).to(h.device)
            if self.name == "relu":
                return h * m
            return h * torch.where(m, torch.ones((), dtype=h.dtype, device=h.device),
                                   torch.full((), negative_slope, dtype=h.dtype, device=h.device))
        return self._patched(replaying)

    def flips(self, other: "ReluMasks") -> int:
        return sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(self.masks, other.masks))

    def margin(self) -> float:
        return float(f"{float(min(m.cpu() for m in self.margins)):.3e}")


def grads_of(model: torch.nn.Module, fn) -> tuple:
    """fn()'s loss and every parameter's grad after its backward."""
    model.zero_grad(set_to_none=True)
    loss = fn()
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def grad_errs(got: tuple, want: tuple, what: str, tol: float = MAIN_PATH_REL_TOL) -> dict:
    """The loss's and each grad's max-relative error; raises above
    ``tol`` or on a non-finite value."""
    errs = {"loss": rel_err(got[0].reshape(1).float(), want[0].reshape(1).float())}
    errs.update({n: rel_err(g, want[1][n]) for n, g in got[1].items()})
    finite = torch.isfinite(got[0]) and all(torch.isfinite(g).all() for g in got[1].values())
    if not finite or max(errs.values()) > tol:
        raise AssertionError(f"{what}: loss and grads max-relative {errs}, finite {bool(finite)}")
    return {k: float(f"{v:.3e}") for k, v in errs.items()}


def train_step_figures(model: torch.nn.Module, op: SpmmOperator, x: torch.Tensor,
                       y: torch.Tensor, d_bwd: int, gen) -> dict:
    """One training step's times (forward + backward + clip + Adam; device
    time over TRAIN_STEPS steps, and wall), its peak memory above what was
    allocated before it, and the backward's two SpMMs at d_bwd timed alone
    on the transpose plan. Trains ``model`` by those steps."""
    dev = torch.device("cuda", 0)
    opt, _ = make_optimizer(model, TRAIN_LR, TRAIN_STEPS)
    step = lambda: train_step(model, op, x, y, opt)  # noqa: E731
    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = time_cuda(step, iters=TRAIN_STEPS)
    wall = wall_ms(step, iters=TRAIN_STEPS)
    g = torch.randn((op.shape[0], d_bwd), generator=gen).to(dev)
    with torch.inference_mode():
        bwd_ms = time_cuda(lambda: (spmm_internal(op.T, g), spmm_internal(op.T, g)),
                           iters=TRAIN_STEPS)
    return {"step_ms": round(ms, 4), "step_wall_ms": round(wall, 4),
            "backward_spmms_ms": round(bwd_ms, 4), "step_peak_mib": round(peak / 2**20, 1)}


def train_layouts(name: str, model_of, a: CSR, x: torch.Tensor, y: torch.Tensor, dims, gen,
                  aliased: bool) -> tuple:
    """One training step of ``model_of()`` on each of TRAIN_LAYOUTS: the
    loss and every grad with the kernels against impl="torch" from the
    same weights and the same ReLU derivatives (ReluMasks; the error with
    the plain path's own ReLU branches and the units whose branch differs
    are reported beside it), the launches of the step's forward and
    backward held exactly (three forward SpMMs, two backward: the first
    layer's input needs no grad), then the step's times. Returns (rows,
    the launches of each layout's step, the operators)."""
    rows, launches, ops = [], {}, {}
    for layout in TRAIN_LAYOUTS:
        t0 = time.perf_counter()
        op = make_operator(a, layout=layout)
        torch.cuda.synchronize()
        t_op = time.perf_counter() - t0
        if op.transpose_aliased != aliased:
            raise AssertionError(f"{name} {layout}: transpose_aliased {op.transpose_aliased}, "
                                 f"expected {aliased}")
        model = model_of()
        relu, own_relu = ReluMasks(), ReluMasks()
        kernels.reset_launch_counts()
        with relu.record():
            got = grads_of(model, lambda: model.loss_fn(op, x, y))
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        expected = step_launches(op, len(dims) - 1, len(dims) - 2)
        if counts != expected:
            raise AssertionError(f"{name} {layout} step launches {counts}, expected {expected}")
        with relu.replay():
            errs = grad_errs(got, grads_of(model, lambda: model.loss_fn(op, x, y, impl="torch")),
                             f"{name} {layout}")
        with own_relu.record():
            own = grads_of(model, lambda: model.loss_fn(op, x, y, impl="torch"))
        own_errs = {n: float(f"{rel_err(g, own[1][n]):.3e}") for n, g in got[1].items()}
        launches[layout] = counts
        ops[layout] = op
        rows.append({"layout": layout, "plan": type(op.binned).__name__,
                     "transpose_plan": type(op.binned_t).__name__,
                     "make_operator_seconds": round(t_op, 2), "loss": float(got[0]),
                     "launches_per_step": {k: n for k, n in counts.items() if n},
                     "rel_err_vs_torch": errs,
                     "rel_err_vs_torch_own_relu": own_errs, "relu_flips": relu.flips(own_relu),
                     "relu_margin": relu.margin(),
                     **train_step_figures(model, op, x, y, dims[1], gen)})
    return rows, launches, ops


def train_main_path(a_hat: CSR, cfg, x: torch.Tensor, y: torch.Tensor, gen) -> tuple:
    """GCN training on arxiv (the aliased normalized adjacency) on every
    layout, then TRAIN_EPOCHS epochs of the example's ``train`` on the
    tiered layout. Returns (the phase's fields, launches per layout)."""
    state = GCN(GCN_DIMS, generator=torch.Generator().manual_seed(0)).state_dict()

    def model_of():
        m = GCN(GCN_DIMS)
        m.load_state_dict(state)
        return m

    rows, launches, ops = train_layouts("GCN", model_of, a_hat, x, y, GCN_DIMS, gen, True)
    model = model_of()
    t0 = time.perf_counter()
    losses = train(model, ops["tiered"], x, y, TRAIN_EPOCHS, TRAIN_LR)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    if losses.shape != (TRAIN_EPOCHS,) or not torch.isfinite(losses).all():
        raise AssertionError(f"train on the tiered layout: losses {losses.tolist()}")
    return dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", model="GCN",
                dims=GCN_DIMS, n_nodes=cfg.n_nodes, nnz=a_hat.nnz,
                step="loss_fn + backward + clip_grad_norm_(5.0) + Adam", tf32=False,
                layouts=rows,
                train={"layout": "tiered", "epochs": TRAIN_EPOCHS, "lr": TRAIN_LR,
                       "schedule": "warmup(cosine_annealing(lr, epochs), 10)",
                       "losses": [round(v, 6) for v in losses.tolist()],
                       "seconds": round(t_train, 3)}), launches


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block: ``index_add_`` (the
    tiered finish's split-row sums, the plain segment sums) sorts instead
    of adding with atomics, whose order varies from run to run."""
    prev, prev_warn = (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def param_errs(got: torch.nn.Module, want: torch.nn.Module, what: str, tol: float) -> dict:
    """The largest max-relative error of a parameter against its
    counterpart, and that parameter's name; raises above ``tol`` or on a
    non-finite value."""
    ref = dict(want.named_parameters())
    errs = {n: rel_err(p.detach(), ref[n].detach()) for n, p in got.named_parameters()}
    finite = all(bool(torch.isfinite(p).all()) for p in got.parameters())
    worst = max(errs, key=errs.get)
    if not finite or errs[worst] > tol:
        raise AssertionError(f"{what}: {worst} rel err {errs[worst]} (tol {tol}), finite {finite}")
    return {"max_rel_err": float(f"{errs[worst]:.3e}"), "worst": worst}


def graph_steps(graph, args: tuple, steps: int, expected: dict, what: str,
                save_after: int = 0, path: str = "") -> torch.Tensor:
    """``steps`` steps of ``graph``, each one's kernel launches held to
    ``expected`` (counts set to 0 before the step, read after it); saves
    the graph after step ``save_after`` when given. Returns the losses."""
    losses = []
    for k in range(1, steps + 1):
        kernels.reset_launch_counts()
        losses.append(graph(*args)["loss"].float())
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        if counts != expected:
            raise AssertionError(f"{what} step {k} launches {counts}, expected {expected}")
        if k == save_after:
            graph.save(path)
    return torch.stack(losses)


def resume_figures(model_of, op: SpmmOperator, x: torch.Tensor, y: torch.Tensor, amp: bool,
                   trained: torch.nn.Module, path: str, expected: dict, name: str,
                   plain_path: str) -> dict:
    """The resume against the uninterrupted run. ``trained`` took
    GRAPH_STEPS steps on the kernels and was saved to ``path`` after
    GRAPH_RESUME_AT. On the kernels the resumed run's spread is reported
    beside a second uninterrupted run's: bucket_spmm sums a wide row's
    slot chunks with shared-memory atomics, and Adam carries those last
    bits 10 steps on. The held check runs both on the plain path
    (impl="torch") under ``deterministic()``, within RESUME_TOL."""
    out = {}
    resumed = model_of()
    graph = make_graph(resumed, op, TRAIN_LR, GRAPH_STEPS, amp=amp)
    graph.load(path)
    graph_steps(graph, (x, y), GRAPH_STEPS - GRAPH_RESUME_AT, expected, f"{name} resumed")
    rerun = model_of()
    graph_steps(make_graph(rerun, op, TRAIN_LR, GRAPH_STEPS, amp=amp), (x, y), GRAPH_STEPS,
                expected, f"{name} rerun")
    out["kernels_resume_rel_err"] = param_errs(resumed, trained, "resume", float("inf"))
    out["kernels_rerun_rel_err"] = param_errs(rerun, trained, "rerun", float("inf"))
    none = {k: 0 for k in expected}
    with deterministic():
        plain = model_of()
        graph_steps(make_graph(plain, op, TRAIN_LR, GRAPH_STEPS, amp=amp, impl="torch"),
                    (x, y), GRAPH_STEPS, none, f"{name} plain", GRAPH_RESUME_AT, plain_path)
        resumed = model_of()
        graph = make_graph(resumed, op, TRAIN_LR, GRAPH_STEPS, amp=amp, impl="torch")
        graph.load(plain_path)
        graph_steps(graph, (x, y), GRAPH_STEPS - GRAPH_RESUME_AT, none, f"{name} plain resumed")
        out["plain_resume_rel_err"] = param_errs(resumed, plain, f"TrainGraph GCN {name} resume",
                                                 RESUME_TOL)
    return out


def train_graph_gcn(op: SpmmOperator, cfg, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """The GCN example's TrainGraph (Adam at warmup + cosine, clipping at
    5.0; examples/train_gcn.py make_graph) on arxiv's tiered operator at
    GCN_DIMS, GRAPH_STEPS steps in float32 and as many under AMP (bf16
    compute, float32 masters). float32: the first GRAPH_REF_STEPS losses
    against PR 13's step (make_optimizer's torch.optim.Adam + LambdaLR +
    clip_grad_norm_) from the same weights at MAIN_PATH_REL_TOL. AMP: the
    first step's loss and grads through the kernels against impl="torch"
    at GRAPH_AMP_TOL with the same ReLU branches, float32 masters, finite
    losses, the last below the first. Both: every step's launches held
    exactly, a resume (saved after GRAPH_RESUME_AT steps, loaded into a
    new graph on fresh weights, run to the end; ``resume_figures``),
    ``step_figures``. Returns (the phase's fields, launches per step)."""
    t_phase = time.perf_counter()
    state = GCN(GCN_DIMS, generator=torch.Generator().manual_seed(0)).state_dict()

    def model_of():
        m = GCN(GCN_DIMS)
        m.load_state_dict(state)
        return m

    expected = step_launches(op, len(GCN_DIMS) - 1, len(GCN_DIMS) - 2)
    ref_model = model_of()
    opt, sched = make_optimizer(ref_model, TRAIN_LR, GRAPH_STEPS)
    ref = []
    for _ in range(GRAPH_REF_STEPS):
        ref.append(train_step(ref_model, op, x, y, opt))
        sched.step()
    ref = torch.stack(ref)
    del ref_model, opt, sched
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for amp in (False, True):
            name = "amp_bf16" if amp else "fp32"
            model, row = model_of(), {"precision": name}
            if amp:
                relu = ReluMasks()

                def loss_of(impl):
                    return lambda: compute_call(
                        lambda m, xx, yy: m.loss_fn(op, xx, yy, impl=impl), model,
                        DEFAULT_POLICY, (x, y))
                with relu.record():
                    got = grads_of(model, loss_of("auto"))
                with relu.replay():
                    want = grads_of(model, loss_of("torch"))
                row["first_step_rel_err_vs_torch"] = grad_errs(
                    got, want, "TrainGraph GCN AMP first step", GRAPH_AMP_TOL)
                row["first_step_loss_dtype"] = str(got[0].dtype)
            graph = make_graph(model, op, TRAIN_LR, GRAPH_STEPS, amp=amp)
            path = os.path.join(tmp, f"{name}.npz")
            losses = graph_steps(graph, (x, y), GRAPH_STEPS, expected, f"TrainGraph GCN {name}",
                                 GRAPH_RESUME_AT, path)
            if not torch.isfinite(losses).all():
                raise AssertionError(f"TrainGraph GCN {name}: losses {losses.tolist()}")
            if any(p.dtype != torch.float32 for p in model.parameters()):
                raise AssertionError(f"TrainGraph GCN {name}: master parameters not float32")
            if amp:
                if not losses[-1] < losses[0]:
                    raise AssertionError(f"TrainGraph GCN AMP: losses {losses.tolist()}")
            else:
                err = rel_err(losses[:GRAPH_REF_STEPS], ref)
                if err > MAIN_PATH_REL_TOL:
                    raise AssertionError(f"TrainGraph GCN fp32 vs PR 13's step: losses "
                                         f"{losses[:GRAPH_REF_STEPS].tolist()} vs "
                                         f"{ref.tolist()}, rel err {err}")
                row["rel_err_vs_pr13_step"] = float(f"{err:.3e}")
            row.update(resume_figures(model_of, op, x, y, amp, model, path, expected, name,
                                      os.path.join(tmp, f"{name}_plain.npz")))
            row.update(losses=[round(v, 6) for v in losses.tolist()],
                       **step_figures(lambda: graph(x, y), TRAIN_STEPS))
            rows.append(row)
    return dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", model="GCN",
                dims=GCN_DIMS, layout="tiered", steps=GRAPH_STEPS, lr=TRAIN_LR,
                graph_config="adam(warmup(cosine_annealing(lr, steps), 10)), clip_grad_norm=5.0",
                tf32=False, launches_per_step={k: n for k, n in expected.items() if n},
                reference_step="make_optimizer + train_step (PR 13)",
                amp_tolerance=GRAPH_AMP_TOL, resume_after=GRAPH_RESUME_AT, precisions=rows,
                seconds=round(time.perf_counter() - t_phase, 2)), expected


def mlm_batch(stream) -> tuple:
    """The stream's next batch with its second half's mask (and so its
    inputs) set to the first half's: both halves count as many masked
    tokens, so the masked mean of the batch is the mean of the halves'."""
    inputs, targets, mask = next(stream)
    h = mask.shape[0] // 2
    mask = torch.cat([mask[:h], mask[:h]])
    return torch.where(mask, torch.zeros_like(targets), targets), targets, mask


def device_busy_ms(fn) -> float:
    """The kernel time of one fn() call: torch.profiler's device events
    summed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def step_figures(step, iters: int) -> dict:
    """A training step's device ms (CUDA events), wall ms, kernel ms
    (profiler) and the device's idle share of the wall time, and its peak
    memory; ``step`` trains meanwhile."""
    _, peak = peak_mib(step)
    ms, wall = time_cuda(step, iters=iters), wall_ms(step, iters=iters)
    busy = device_busy_ms(step)
    return {"step_ms": round(ms, 4), "step_wall_ms": round(wall, 4),
            "step_kernel_ms": round(busy, 4), "device_idle_share": round(1 - busy / wall, 4),
            "step_peak_mib": peak}


def bert_figures(graph, batch: tuple) -> dict:
    """``step_figures`` of a BERT step on ``batch`` and its tokens/s."""
    fig = step_figures(lambda: graph(*batch), MLM_TIME_ITERS)
    return {**fig, "tokens_per_s": round(batch[0].numel() / (fig["step_ms"] / 1e3), 1)}


def train_bert_phase(gen) -> dict:
    """The BERT example (examples/train_bert.py) at its defaults for
    BERT_EXAMPLE_STEPS steps in float32, with AMP and with grad
    accumulation 2; then BERT-base masked LM at full width (bert_base
    hidden states, the example's tied-head loss, MLM_BATCH x MLM_SEQ,
    AdamW at MLM_LR with warmup + cosine): MLM_AMP_STEPS AMP steps, the
    first AMP loss against the float32 first loss at MLM_AMP_TOL, one
    float32 step with grad accumulation 2 against one without on the same
    batch (loss and first moments, i.e. grads, at MAIN_PATH_REL_TOL), and
    ZeRO-1 on MLM_ZERO_SHARDS shards of the card against stage 0 after
    MLM_ZERO_STEPS steps (both under ``deterministic()``); last, sparse_adam_update on the token table
    with one batch's ids against dense Adam on the touched rows."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    example = {}
    for name, kw in (("fp32", {}), ("amp", dict(amp=True)), ("grad_acc2", dict(grad_acc=2))):
        model = train_bert.make_model(device=dev)
        graph = train_bert.make_graph(model, BERT_EXAMPLE_STEPS, **kw)
        stream = train_bert.batch_stream(MLM_BATCH, 128, 1024, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = train_bert.train(graph, stream, BERT_EXAMPLE_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            raise AssertionError(f"train_bert {name}: losses {losses}")
        example[name] = {"losses": [round(v, 5) for v in losses], "seconds": round(secs, 3),
                         "tokens_per_s": round(BERT_EXAMPLE_STEPS * MLM_BATCH * 128 / secs, 1)}
    del model, graph

    base = bert_base(generator=torch.Generator().manual_seed(3))
    stream = train_bert.batch_stream(MLM_BATCH, MLM_SEQ, MLM_VOCAB, dev, seed=1)
    first = next(stream)
    fields = {"model": "bert_base (12 layers, width 768, 12 heads, MLP 3072, vocab 30522)",
              "batch": MLM_BATCH, "seq": MLM_SEQ, "lr": MLM_LR,
              "optimizer": "adamw(warmup(cosine_annealing(lr, steps), steps // 10), "
                           "weight_decay=0.01)", "tf32": False}
    g32 = train_bert.make_graph(copy.deepcopy(base), MLM_AMP_STEPS, MLM_LR)
    loss32 = float(g32(*first)["loss"])
    fields["fp32"] = {"first_loss": loss32, **bert_figures(g32, first)}
    del g32
    gamp = train_bert.make_graph(copy.deepcopy(base), MLM_AMP_STEPS, MLM_LR, amp=True)
    amp_losses = train_bert.train(gamp, itertools.chain([first], stream), MLM_AMP_STEPS)
    amp_err = abs(amp_losses[0] - loss32) / abs(loss32)
    if not np.isfinite(amp_losses).all() or amp_err > MLM_AMP_TOL:
        raise AssertionError(f"BERT-base AMP losses {amp_losses}, first vs fp32 {loss32}: "
                             f"rel {amp_err}")
    fields["amp"] = {"losses": [round(v, 5) for v in amp_losses],
                     "first_loss_rel_err_vs_fp32": float(f"{amp_err:.3e}"),
                     **bert_figures(gamp, first)}
    del gamp

    batch = mlm_batch(stream)
    accs = {}
    for k in (1, 2):
        g = train_bert.make_graph(copy.deepcopy(base), 1, MLM_LR, grad_acc=k)
        accs[k] = (g(*batch)["loss"], dict(zip(g.names, g.state["opt"].state_tree()["m"])))
    acc_errs = {"loss": rel_err(accs[2][0].reshape(1), accs[1][0].reshape(1))}
    acc_errs.update({n: rel_err(m, accs[1][1][n]) for n, m in accs[2][1].items()})
    worst = max(acc_errs, key=acc_errs.get)
    if acc_errs[worst] > MAIN_PATH_REL_TOL:
        raise AssertionError(f"BERT-base grad accumulation 2 vs 1: {worst} rel err "
                             f"{acc_errs[worst]}")
    fields["grad_accumulation"] = {"micro_batches": 2, "compared": "loss and Adam's m = 0.1 g",
                                   "max_rel_err": float(f"{acc_errs[worst]:.3e}"),
                                   "worst": worst}
    del accs, g

    mesh = ShardMesh(["cuda:0"] * MLM_ZERO_SHARDS)
    batches = [next(stream) for _ in range(MLM_ZERO_STEPS)]
    zero = {}
    with deterministic():  # the same grads in both: the key bias's are rounding noise,
        for stage in (0, 1):  # which Adam turns into +-lr steps
            m = copy.deepcopy(base)
            g = train_bert.make_graph(m, MLM_ZERO_STEPS, MLM_LR, zero_stage=stage,
                                      mesh=mesh if stage else None)
            for b in batches:
                g(*b)
            zero[stage] = (m, g)
    ostate = zero[1][1].state["opt"]
    fields["zero1"] = {
        "shards": MLM_ZERO_SHARDS, "steps": MLM_ZERO_STEPS,
        "sharded_params": int(sum(ostate.sharded)), "replicated_params": int(
            len(ostate.sharded) - sum(ostate.sharded)),
        "param_rel_err_vs_stage0": param_errs(zero[1][0], zero[0][0], "BERT-base ZeRO-1",
                                              MAIN_PATH_REL_TOL)}
    del zero, ostate, base

    table = torch.randn((MLM_VOCAB, 768), generator=gen).to(dev)
    m0 = (0.01 * torch.randn((MLM_VOCAB, 768), generator=gen)).to(dev)
    v0 = (0.01 * torch.rand((MLM_VOCAB, 768), generator=gen)).to(dev)
    ids = first[0].reshape(-1)
    g = IndexedSlices(ids, torch.randn((ids.shape[0], 768), generator=gen).to(dev), MLM_VOCAB)
    b1, b2, eps, lr, t = 0.9, 0.999, 1e-8, 1e-3, 3

    def dense_adam():
        gd = g.dense()
        m = b1 * m0 + (1 - b1) * gd
        v = b2 * v0 + (1 - b2) * gd * gd
        return table - lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps), m, v

    got = sparse_adam_update(table, m0, v0, t, g, lr=lr, b1=b1, b2=b2, eps=eps)
    touched = torch.zeros(MLM_VOCAB, dtype=torch.bool, device=dev)
    touched[ids] = True
    sparse_errs = {}
    for name, a, d, old in zip(("param", "m", "v"), got, dense_adam(), (table, m0, v0)):
        want = torch.where(touched[:, None], d, old)
        sparse_errs[name] = rel_err(a, want)
        if sparse_errs[name] > MAIN_PATH_REL_TOL or not torch.equal(a[~touched], old[~touched]):
            raise AssertionError(f"sparse_adam_update {name}: rel err {sparse_errs[name]} or "
                                 "an untouched row changed")
    fields["sparse_update"] = {
        "table": [MLM_VOCAB, 768], "ids": int(ids.shape[0]),
        "unique_ids": int(touched.sum()),
        "rel_err_vs_dense_on_touched_rows": {k: float(f"{v:.3e}") for k, v in sparse_errs.items()},
        "sparse_adam_update_ms": round(time_cuda(lambda: sparse_adam_update(
            table, m0, v0, t, g, lr=lr, b1=b1, b2=b2, eps=eps), iters=20), 4),
        "dense_adam_whole_table_ms": round(time_cuda(dense_adam, iters=20), 4)}
    return dict(example=example, bert_base_mlm=fields,
                seconds=round(time.perf_counter() - t_phase, 2))


def sage_train(csr: CSR, cfg, x: torch.Tensor, y: torch.Tensor, gen) -> tuple:
    """GraphSAGE training on arxiv's mean adjacency D^-1 A (not
    symmetric: every layout builds its own transpose plan) on every
    layout, then one GAT step (GAT_HEADS heads) on cora on the card
    against the same step on the CPU with the card's leaky-ReLU branches
    (ReluMasks; the error with the CPU's own branches and the scores
    whose branch differs are reported beside it). Returns (the phase's
    fields, launches per layout)."""
    m_adj = mean_adjacency(csr)
    state = GraphSAGE(GCN_DIMS, generator=torch.Generator().manual_seed(2)).state_dict()

    def model_of():
        m = GraphSAGE(GCN_DIMS)
        m.load_state_dict(state)
        return m

    rows, launches, _ = train_layouts("GraphSAGE", model_of, m_adj, x, y, GCN_DIMS, gen, False)
    ccsr, ccfg = load_graph("cora", symmetrize=True)
    ca = normalized_adjacency(ccsr)
    cx, cy = (torch.from_numpy(a) for a in random_features(ccfg))
    dims = (ccfg.feature_dim, GAT_HIDDEN, ccfg.n_classes)
    gat_cpu = GAT(dims, heads=GAT_HEADS, device="cpu", generator=torch.Generator().manual_seed(3))
    gat = GAT(dims, heads=GAT_HEADS)
    gat.load_state_dict(gat_cpu.state_dict())
    cop, cop_cpu = make_operator(ca), make_operator(ca, device="cpu")
    dev = torch.device("cuda", 0)
    cxd, cyd = cx.to(dev), cy.long().to(dev)
    branches, own_branches = ReluMasks(leaky=True), ReluMasks(leaky=True)
    with branches.record():
        got = grads_of(gat, lambda: gat.loss_fn(cop, cxd, cyd))
    got = (got[0].cpu(), {n: g.cpu() for n, g in got[1].items()})
    with branches.replay():
        want = grads_of(gat_cpu, lambda: gat_cpu.loss_fn(cop_cpu, cx, cy.long()))
    errs = grad_errs(got, want, "GAT on cora, card vs CPU")
    with own_branches.record():
        own = grads_of(gat_cpu, lambda: gat_cpu.loss_fn(cop_cpu, cx, cy.long()))
    own_errs = {n: float(f"{rel_err(g, own[1][n]):.3e}") for n, g in got[1].items()}
    opt, _ = make_optimizer(gat, TRAIN_LR, TRAIN_STEPS)
    gat_ms = time_cuda(lambda: train_step(gat, cop, cxd, cyd, opt), iters=TRAIN_STEPS)
    return dict(graph="ogbn-arxiv (synthetic, symmetrized), mean adjacency D^-1 A",
                model="GraphSAGE", dims=GCN_DIMS, n_nodes=cfg.n_nodes, nnz=m_adj.nnz,
                step="loss_fn + backward + clip_grad_norm_(5.0) + Adam", tf32=False,
                layouts=rows,
                gat={"graph": "cora (synthetic, symmetrized, self-loops)", "dims": dims,
                     "heads": GAT_HEADS, "aggregation": "spmm_coo over op.coo_rows/coo_cols",
                     "rel_err_vs_cpu": errs, "rel_err_vs_cpu_own_leaky_relu": own_errs,
                     "leaky_relu_flips": branches.flips(own_branches),
                     "leaky_relu_margin": branches.margin(),
                     "step_ms": round(gat_ms, 4)}), launches


def shuffle_ids(csr: CSR, seed: int) -> tuple:
    """``csr`` with its node ids permuted by a seeded permutation (node i
    becomes perm[i], rows and columns alike), as bench.py's --shuffled
    destroys the generator's community-contiguous ids. Returns (the
    shuffled CSR, perm)."""
    n = csr.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(csr.indptr, np.int64)))
    shuffled = CSR.from_coo(COO.from_arrays(
        perm[rows].astype(np.int32), perm[np.asarray(csr.cols, np.int64)].astype(np.int32),
        np.asarray(csr.vals), csr.shape))
    return shuffled, perm


def plan_work(plan) -> dict:
    """The segments, control steps and work units of a placed panel,
    fused or ranges plan."""
    return {"segments": len(plan.segments), "steps": sum(s.n_steps for s in plan.segments),
            "units": sum(int(s.windows.units.shape[0]) for s in plan.segments),
            "split_tiles": sum(int(s.windows.split_tiles.shape[0]) for s in plan.segments)}


def reorder_main_path(a_hat: CSR, cfg, x: torch.Tensor, y: torch.Tensor, model: GCN,
                      logits: torch.Tensor, unshuffled_spmm_ms: dict, gen) -> tuple:
    """GCN inference on shuffled arxiv through make_operator(reorder=
    REORDER_METHOD) on each layout the reorder applies to: the node ids of
    the normalized adjacency permuted (REORDER_SEED, as bench.py
    --shuffled), then the matching reorder recovers the locality; the
    reorder's seconds and the band coverage (locality_stats) of the
    original, shuffled and reordered orderings. Per layout: the plan's
    steps and units, the launches of one forward (held exactly), logits
    against impl="torch" on the same operator and against the unshuffled
    tiered logits mapped through the permutation, the kernel against its
    plain version at the main path's widths, and the SpMM at d = 128 on
    the reordered operator, on the shuffled graph without reorder and
    (``unshuffled_spmm_ms``) on the unshuffled graph. Then one training
    step's loss and grads on REORDER_GRAD_LAYOUT against impl="torch"
    with the same ReLU branches. Returns (the phase's fields, launches of
    one forward per kernel, max abs err per kernel)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    shuffled, perm = shuffle_ids(a_hat, REORDER_SEED)
    t_shuffle = time.perf_counter() - t0
    t0 = time.perf_counter()
    reordered, ofn, _ = reorder_locality(shuffled, REORDER_METHOD)
    t_reorder = time.perf_counter() - t0
    t0 = time.perf_counter()
    coverage = {k: locality_stats(c)["band_coverage"]
                for k, c in (("original", a_hat), ("shuffled", shuffled),
                             ("reordered", reordered))}
    t_stats = time.perf_counter() - t0
    del reordered
    perm_t = torch.from_numpy(perm).to(dev)
    inv_t = torch.from_numpy(np.argsort(perm)).to(dev)
    x_s, y_s = x.index_select(0, inv_t), y.index_select(0, inv_t)  # x_s[perm[i]] = x[i]
    rows, launches, errs = [], {}, {}
    grad_fields = None
    for layout in REORDER_LAYOUTS:
        kname = {"panels": "panel_spmm", "fused": "fused_spmm", "ranges": "ranges_spmm"}[layout]
        kmod = {"panels": pkernels, "fused": fkernels, "ranges": rkernels}[layout]
        kernel, plain = getattr(kmod, kname), getattr(kmod, f"{kname}_torch")
        t0 = time.perf_counter()
        op = make_operator(shuffled, layout=layout, reorder=REORDER_METHOD)
        torch.cuda.synchronize()
        t_op = time.perf_counter() - t0
        sp = op.binned
        if not (op.relabeled and op.transpose_aliased
                and np.array_equal(op.old_from_new.cpu().numpy(), ofn)):
            raise AssertionError(f"reordered {layout}: relabeled {op.relabeled}, aliased "
                                 f"{op.transpose_aliased}, or another permutation")
        with torch.inference_mode():
            kernels.reset_launch_counts()
            got = model(op, x_s)
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            expected = {k: 0 for k in counts}
            expected[kname] = 3 * len(sp.segments)
            if counts != expected:
                raise AssertionError(f"reordered {layout} launches {counts}, expected {expected}")
            want = model(op, x_s, impl="torch")
            torch.cuda.synchronize()
        if got.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(got).all():
            raise AssertionError(f"reordered {layout} logits not finite or wrong shape")
        vs_plain = rel_err(got, want)
        vs_unshuffled = rel_err(got.index_select(0, perm_t), logits)
        if vs_plain > MAIN_PATH_REL_TOL or vs_unshuffled > MAIN_PATH_REL_TOL:
            raise AssertionError(f"reordered {layout} GCN logits: rel err {vs_plain} vs "
                                 f"impl=torch, {vs_unshuffled} vs the unshuffled logits")
        err = 0.0
        with torch.inference_mode():
            for d in sorted(set(GCN_DIMS[:-1])):
                xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
                err = max(err, check_close(kernel(sp, xd), plain(sp, xd),
                                           f"reordered arxiv {kname} d={d}"))
            h = torch.randn((cfg.n_nodes, 128), generator=gen).to(dev)
            ms = time_cuda(lambda: spmm_internal(op, h), iters=20)
            node_ms = time_cuda(lambda: spmm(op, h), iters=20)
            fwd_ms = time_cuda(lambda: model(op, x_s), iters=20)
        # the same layout on the shuffled ids without reorder: what the
        # reorder buys
        t0 = time.perf_counter()
        sop = make_operator(shuffled, layout=layout)
        torch.cuda.synchronize()
        t_sop = time.perf_counter() - t0
        with torch.inference_mode():
            s_err = rel_err(spmm_internal(sop, h), spmm(op, h))
            if s_err > MAIN_PATH_REL_TOL:
                raise AssertionError(f"shuffled {layout} SpMM vs reordered: rel err {s_err}")
            s_ms = time_cuda(lambda: spmm_internal(sop, h), iters=20)
        s_work = plan_work(sop.binned)
        del sop
        if layout == REORDER_GRAD_LAYOUT:
            relu = ReluMasks()
            kernels.reset_launch_counts()
            with relu.record():
                g_got = grads_of(model, lambda: model.loss_fn(op, x_s, y_s))
            torch.cuda.synchronize()
            g_counts = dict(kernels.LAUNCHES)
            if g_counts != step_launches(op, len(GCN_DIMS) - 1, len(GCN_DIMS) - 2):
                raise AssertionError(f"reordered {layout} step launches {g_counts}")
            with relu.replay():
                g_errs = grad_errs(g_got, grads_of(model, lambda: model.loss_fn(
                    op, x_s, y_s, impl="torch")), f"reordered {layout} backward")
            model.zero_grad(set_to_none=True)
            grad_fields = {"layout": layout, "loss": float(g_got[0]),
                           "launches_per_step": {k: n for k, n in g_counts.items() if n},
                           "rel_err_vs_torch": g_errs, "relu_margin": relu.margin()}
        launches[kname] = counts[kname]
        errs[kname] = err
        rows.append({"layout": layout, "plan": type(sp).__name__, **plan_work(sp),
                     "make_operator_seconds": round(t_op, 2),
                     "launches_per_forward": {k: n for k, n in counts.items() if n},
                     "logits_rel_err_vs_torch": vs_plain,
                     "logits_rel_err_vs_unshuffled": vs_unshuffled, "max_abs_err": err,
                     "spmm_ms": round(ms, 4), "spmm_node_space_ms": round(node_ms, 4),
                     "unshuffled_spmm_ms": unshuffled_spmm_ms[layout],
                     "shuffled_no_reorder": {"spmm_ms": round(s_ms, 4), **s_work,
                                             "make_operator_seconds": round(t_sop, 2),
                                             "rel_err_vs_reordered": s_err},
                     "forward_ms": round(fwd_ms, 4)})
        del op, sp
    fields = dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops), node ids shuffled",
                  n_nodes=cfg.n_nodes, nnz=a_hat.nnz, dims=GCN_DIMS, shuffle_seed=REORDER_SEED,
                  method=REORDER_METHOD, native_reorder=native.available(),
                  shuffle_seconds=round(t_shuffle, 2), reorder_seconds=round(t_reorder, 3),
                  locality_stats_seconds=round(t_stats, 2), band_coverage=coverage,
                  spmm_d=128, layouts=rows, backward=grad_fields,
                  seconds=round(time.perf_counter() - t_phase, 1))
    return fields, launches, errs


def spgemm_merge_check(c_keys: torch.Tensor, c_vals: torch.Tensor, rows, cols,
                       vals: torch.Tensor, n_cols: int, what: str) -> float:
    """Merge COO values with duplicates (a padded or product-form result)
    onto C's sorted pattern on the card and hold the merged values against
    C's: |m - c| <= 1e-5 + 1e-4|c|. Entries outside C's pattern must be
    exact zeros (the product form's pads). Returns max |m - c|."""
    dev = c_vals.device
    keys = (torch.from_numpy(rows).to(dev).long() * n_cols
            + torch.from_numpy(cols).to(dev).long())
    slot = torch.searchsorted(c_keys, keys).clamp_max(c_keys.shape[0] - 1)
    hit = c_keys[slot] == keys
    if (vals[~hit] != 0).any():
        raise AssertionError(f"{what}: nonzero values outside C's pattern")
    merged = torch.zeros_like(c_vals).index_add_(0, slot[hit], vals[hit])
    return check_close(merged, c_vals, what)


def spgemm_bound_ms(index_elems: int, value_elems: int, out_elems: int, peak_bw: float) -> float:
    """Least time of a numeric phase (ms): its plan's int32 index arrays
    and the two value tables read once, its float32 output written once,
    over HBM bandwidth (its 2 flops a product are far below the fp32
    peak's share)."""
    return round(4 * (index_elems + value_elems + out_elems) / peak_bw * 1e3, 4)


def spgemm_phase(csr: CSR, gen, peak_bw: float) -> dict:
    """C = A @ A on arxiv's symmetrized adjacency (the 2-hop product):
    the host product (native Gustavson) and each symbolic phase timed on
    the host; the plain and product-form numeric phases on the card held
    against the host C (the product form after merging its duplicates on
    the card), their device times and 2 * products / s; torch.sparse.mm
    of the two CSR tensors as the library yardstick (it merges, so its
    output is C's); the padded form at arxiv when its plan fits
    SPGEMM_PADDED_MAX_BYTES, else on a smaller seeded graph; the numeric
    phases again with new values on the reused plans; and the
    composition check on cora: an operator built from
    spgemm_device(A_hat, A_hat), on SPGEMM_COMPOSE_LAYOUTS, against
    A_hat @ (A_hat @ X)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    a = CSR.from_arrays(csr.indptr, csr.cols, np.asarray(csr.vals, np.float32), csr.shape)
    indptr = np.asarray(a.indptr, np.int64)
    products = int((indptr[a.cols.astype(np.int64) + 1] - indptr[a.cols]).sum())
    t0 = time.perf_counter()
    host = spgemm(a, a)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = spgemm_symbolic(a, a)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    pplan = spgemm_symbolic_products(a, a)
    t_psym = time.perf_counter() - t0
    if not (np.array_equal(plan.indptr, host.indptr) and np.array_equal(plan.cols, host.cols)):
        raise AssertionError("spgemm_symbolic's pattern differs from the host product's")
    if pplan.n_products != products or plan.a_pos.shape[0] != products:
        raise AssertionError(f"products: plan {plan.a_pos.shape[0]}, product form "
                             f"{pplan.n_products}, counted {products}")
    n = a.shape[1]
    c_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(host.indptr))
    c_keys = torch.from_numpy(c_rows * n + host.cols).to(dev)
    c_vals = torch.from_numpy(host.vals).to(dev)
    del c_rows
    av = torch.from_numpy(np.asarray(a.vals)).to(dev)
    placed = place_spgemm_plan(plan, dev)
    pplaced = place_spgemm_plan(pplan, dev)

    def plain():
        return spgemm_numeric(placed.a_pos, placed.b_pos, placed.out_slot, av, av,
                              placed.out_nnz)

    def product_form():
        return spgemm_numeric_products(pplaced, av, av)

    forms = {}
    with torch.inference_mode():
        err = check_close(plain(), c_vals, "spgemm_numeric on arxiv")
        ms = time_cuda(plain, iters=10)
        forms["plain"] = {"ms": round(ms, 4), "gflops": round(2 * products / ms / 1e6, 3),
                          "max_abs_err": err, "entries": placed.out_nnz,
                          "bound_ms": spgemm_bound_ms(3 * products, 2 * a.nnz, placed.out_nnz,
                                                      peak_bw)}
        pv = product_form()
        err = spgemm_merge_check(c_keys, c_vals, pplan.rows, pplan.cols, pv, n,
                                 "spgemm_numeric_products on arxiv, merged")
        ms = time_cuda(product_form, iters=10)
        forms["products"] = {"ms": round(ms, 4), "gflops": round(2 * products / ms / 1e6, 3),
                             "max_abs_err": err, "entries": pplan.n_out,
                             "bound_ms": spgemm_bound_ms(
                                 pplaced.a_perm.shape[0] + pplaced.ell_idx.shape[0]
                                 + sum(int(br.shape[0]) for (*_, br) in pplaced.buckets),
                                 2 * a.nnz, pplan.n_out, peak_bw)}
        del pv
        sa = torch_csr(a, dev)
        lib = torch.sparse.mm(sa, sa)
        # its columns need not be sorted within a row: compare by (row, col)
        lib_rows = torch.repeat_interleave(torch.arange(a.shape[0], device=dev),
                                           lib.crow_indices().diff())
        lib_keys, order = torch.sort(lib_rows * n + lib.col_indices())
        lib_ok = lib._nnz() == host.nnz and torch.equal(lib_keys, c_keys)
        if not lib_ok:
            raise AssertionError(f"torch.sparse.mm A @ A: {lib._nnz()} entries, C has "
                                 f"{host.nnz}, or another pattern")
        lib_err = check_close(lib.values()[order], c_vals, "torch.sparse.mm A @ A")
        lib_ms = time_cuda(lambda: torch.sparse.mm(sa, sa), iters=5)
        del lib, lib_rows, lib_keys, order
    # the padded form: at arxiv when its index matrices fit, else on a
    # smaller seeded graph
    counts = np.bincount(plan.out_slot, minlength=plan.out_nnz)
    width = np.where(counts > SPGEMM_PADDED_WIDTH, SPGEMM_PADDED_WIDTH,
                     1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
    parts = np.where(counts > SPGEMM_PADDED_WIDTH, -(-counts // SPGEMM_PADDED_WIDTH), 1)
    padded_bytes = int(2 * 4 * (width * parts).sum())
    del counts, width, parts
    if padded_bytes <= SPGEMM_PADDED_MAX_BYTES:
        pa, pad_graph, pad_host = a, "ogbn-arxiv (the same A)", host
    else:
        rng = np.random.default_rng(SPGEMM_SMALL_SEED)
        sn = SPGEMM_SMALL_N
        key = np.unique(rng.integers(0, sn * sn, SPGEMM_SMALL_NNZ))
        pa = CSR.from_coo(COO.from_arrays(key // sn, key % sn,
                                          rng.random(key.shape[0]).astype(np.float32), (sn, sn)))
        pad_graph = f"seeded random {sn} x {sn}, {pa.nnz} nnz"
        pad_host = spgemm(pa, pa)
    t0 = time.perf_counter()
    dplan = spgemm_symbolic_padded(pa, pa, max_width=SPGEMM_PADDED_WIDTH)
    t_dsym = time.perf_counter() - t0
    dplaced = place_spgemm_plan(dplan, dev)
    pav = torch.from_numpy(np.asarray(pa.vals)).to(dev)
    pn = pa.shape[1]
    prow = np.repeat(np.arange(pa.shape[0], dtype=np.int64), np.diff(pad_host.indptr))
    p_keys = torch.from_numpy(prow * pn + pad_host.cols).to(dev)
    p_vals = torch.from_numpy(pad_host.vals).to(dev)
    p_products = int(dplan.n_products)

    def padded():
        return spgemm_numeric_padded(dplaced.buckets, pav, pav)

    with torch.inference_mode():
        err = spgemm_merge_check(p_keys, p_vals, dplan.rows, dplan.cols, padded(), pn,
                                 "spgemm_numeric_padded, merged")
        ms = time_cuda(padded, iters=10)
    forms["padded"] = {"graph": pad_graph, "plan_bytes_estimate": padded_bytes,
                       "max_width": SPGEMM_PADDED_WIDTH, "symbolic_seconds": round(t_dsym, 2),
                       "ms": round(ms, 4), "gflops": round(2 * p_products / ms / 1e6, 3),
                       "max_abs_err": err, "entries": dplan.out_nnz, "products": p_products,
                       "bound_ms": spgemm_bound_ms(
                           2 * sum(int(pa_.numel()) for (_, pa_, _) in dplaced.buckets),
                           2 * pa.nnz, dplan.out_nnz, peak_bw)}
    del dplaced, dplan, p_keys, p_vals
    # new values on the reused plans (the training-loop case)
    a2 = CSR(indptr=a.indptr, cols=a.cols, shape=a.shape,
             vals=np.random.default_rng(SPGEMM_VALUES_SEED).random(a.nnz).astype(np.float32))
    host2 = spgemm(a2, a2)
    c2, plan2 = spgemm_device(a2, a2, plan=placed)
    if plan2.a_pos is not placed.a_pos:
        raise AssertionError("spgemm_device placed a plan it was given again")
    reuse_err = check_close(torch.from_numpy(c2.vals), torch.from_numpy(host2.vals),
                            "spgemm_device with new values on the reused plan")
    av2 = torch.from_numpy(a2.vals).to(dev)
    with torch.inference_mode():
        reuse_perr = spgemm_merge_check(c_keys, torch.from_numpy(host2.vals).to(dev),
                                        pplan.rows, pplan.cols,
                                        spgemm_numeric_products(pplaced, av2, av2), n,
                                        "spgemm_numeric_products with new values, merged")
    del placed, pplaced, c_keys, c_vals, c2
    # composition: an operator built from C = A_hat @ A_hat on the card
    ccsr, _ = load_graph("cora", symmetrize=True)
    ca = normalized_adjacency(ccsr)
    cc, _ = spgemm_device(ca, ca)
    aop = make_operator(ca)
    xc = torch.randn((ca.shape[0], 64), generator=gen).to(dev)
    compose = []
    with torch.inference_mode():
        want = spmm(aop, spmm(aop, xc))
        for layout in SPGEMM_COMPOSE_LAYOUTS:
            cop = make_operator(cc, layout=layout)
            e = rel_err(spmm(cop, xc), want)
            if e > MAIN_PATH_REL_TOL:
                raise AssertionError(f"C = A_hat @ A_hat on {layout}: rel err {e}")
            compose.append({"layout": layout, "plan": type(cop.binned).__name__,
                            "rel_err_vs_two_spmms": e})
    return dict(graph="ogbn-arxiv (synthetic, symmetrized, no self-loops)", n_nodes=n,
                nnz=a.nnz, products=products, out_nnz=host.nnz,
                native_host=native.available(), host_seconds=round(t_host, 3),
                host_gflops=round(2 * products / t_host / 1e9, 3),
                symbolic_seconds={"plain": round(t_sym, 2), "products": round(t_psym, 2),
                                  "padded": forms["padded"]["symbolic_seconds"]},
                tolerance="|c-h| <= 1e-5 + 1e-4|h| (padded and product forms merged)",
                forms=forms,
                torch_sparse_mm={"ms": round(lib_ms, 4),
                                 "gflops": round(2 * products / lib_ms / 1e6, 3),
                                 "max_abs_err": lib_err,
                                 "note": "merges duplicates: its output is C's CSR"},
                reused_plan={"values_seed": SPGEMM_VALUES_SEED, "spgemm_device_max_abs_err":
                             reuse_err, "products_max_abs_err": reuse_perr},
                composition={"graph": "cora (synthetic, symmetrized, self-loops)",
                             "C_nnz": cc.nnz, "d": 64, "layouts": compose},
                seconds=round(time.perf_counter() - t_phase, 1))


def dist_kernel(impl: str) -> str:
    """The kernel a dist_spmm impl launches on the card."""
    return "panel_spmm" if impl == "panels" else "bucket_spmm"


def counted(fn) -> tuple:
    """fn()'s result and the kernel launches it made (counts reset first)."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in kernels.LAUNCHES.items() if n}


def dist_plan_case(name: str, kw: dict, a_hat: CSR, mesh: ShardMesh, x: torch.Tensor,
                   w: torch.Tensor, single_y: torch.Tensor, single_g: torch.Tensor) -> tuple:
    """One partition of arxiv on the shard mesh: the forward through the
    kernel against the plain version on the same plan and against the
    single-operator SpMM, the gradient of sum(Y * W) likewise, the
    launches of each held exactly, then the times. Returns (the row, the
    plan, its launches)."""
    S = DIST_SHARDS
    t0 = time.perf_counter()
    plan = partition_rows(a_hat, S, **kw)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh.place(plan)
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    impl = "panels" if kw.get("local_engine") == "panels" else "cuda"
    plain = "panels_torch" if impl == "panels" else "torch"
    kname = dist_kernel(impl)

    def fwd_bwd(which):
        xr = x.clone().requires_grad_()
        y, fwd = counted(lambda: dist_spmm(plan, xr, mesh, impl=which))
        (g,), bwd = counted(lambda: torch.autograd.grad(y, xr, w, retain_graph=True))
        return xr, y, g, fwd, bwd

    def rel(a, b):
        return rel_err(a.detach(), b.detach())

    xr, y, g, fwd, bwd = fwd_bwd(impl)
    per_fwd = S * (2 if plan.split else 1)
    if fwd != {kname: per_fwd} or bwd != {kname: S}:
        raise AssertionError(f"dist {name}: launches forward {fwd}, backward {bwd}; expected "
                             f"{kname} {per_fwd} and {S}")
    _, y_plain, g_plain, _, _ = fwd_bwd(plain)
    errs = {"forward_vs_plain": rel(y, y_plain), "forward_vs_single": rel(y, single_y),
            "grad_vs_plain": rel(g, g_plain), "grad_vs_single": rel(g, single_g)}
    finite = bool(torch.isfinite(y).all() and torch.isfinite(g).all())
    if not finite or y.shape != single_y.shape or max(errs.values()) > MAIN_PATH_REL_TOL:
        raise AssertionError(f"dist {name}: {errs}, finite {finite}, shape {tuple(y.shape)}")
    with torch.inference_mode():
        ms = time_cuda(lambda: dist_spmm(plan, x, mesh, impl=impl), iters=DIST_ITERS)
        wall = wall_ms(lambda: dist_spmm(plan, x, mesh, impl=impl), iters=DIST_ITERS)
        plain_ms = time_cuda(lambda: dist_spmm(plan, x, mesh, impl=plain), iters=3)
        ex_ms = time_cuda(lambda: exchange(plan, x, mesh), iters=DIST_ITERS)
    bwd_ms = time_cuda(lambda: torch.autograd.grad(y, xr, w, retain_graph=True),
                       iters=DIST_ITERS)
    row = {"plan": name, "options": kw, "impl": impl, "kernel": kname,
           "halo_size": plan.halo_size, "halo_rows_per_shard": plan.halo_rows_total,
           "offset_widths": plan.offset_widths, "hubs": plan.n_hubs,
           "rows_per_shard": plan.rows_per_shard, "cols_per_shard": plan.cols_per_shard,
           "split": plan.split, "comm_stats_d128": plan.comm_stats(DIST_D),
           "plan_seconds": round(t_plan, 3), "placement_seconds": round(t_place, 3),
           "launches_forward": fwd, "launches_backward": bwd,
           "rel_err": {k: float(f"{v:.3e}") for k, v in errs.items()},
           "forward_ms": round(ms, 4), "forward_wall_ms": round(wall, 4),
           "backward_ms": round(bwd_ms, 4), "exchange_ms": round(ex_ms, 4),
           "plain_forward_ms": round(plain_ms, 4)}
    if name == "P1":
        with torch.inference_mode():
            ya = dist_spmm_allgather(plan, x, mesh, impl=impl)
            ag_err = rel_err(ya, single_y)
            if ag_err > MAIN_PATH_REL_TOL:
                raise AssertionError(f"dist_spmm_allgather on P1: rel err {ag_err}")
            row["allgather_ms"] = round(time_cuda(
                lambda: dist_spmm_allgather(plan, x, mesh, impl=impl), iters=DIST_ITERS), 4)
            row["allgather_rel_err_vs_single"] = float(f"{ag_err:.3e}")
    return row, plan, {"forward": fwd[kname], "backward": bwd[kname]}


def dist_train_step(plan, mesh: ShardMesh, model: GCN, x: torch.Tensor,
                    y: torch.Tensor) -> tuple:
    """One make_dist_train_step step (SGD, lr TRAIN_LR) on ``plan`` through
    the bucket kernel against the plain step from the same weights, with
    the kernel step's ReLU branches replayed in the plain one: the loss,
    every grad and every updated parameter within MAIN_PATH_REL_TOL. Then
    the step's device and wall times and its peak memory. Returns (the
    fields, the kernel step's launches)."""
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def fresh():
        m = GCN(model.feature_dims)
        m.load_state_dict(state)
        return m

    def step_of(m, impl):
        step = make_dist_train_step(m, plan, mesh, lr=TRAIN_LR, impl=impl)
        return lambda: step(x, y)

    mk, mp, mo = fresh(), fresh(), fresh()
    relu, own = ReluMasks(), ReluMasks()
    with relu.record():
        loss_k, launches = counted(step_of(mk, "cuda"))
    with relu.replay():
        loss_p = step_of(mp, "torch")()
    with own.record():
        step_of(mo, "torch")()
    errs = {"loss": rel_err(loss_k.reshape(1), loss_p.reshape(1))}
    pk, pp = dict(mk.named_parameters()), dict(mp.named_parameters())
    for n in pk:
        errs[f"grad {n}"] = rel_err(pk[n].grad, pp[n].grad)
        errs[f"param {n}"] = rel_err(pk[n].detach(), pp[n].detach())
    finite = bool(torch.isfinite(loss_k)) and all(torch.isfinite(p).all() for p in pk.values())
    # a forward SpMM per layer and shard, a backward one for each layer but
    # the first (its input needs no grad)
    want = {"bucket_spmm": (2 * len(model.layers) - 1) * mesh.size}
    if not finite or max(errs.values()) > MAIN_PATH_REL_TOL or launches != want:
        raise AssertionError(f"dist train step: {errs}, finite {finite}, launches {launches}, "
                             f"expected {want}")
    own_errs = {n: float(f"{rel_err(pk[n].grad, p.grad):.3e}")
                for n, p in mo.named_parameters()}
    step = step_of(mk, "cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"loss": float(loss_k), "lr": TRAIN_LR, "launches": launches,
            "rel_err_vs_torch": {k: float(f"{v:.3e}") for k, v in errs.items()},
            "grad_rel_err_vs_torch_own_relu": own_errs, "relu_flips": relu.flips(own),
            "relu_margin": relu.margin(),
            "step_ms": round(time_cuda(step, iters=DIST_ITERS), 4),
            "step_wall_ms": round(wall_ms(step, iters=DIST_ITERS), 4),
            "step_peak_mib": round(peak / 2**20, 1)}, launches


def dist_rank_form(a_hat: CSR, x: torch.Tensor, w: torch.Tensor) -> dict:
    """The rank form on the card: an NCCL group of world size 1 (a file://
    store in a temporary directory) on partition_rows(a_hat, 1); its
    forward and gradient against the shard-mesh form of the same plan."""
    plan = partition_rows(a_hat, 1)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(backend="nccl", init_method=f"file://{tmp}/store",
                               world_size=1, rank=0)
        try:
            backend = torch.distributed.get_backend()
            if backend != "nccl":
                raise AssertionError(f"rank form: backend {backend}, expected nccl")
            xb = pad_x_for_plan(plan, x).clone().requires_grad_()
            yb, launches = counted(lambda: dist_spmm(plan, xb, RankGroup(), impl="cuda"))
            (gb,) = torch.autograd.grad(yb, xb, w)
        finally:
            distributed.destroy()
    xm = x.clone().requires_grad_()
    ym = dist_spmm(plan, xm, ShardMesh(["cuda:0"]), impl="cuda")
    (gm,) = torch.autograd.grad(ym, xm, w)
    errs = {"forward": rel_err(yb[: x.shape[0]].detach(), ym.detach()),
            "grad": rel_err(gb[: x.shape[0]], gm)}
    if max(errs.values()) > MAIN_PATH_REL_TOL or launches != {"bucket_spmm": 1}:
        raise AssertionError(f"rank form vs shard mesh: {errs}, launches {launches}")
    return {"backend": backend, "world_size": 1, "plan": "partition_rows(a_hat, 1)",
            "launches_forward": launches,
            "rel_err_vs_shard_mesh": {k: float(f"{v:.3e}") for k, v in errs.items()},
            "note": "a multi-rank NCCL run needs two or more cards: NCCL refuses two ranks on "
                    "one device; the rank form's collectives across ranks are checked over "
                    "gloo on the CPU (tests/test_torch_dist_rank.py)"}


def dist_main_path(a_hat: CSR, cfg, op: SpmmOperator, x: torch.Tensor, y: torch.Tensor,
                   model: GCN, logits: torch.Tensor, gen) -> tuple:
    """The distributed SpMM on arxiv: DIST_SHARDS shards on one card
    (ShardMesh(["cuda:0"] * S)) for each of DIST_PLANS (dist_plan_case),
    dist_gcn_apply on DIST_GCN_PLANS against the single-operator logits,
    one training step on P1, and the rank form over NCCL at world size 1.
    Returns (the phase's fields, launches per kernel)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    mesh = ShardMesh([dev] * DIST_SHARDS)
    xd = torch.randn((cfg.n_nodes, DIST_D), generator=gen).to(dev)
    w = torch.randn((cfg.n_nodes, DIST_D), generator=gen).to(dev)
    with torch.inference_mode():
        single_y, single_g = spmm(op, xd), spmm(op.T, w)
        single_ms = time_cuda(lambda: spmm(op, xd), iters=DIST_ITERS)
    rows, plans, launches = [], {}, {"bucket_spmm": {}, "panel_spmm": {}}
    for name, kw in DIST_PLANS:
        row, plans[name], counts = dist_plan_case(name, kw, a_hat, mesh, xd, w, single_y,
                                                  single_g)
        rows.append(row)
        launches[row["kernel"]][name] = counts
    gcn_rows = []
    for name in DIST_GCN_PLANS:
        impl = "panels" if name == "P3" else "auto"
        with torch.inference_mode():
            got, counts = counted(lambda: dist_gcn_apply(model, plans[name], x, mesh, impl=impl))
            err = rel_err(got, logits)
            kname = dist_kernel(impl)
            if (err > MAIN_PATH_REL_TOL or got.shape != logits.shape
                    or counts != {kname: 3 * DIST_SHARDS}):
                raise AssertionError(f"dist_gcn_apply on {name}: rel err {err}, launches {counts}")
            ms = time_cuda(lambda: dist_gcn_apply(model, plans[name], x, mesh, impl=impl),
                           iters=DIST_ITERS)
        launches[kname][f"gcn_{name}"] = counts[kname]
        gcn_rows.append({"plan": name, "impl": impl, "launches": counts,
                         "logits_rel_err_vs_single": float(f"{err:.3e}"),
                         "forward_ms": round(ms, 4)})
    train, counts = dist_train_step(plans["P1"], mesh, model, x, y)
    launches["bucket_spmm"]["train_step_P1"] = counts["bucket_spmm"]
    rank = dist_rank_form(a_hat, xd, w)
    return dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", n_nodes=cfg.n_nodes,
                nnz=a_hat.nnz, shards=DIST_SHARDS, mesh=f"ShardMesh(['cuda:0'] * {DIST_SHARDS})",
                d=DIST_D, single_operator_spmm_ms=round(single_ms, 4), plans=rows,
                gcn=gcn_rows, dims=GCN_DIMS, train_step_P1=train, rank_form=rank,
                seconds=round(time.perf_counter() - t_phase, 2)), launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel_errs(got: dict, want: dict, what: str, tol: float = MAIN_PATH_REL_TOL) -> dict:
    """Max-relative error of each named tensor against its counterpart;
    raises above ``tol`` or on a non-finite value."""
    errs = {k: rel_err(got[k].detach(), want[k].detach()) for k in want}
    finite = all(bool(torch.isfinite(got[k]).all()) for k in want)
    if not finite or max(errs.values()) > tol:
        raise AssertionError(f"{what}: rel errs {errs}, finite {finite}")
    return {k: float(f"{v:.3e}") for k, v in errs.items()}


def peak_mib(fn) -> tuple:
    """fn()'s result and the device memory it took above what was held."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, round((torch.cuda.max_memory_allocated() - base) / 2**20, 1)


def times(fn, iters: int = PAR_ITERS) -> dict:
    return {"ms": round(time_cuda(fn, iters=iters), 4), "wall_ms": round(wall_ms(fn, iters=iters), 4)}


def launcher_first_loss(graph: str) -> float:
    """The example's first loss through the launcher: one rank, NCCL on
    cuda:0 (world size 1), one step."""
    cmd = [sys.executable, "-m", "of_spmm_tpu_torch.distributed.launch", "--nproc_per_node",
           "1", "--master_port", str(free_port()), "-m", "of_spmm_tpu_torch.examples.train_dist",
           "--graph", graph, "--steps", "1"]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    found = re.findall(r"step\s+0\s+loss ([0-9.]+)", proc.stdout)
    if proc.returncode != 0 or len(found) != 1:
        raise AssertionError(f"train_dist through the launcher: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return float(found[0])


def train_dist_phase(graph: str, a_hat: CSR, cfg, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """The distributed training example on ``graph`` (a_hat its normalized
    adjacency, x and y its features and labels): its plan (partition_rows
    into TRAIN_DIST_SHARDS, check_consistent), its GCN (hidden 32, seed 0)
    and its loop (examples/train_dist.py ``train``) on
    ShardMesh(["cuda:0"] * S): the first step's loss and grads against
    the plain step (dist_train_step), TRAIN_DIST_STEPS steps with
    bucket_spmm's launches held exactly and the losses finite and
    falling, then ``main`` through the launcher at NCCL world size 1
    against the shard mesh at S = 1. Returns (the fields, the loop's
    launches)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    S = TRAIN_DIST_SHARDS
    mesh = ShardMesh([dev] * S)
    t0 = time.perf_counter()
    plan = partition_rows(a_hat, S)
    check_consistent(plan, "row-partition plan")
    t_plan = time.perf_counter() - t0
    dims = (cfg.feature_dim, train_dist.HIDDEN, cfg.n_classes)

    def model_of():
        return GCN(dims, generator=torch.Generator().manual_seed(0))

    first, _ = dist_train_step(plan, mesh, model_of(), x, y)
    model = model_of()
    per_step = (2 * len(model.layers) - 1) * S
    losses, launches = counted(lambda: train_dist.train(model, plan, mesh, x, y,
                                                        TRAIN_DIST_STEPS, log_every=0))
    losses = losses.cpu()
    want = {"bucket_spmm": per_step * TRAIN_DIST_STEPS}
    if launches != want or not torch.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"train_dist loop: launches {launches} (expected {want}), "
                             f"losses {losses.tolist()}")
    rank_loss = launcher_first_loss(graph)
    one = train_dist.train(model_of(), partition_rows(a_hat, 1), ShardMesh([dev]), x, y, 1,
                           log_every=0)
    rank_err = abs(rank_loss - float(one[0])) / abs(float(one[0]))
    if rank_err > MAIN_PATH_REL_TOL:
        raise AssertionError(f"train_dist launcher loss {rank_loss} vs the shard mesh at S = 1 "
                             f"{float(one[0])}")
    return dict(graph=f"{graph} (synthetic, symmetrized, self-loops)", shards=S,
                mesh=f"ShardMesh(['cuda:0'] * {S})", dims=dims, lr=train_dist.LR,
                halo_fraction=round(plan.halo_fraction, 4), plan_seconds=round(t_plan, 3),
                first_step=first, steps=TRAIN_DIST_STEPS,
                losses=[round(float(v), 6) for v in losses],
                bucket_spmm_per_step=per_step, launches=launches,
                launcher={"backend": "nccl", "world_size": 1, "first_loss": rank_loss,
                          "shard_mesh_s1_first_loss": round(float(one[0]), 6),
                          "rel_err": float(f"{rank_err:.3e}")},
                seconds=round(time.perf_counter() - t_phase, 2)), launches


def attention_grads(mod, dense, x: torch.Tensor, fn, causal: bool) -> dict:
    """Parameter grads of sum(y * r) through a sharded apply and through
    the dense module, held within MAIN_PATH_REL_TOL."""
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(x.device)
    for m in (mod, dense):
        m.zero_grad(set_to_none=True)
    (fn(x) * r).sum().backward()
    (dense(x, is_causal=causal) * r).sum().backward()
    got = {n: p.grad for n, p in mod.named_parameters()}
    want = {n: p.grad for n, p in dense.named_parameters()}
    return rel_errs(got, want, f"{type(mod).__name__} grads")


def parallel_attention_phase(gen) -> dict:
    """Ulysses (SequenceParallelAttention) and the ring (RingAttention) at
    BERT-base's attention width, float32, on PAR_SHARDS shards of cuda:0,
    causal and not, against the dense MultiheadAttention with the same
    parameters; grads for Ulysses non-causal and the ring causal; then
    the ring alone at B = 1, T = RING_LONG_SEQ, causal, beside the dense
    MultiheadAttention, with the peak memory of each."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    E, H, S = PAR_EMBED, PAR_HEADS, PAR_SHARDS
    x = torch.randn((PAR_ATTN_BATCH, PAR_ATTN_SEQ, E), generator=gen).to(dev)
    rows = []
    for cls, name in ((SequenceParallelAttention, "sp"), (RingAttention, "ring")):
        mod = cls(E, H, generator=torch.Generator().manual_seed(3))
        dense = MultiheadAttention(E, H)
        dense.load_state_dict(mod.state_dict())
        mesh = ShardMesh([dev] * S, axis_names=(name,))
        for causal in (False, True):
            fn = mod.make_sharded_apply(mesh, name, is_causal=causal)
            with torch.inference_mode():
                err = rel_errs({"y": fn(x)}, {"y": dense(x, is_causal=causal)},
                               f"{name} causal={causal}")["y"]
                row = {"module": cls.__name__, "causal": causal, "rel_err_vs_dense": err,
                       **times(lambda: fn(x)),
                       "dense": times(lambda: dense(x, is_causal=causal))}
            if causal == (name == "ring"):
                row["grad_rel_err_vs_dense"] = attention_grads(mod, dense, x, fn, causal)
            rows.append(row)
    ring = RingAttention(E, H, generator=torch.Generator().manual_seed(4))
    dense = MultiheadAttention(E, H)
    dense.load_state_dict(ring.state_dict())
    xl = torch.randn((1, RING_LONG_SEQ, E), generator=gen).to(dev)
    fn = ring.make_sharded_apply(ShardMesh([dev] * S, axis_names=("ring",)), "ring",
                                 is_causal=True)
    with torch.inference_mode():
        got, ring_mib = peak_mib(lambda: fn(xl))
        want, dense_mib = peak_mib(lambda: dense(xl, is_causal=True))
        err = rel_errs({"y": got}, {"y": want}, "ring long")["y"]
        long = {"B": 1, "T": RING_LONG_SEQ, "causal": True, "rel_err_vs_dense": err,
                "ring_peak_mib": ring_mib, "dense_peak_mib": dense_mib,
                "ring": times(lambda: fn(xl), iters=5),
                "dense": times(lambda: dense(xl, is_causal=True), iters=5)}
    return dict(embed_dim=E, heads=H, batch=PAR_ATTN_BATCH, seq=PAR_ATTN_SEQ, dtype="float32",
                tf32=torch.backends.cuda.matmul.allow_tf32, shards=S,
                mesh=f"ShardMesh(['cuda:0'] * {S})", rows=rows, ring_long=long,
                seconds=round(time.perf_counter() - t_phase, 2))


class ArgmaxReplay:
    """Holds MoE routing choices (``torch.argmax`` in top_k_dispatch) of
    one run fixed for another: the sharded layer's gate GEMM runs per
    shard and the per-shard reference's on each block, so a token whose
    top two gate logits lie within float32 rounding may pick the other
    expert. ``record()`` keeps each call's choices; ``replay(split)``
    returns them in the reference's order (block b, choice k is call
    b * top_k + k, sliced from the sharded run's (S, T/S) choices);
    ``flips`` counts the tokens whose own choice differed."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def _patched(self, fn):
        orig = torch.argmax
        torch.argmax = fn
        try:
            yield self
        finally:
            torch.argmax = orig

    def record(self):
        orig = torch.argmax

        def recording(t, *args, **kwargs):
            out = orig(t, *args, **kwargs)
            self.calls.append(out.detach())
            return out
        return self._patched(recording)

    def replay(self, top_k: int):
        calls = iter(range(len(self.calls) * self.calls[0].shape[0]))

        def replaying(t, *args, **kwargs):
            j = next(calls)
            return self.calls[j % top_k][j // top_k]
        return self._patched(replaying)

    def flips(self, own: "ArgmaxReplay", top_k: int) -> int:
        mine = torch.stack(self.calls)  # (top_k, S, T/S)
        theirs = torch.stack([torch.stack(own.calls[k::top_k]) for k in range(top_k)])
        return int((mine != theirs).sum())


def parallel_mlp_phase(gen) -> dict:
    """The TP MLP at BERT-base's width (768 -> 3072 -> 768, x (8, 512,
    768)) on PAR_SHARDS shards and on (2, 2) dp x tp against the
    single-device block, forward and grads; MoELayer at Switch-Base-8's
    expert width (D 768, F 3072, 8 experts, top-2, capacity factor 1.25,
    MOE_TOKENS tokens) on PAR_SHARDS shards against the per-shard apply
    with the sharded run's routing replayed (and the flipped tokens
    counted)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    D, Fh, S = PAR_EMBED, PAR_FFN, PAR_SHARDS
    params = init_tp_mlp(D, Fh, generator=torch.Generator().manual_seed(5))
    x = torch.randn((PAR_ATTN_BATCH, PAR_ATTN_SEQ, D), generator=gen).to(dev)
    r = torch.randn(x.shape, generator=gen).to(dev)

    def single(p):
        return gelu(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]

    ref = {k: v.clone().requires_grad_() for k, v in params.items()}
    y_ref = single(ref)
    (y_ref * r).sum().backward()
    tp_rows = []
    for shape, names, dp in (((S,), ("tp",), None), ((2, 2), ("dp", "tp"), "dp")):
        mesh = ShardMesh([dev] * S, shape=shape, axis_names=names)
        fwd = make_tp_mlp(mesh, dp_axis=dp)
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        y = fwd(shard_tp_mlp(p, mesh), x)
        err = rel_errs({"y": y}, {"y": y_ref}, f"tp mlp {names}")
        (y * r).sum().backward()
        gerr = rel_errs({k: v.grad for k, v in p.items()}, {k: v.grad for k, v in ref.items()},
                        f"tp mlp grads {names}")
        with torch.inference_mode():
            sharded = shard_tp_mlp(params, mesh)
            tp_rows.append({"mesh": dict(zip(names, shape)), "rel_err_vs_single": err["y"],
                            "grad_rel_err_vs_single": gerr, **times(lambda: fwd(sharded, x))})
    with torch.inference_mode():
        single_t = times(lambda: single(params))

    moe = MoELayer(D, MOE_EXPERTS, Fh, top_k=MOE_TOPK, capacity_factor=MOE_CF,
                   generator=torch.Generator().manual_seed(6))
    xm = torch.randn((MOE_TOKENS, D), generator=gen).to(dev)
    mesh = ShardMesh([dev] * S, axis_names=("ep",))
    fn = moe.make_sharded_apply(mesh, return_aux=True)
    blocks = xm.chunk(S)
    sharded_routes, own_routes = ArgmaxReplay(), ArgmaxReplay()
    with torch.inference_mode():
        with sharded_routes.record():
            y, aux = fn(xm)
        with sharded_routes.replay(MOE_TOPK):
            want = torch.cat([moe.apply(b) for b in blocks])
        with own_routes.record():
            own = torch.cat([moe.apply(b) for b in blocks])
        err = rel_errs({"y": y}, {"y": want}, "moe sharded vs per-shard (routes replayed)")
        moe_row = {"tokens": MOE_TOKENS, "experts": MOE_EXPERTS, "top_k": MOE_TOPK,
                   "capacity_factor": MOE_CF,
                   "capacity_per_shard": expert_capacity(MOE_TOKENS // S, MOE_EXPERTS, MOE_TOPK,
                                                         MOE_CF),
                   "rel_err_vs_per_shard_replayed": err["y"],
                   "rel_err_vs_per_shard_own_routes": float(f"{rel_err(y, own):.3e}"),
                   "flipped_choices": sharded_routes.flips(own_routes, MOE_TOPK),
                   "aux": float(aux), **times(lambda: fn(xm)),
                   "per_shard_apply": times(lambda: [moe.apply(b) for b in blocks])}
    return dict(tp={"d_model": D, "d_hidden": Fh, "x": list(x.shape), "rows": tp_rows,
                    "single_device": single_t},
                moe=moe_row, shards=S, seconds=round(time.perf_counter() - t_phase, 2))


def parallel_pipeline_phase(gen) -> dict:
    """BERT-base's 12 encoder blocks in PIPE_STAGES stages of 3 on
    ShardMesh(["cuda:0"] * PIPE_STAGES, axis "stage"), PIPE_MICRO micro-
    batches of (1, 512, 768): the GPipe forward (pipeline_apply) against
    the sequential stack, and one 1F1B step's loss and grads
    (pipeline_train_step_1f1b, mean squared error to a seeded target)
    against sequential autograd."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    model = bert_base(generator=torch.Generator().manual_seed(8))
    per = model.num_layers // PIPE_STAGES
    stages = [torch.nn.Sequential(*model.blocks[s * per:(s + 1) * per])
              for s in range(PIPE_STAGES)]
    pm = PipelineModule(stages, axis="stage")
    mesh = ShardMesh([dev] * PIPE_STAGES, axis_names=("stage",))
    x = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, model.embed_dim), generator=gen).to(dev)
    tgt = torch.randn(x.shape, generator=gen).to(dev)

    def sequential(m):
        h = x[m]
        for st in stages:
            h = st(h)
        return h

    with torch.inference_mode():
        stacked = pm.init()
        y = pm.apply(stacked, x, mesh)
        want = torch.stack([sequential(m) for m in range(PIPE_MICRO)])
        fwd_err = rel_errs({"y": y}, {"y": want}, "gpipe vs sequential")["y"]
        gpipe_t = times(lambda: pm.apply(stacked, x, mesh), iters=5)
        seq_t = times(lambda: [sequential(m) for m in range(PIPE_MICRO)], iters=5)

    def mse(a, t):
        return ((a - t) ** 2).mean()

    stacked = {k: v.detach() for k, v in pm.init().items()}
    loss, grads = pipeline_train_step_1f1b(pm.stage_fn(), mse, stacked, x, tgt, mesh)
    model.zero_grad(set_to_none=True)
    want_loss = sum(mse(sequential(m), tgt[m]) for m in range(PIPE_MICRO)) / PIPE_MICRO
    want_loss.backward()
    want_grads = stack_stage_params([{k: p.grad for k, p in st.named_parameters()}
                                     for st in stages])
    loss_err = rel_errs({"loss": loss.reshape(1)}, {"loss": want_loss.detach().reshape(1)},
                        "1f1b loss")["loss"]
    gerr = rel_errs(grads, want_grads, "1f1b grads")
    step_t = times(lambda: pipeline_train_step_1f1b(pm.stage_fn(), mse, stacked, x, tgt, mesh),
                   iters=3)

    def sequential_step():
        model.zero_grad(set_to_none=True)
        (sum(mse(sequential(m), tgt[m]) for m in range(PIPE_MICRO)) / PIPE_MICRO).backward()
    return dict(model="bert_base blocks (12 layers, width 768, 12 heads, MLP 3072; seeded)",
                stages=PIPE_STAGES, blocks_per_stage=per, micro_batches=PIPE_MICRO,
                micro_batch=[1, PIPE_SEQ, model.embed_dim], mesh=f"ShardMesh(['cuda:0'] * "
                f"{PIPE_STAGES}, axis 'stage')", gpipe_rel_err_vs_sequential=fwd_err,
                gpipe=gpipe_t, sequential=seq_t, f1b1_loss=float(loss),
                f1b1_loss_rel_err=loss_err, f1b1_grad_rel_err_max=max(gerr.values()),
                f1b1_step=step_t, sequential_autograd_step=times(sequential_step, iters=3),
                f1b1_cycles=PIPE_MICRO + 2 * (PIPE_STAGES - 1),
                seconds=round(time.perf_counter() - t_phase, 2))


def reshard_sweep(mesh, x: torch.Tensor) -> dict:
    """Every S0 / S1 / B / P transition of ``x`` on ``mesh`` (each mesh
    axis), each result's whole value equal to x bit for bit."""
    atoms = ["S0", "S1", "B", "P"]
    sbps = [(a,) for a in atoms] if len(mesh.shape) == 1 else list(itertools.product(atoms,
                                                                                     atoms))
    t0 = time.perf_counter()
    placed = {s: to_global(x, s, mesh) for s in sbps}
    for s in sbps:
        for d in sbps:
            if not torch.equal(reshard(placed[s], d).full(), x):
                raise AssertionError(f"reshard {s} -> {d} on {mesh.shape} changed the value")
    torch.cuda.synchronize()
    return {"mesh": list(mesh.shape), "transitions": len(sbps) ** 2,
            "seconds": round(time.perf_counter() - t0, 3)}


def parallel_ddp_global_phase(gen) -> dict:
    """ddp_train_step with torch.optim.SGD on a BERT-base classifier
    (bert_base(n_classes=2), global batch DDP_BATCH, T = DDP_SEQ) on
    PAR_SHARDS shards against the single-device step from the same
    weights; every S / B / P transition of reshard on a RESHARD_SHAPE
    tensor over 1-D PAR_SHARDS and (2, 2); the rank form of one TP and one
    ring case over an NCCL group of world size 1 against the shard mesh
    at S = 1."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    S = PAR_SHARDS
    models = [bert_base(n_classes=2, generator=torch.Generator().manual_seed(9))
              for _ in range(2)]
    tokens = torch.randint(0, models[0].vocab_size, (DDP_BATCH, DDP_SEQ), generator=gen).to(dev)
    labels = torch.randint(0, 2, (DDP_BATCH,), generator=gen).to(dev)
    mesh = ShardMesh([dev] * S)
    opts = [torch.optim.SGD(m.parameters(), lr=DDP_LR) for m in models]
    ddp_step = ddp_train_step(lambda t, l: F.cross_entropy(models[0](t), l), opts[0], mesh)
    loss = ddp_step(tokens, labels)
    opts[1].zero_grad(set_to_none=True)
    want_loss = F.cross_entropy(models[1](tokens), labels)
    want_loss.backward()
    want_loss = want_loss.detach()
    opts[1].step()
    named = [dict(m.named_parameters()) for m in models]
    gerr = rel_errs({k: p.grad for k, p in named[0].items()},
                    {k: p.grad for k, p in named[1].items()}, "ddp grads")
    perr = rel_errs(named[0], named[1], "ddp params")

    def single_step():
        opts[1].zero_grad(set_to_none=True)
        F.cross_entropy(models[1](tokens), labels).backward()
        opts[1].step()
    ddp = {"model": "bert_base(n_classes=2), seeded", "batch": DDP_BATCH, "seq": DDP_SEQ,
           "optimizer": f"torch.optim.SGD(lr={DDP_LR})", "loss": float(loss),
           "loss_rel_err": abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
           "grad_rel_err_max": max(gerr.values()), "param_rel_err_max": max(perr.values()),
           **times(lambda: ddp_step(tokens, labels), iters=5),
           "single_device_step": times(single_step, iters=5)}
    if ddp["loss_rel_err"] > MAIN_PATH_REL_TOL:
        raise AssertionError(f"ddp loss {float(loss)} vs single {float(want_loss)}")
    del models, opts, named

    xr = torch.randn(RESHARD_SHAPE, generator=gen).to(dev)
    sweeps = [reshard_sweep(ShardMesh([dev] * S), xr),
              reshard_sweep(ShardMesh([dev] * S, shape=(2, 2), axis_names=("a", "b")), xr)]
    mesh = ShardMesh([dev] * S)
    hops = {}
    for src, dst, what in (("S0", "B", "all_gather"), ("S0", "S1", "all_to_all"),
                           ("P", "B", "all_reduce"), ("P", "S0", "reduce_scatter"),
                           ("B", "S0", "slice")):
        g = to_global(xr, src, mesh)
        hops[f"{src}->{dst} ({what})"] = round(time_cuda(lambda: reshard(g, dst)), 4)

    # the rank form at NCCL world size 1 against the shard mesh at S = 1
    params = init_tp_mlp(PAR_EMBED, PAR_FFN, generator=torch.Generator().manual_seed(10))
    xt = torch.randn((2, 128, PAR_EMBED), generator=gen).to(dev)
    ring = RingAttention(PAR_EMBED, PAR_HEADS, generator=torch.Generator().manual_seed(11))
    cases = {"tp": lambda m: make_tp_mlp(m, "x")(shard_tp_mlp(params, m, "x"), xt),
             "ring": lambda m: ring.make_sharded_apply(m, "x", is_causal=True)(xt)}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(backend="nccl", init_method=f"file://{tmp}/store", world_size=1,
                               rank=0)
        try:
            backend = torch.distributed.get_backend()
            with torch.inference_mode():
                ranked = {k: f(RankGroup()) for k, f in cases.items()}
        finally:
            distributed.destroy()
    if backend != "nccl":
        raise AssertionError(f"rank form: backend {backend}, expected nccl")
    with torch.inference_mode():
        meshed = {k: f(ShardMesh([dev])) for k, f in cases.items()}
    rank = {"backend": backend, "world_size": 1,
            "rel_err_vs_shard_mesh": rel_errs(ranked, meshed, "rank form vs shard mesh")}
    return dict(ddp=ddp, reshard=sweeps, reshard_shape=list(RESHARD_SHAPE), reshard_ms=hops,
                rank_form=rank, seconds=round(time.perf_counter() - t_phase, 2))


class PoolArgmax:
    """Holds each 2-D max pool's argmax of one forward fixed for another,
    as ReluMasks holds the ReLU branches: two forwards in float32 and
    float64 may disagree on which of a window's two largest values (within
    rounding of each other) is the largest, and the window's gradient then
    goes to the other one. Under ``record()`` F.max_pool2d keeps each
    call's argmax, its windows' least gap between the largest and the
    second largest value where the largest is positive (``margin()``) and
    the count of such windows whose two are equal (``ties``); under
    ``replay()`` its i-th call takes argmax_i's elements."""

    def __init__(self):
        self.argmax, self.gaps, self.ties = [], [], 0

    @contextlib.contextmanager
    def _patched(self, fn):
        orig = F.max_pool2d
        F.max_pool2d = fn
        try:
            yield self
        finally:
            F.max_pool2d = orig

    def record(self):
        orig = F.max_pool2d

        def recording(h, kernel_size, stride=None, padding=0):
            out, idx = orig(h, kernel_size, stride, padding, return_indices=True)
            self.argmax.append(idx)
            k, s, p = (tuple(v) if isinstance(v, (tuple, list)) else (v, v)
                       for v in (kernel_size, stride or kernel_size, padding))
            win = F.unfold(F.pad(h.detach(), (p[1], p[1], p[0], p[0]), value=-float("inf")),
                           k, stride=s)
            top = win.reshape(h.shape[0], h.shape[1], k[0] * k[1], -1).topk(2, dim=2).values
            gap = (top[:, :, 0] - top[:, :, 1])[top[:, :, 0] > 0]
            self.ties += int((gap == 0).sum())
            self.gaps.append(gap[gap > 0].min())
            return out
        return self._patched(recording)

    def replay(self):
        it = iter(self.argmax)

        def replaying(h, kernel_size, stride=None, padding=0):
            idx = next(it).to(h.device)
            return h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return self._patched(replaying)

    def flips(self, other: "PoolArgmax") -> int:
        return sum(int((a != b).sum()) for a, b in zip(self.argmax, other.argmax))

    def margin(self) -> float:
        return float(f"{float(min(g.cpu() for g in self.gaps)):.3e}")


def forward_macs(model: torch.nn.Module, x: torch.Tensor) -> int:
    """Multiply-adds of one forward of ``model`` on ``x`` per sample,
    counted from the layer shapes: each convolution's output elements
    times its weight's (in / groups) k...k, each Linear's outputs times
    its inputs."""
    total, hooks = [0], []

    def conv_hook(mod, _, out):
        total[0] += out.numel() * (mod.w.numel() // mod.w.shape[0])

    def linear_hook(mod, _, out):
        total[0] += out.numel() * mod.w.shape[0]

    for mod in model.modules():
        if isinstance(mod, (onn.Conv1d, onn.Conv2d, onn.Conv3d)):
            hooks.append(mod.register_forward_hook(conv_hook))
        elif isinstance(mod, onn.Linear):
            hooks.append(mod.register_forward_hook(linear_hook))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0] // x.shape[0]


def vision_figures(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor, macs: int,
                   peak_fp32: float, train_kw: dict) -> dict:
    """Eval forward and one training step (forward with ``train_kw``,
    cross_entropy, backward, SGD with momentum) on the card: ms (CUDA
    events), wall ms, images/s and peak MiB above what was held, beside
    the FLOP bound at the fp32 peak (a step counted as 3x the forward's
    multiply-adds). Trains ``model`` meanwhile."""
    b = x.shape[0]
    fields = {"forward_macs_per_image": macs}
    with torch.inference_mode():
        fwd = lambda: model(x)  # noqa: E731
        _, fields["eval_peak_mib"] = peak_mib(fwd)
        ms, wall = time_cuda(fwd, iters=VISION_ITERS), wall_ms(fwd, iters=VISION_ITERS)
    bound = 2 * macs * b / peak_fp32 * 1e3
    fields.update(eval_ms=round(ms, 4), eval_wall_ms=round(wall, 4),
                  eval_images_per_s=round(b / (ms / 1e3), 1), eval_bound_ms=round(bound, 4),
                  eval_fraction_of_fp32_peak=round(bound / ms, 4))
    opt = optim.sgd(VISION_LR, momentum=VISION_MOMENTUM).init(model.parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        cross_entropy(model(x, **train_kw), y).backward()
        opt.step()

    _, fields["train_step_peak_mib"] = peak_mib(step)
    ms, wall = time_cuda(step, iters=VISION_ITERS), wall_ms(step, iters=VISION_ITERS)
    fields.update(train_step_ms=round(ms, 4), train_step_wall_ms=round(wall, 4),
                  train_images_per_s=round(b / (ms / 1e3), 1),
                  train_step_bound_ms=round(3 * bound, 4),
                  train_step_fraction_of_fp32_peak=round(3 * bound / ms, 4))
    return fields


def eval_vs_float64(model: torch.nn.Module, x: torch.Tensor, what: str) -> tuple:
    """The eval logits on the card and their max-relative error against
    the same module and weights in float64 on the card."""
    ref = copy.deepcopy(model).double()
    with torch.inference_mode():
        logits = model(x)
        want = ref(x.double())
    del ref
    if logits.shape != (x.shape[0], VISION_CLASSES) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what} logits {tuple(logits.shape)} not finite or wrong shape")
    err = rel_err(logits.double(), want)
    if err > MAIN_PATH_REL_TOL:
        raise AssertionError(f"{what} eval logits vs float64: rel err {err}")
    return logits, float(f"{err:.3e}")


def resnet_stages(model) -> list:
    """ResNet's forward as (name, fn(h, train)) stages: stem, each block,
    then the pooled head (forward runs the same calls in the same order)."""
    stages = [("stem", model.stem)]
    stages += [(f"block_{i}", getattr(model, f"block_{i}")) for i in range(model.n_blocks)]
    return stages + [("head", lambda h, train: model.classify(h))]


def resnet_stage_check(m32, m64, stages32: list, x: torch.Tensor, y: torch.Tensor,
                       relu: ReluMasks, pool: PoolArgmax) -> dict:
    """Each stage of the float32 step held against the same stage in
    float64 fed the float32 run's own stage input and output gradient
    (the head: its loss), the float32 run's ReLU branches and max-pool
    argmaxes replayed: its output, its input's gradient, its parameters'
    gradients and its BatchNorm buffers, at MAIN_PATH_REL_TOL. Leaves
    every stage's float64 gradients in ``m64``. Returns the worst error
    of each kind and where it lies."""
    p32, b32 = dict(m32.named_parameters()), dict(m32.named_buffers())
    worst = {}

    def note(kind: str, name: str, err: float) -> None:
        if err > worst.get(kind, (0.0, ""))[0]:
            worst[kind] = (err, name)

    m64.zero_grad(set_to_none=True)
    with relu.replay(), pool.replay():
        for (name, fn), (h_in, h_out) in zip(resnet_stages(m64), stages32):
            # a leaf input: the backward reaches this stage's parameters only
            inp = (x if h_in is None else h_in.detach()).double().requires_grad_(h_in is not None)
            out = fn(inp, True)
            if name == "head":
                loss = cross_entropy(out, y)
                loss.backward()
                note("loss", name,
                     rel_err(h_out.detach().reshape(1).double(), loss.detach().reshape(1)))
            else:
                out.backward(h_out.grad.double())
                note("output", name, rel_err(h_out.detach().double(), out.detach()))
            if h_in is not None:
                note("input_grad", name, rel_err(h_in.grad.double(), inp.grad))
            mine = (f"{name}.", f"{name}_")
            for n, p in m64.named_parameters():
                if n.startswith(mine):
                    note("param_grad", n, rel_err(p32[n].grad.double(), p.grad))
            for n, b in m64.named_buffers():
                if n.startswith(mine):
                    note("bn_buffer", n, rel_err(b32[n].double(), b))
    bad = {k: v for k, v in worst.items() if v[0] > MAIN_PATH_REL_TOL}
    if bad:
        raise AssertionError(f"ResNet-50 train step, stage by stage vs float64: {bad}")
    return {k: {"max_rel_err": float(f"{v[0]:.3e}"), "at": v[1]} for k, v in worst.items()}


def resnet_main_path(gen, peak_fp32: float) -> dict:
    """ResNet-50 (resnet50(), 1,000 classes, uncut, seeded weights) on
    RESNET_BATCH x 3 x 224 x 224 in float32: the eval logits against
    float64; one training step (forward with train=True, cross_entropy,
    backward, optim.sgd with momentum), run stage by stage (stem, 16
    blocks, head; ResNet.forward's calls) with the float32 run's ReLU
    branches and max-pool argmaxes recorded (ReluMasks, PoolArgmax). Each
    stage is held against itself in float64 on the float32 run's stage
    input and output gradient (``resnet_stage_check``): every gradient,
    BatchNorm buffer, stage output and the loss at MAIN_PATH_REL_TOL, and
    the parameters after SGD against SGD on those float64 gradients. The
    whole step against the float64 step from the same weights and input
    (branches replayed) is reported beside it, not held: train-mode
    BatchNorm compounds float32 rounding about 1.3x a block, so the last
    blocks' grads end 1.2e-4 off float64 whatever computes them. The
    flips against float64's own branches and the margins are reported;
    then the eval and step times."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    model = resnet50(generator=torch.Generator().manual_seed(11))
    x = torch.randn((RESNET_BATCH, 3, VISION_SIZE, VISION_SIZE), generator=gen).to(dev)
    y = torch.randint(0, VISION_CLASSES, (RESNET_BATCH,), generator=gen).to(dev)
    _, eval_err = eval_vs_float64(model, x, "ResNet-50")

    m32, e2e64, local64, own64 = (copy.deepcopy(model) for _ in range(4))
    for m in (e2e64, local64, own64):
        m.double()
    relu, pool = ReluMasks(), PoolArgmax()
    stages32, h = [], None
    m32.zero_grad(set_to_none=True)
    with relu.record(), pool.record():
        for _, fn in resnet_stages(m32):
            out = fn(x if h is None else h, True)
            out.retain_grad()
            stages32.append((h, out))
            h = out
        loss32 = cross_entropy(h, y)
        stages32[-1] = (stages32[-1][0], loss32)
    loss32.backward()
    got = (loss32.detach(), {n: p.grad.detach().clone() for n, p in m32.named_parameters()})
    stage_errs = resnet_stage_check(m32, local64, stages32, x, y, relu, pool)

    # float64 on its own branches: the flips, and how far each stage's
    # output has drifted from float32's
    own_relu, own_pool = ReluMasks(), PoolArgmax()
    drift, h = [], x.double()
    with torch.no_grad(), own_relu.record(), own_pool.record():
        for (name, fn), (_, out32) in zip(resnet_stages(own64)[:-1], stages32):
            h = fn(h, True)
            drift.append(float(f"{rel_err(out32.detach().double(), h):.2e}"))
    flips = {"relu_flips": relu.flips(own_relu), "relu_margin": relu.margin(),
             "maxpool_flips": pool.flips(own_pool), "maxpool_margin": pool.margin(),
             "maxpool_positive_ties": pool.ties, "train_stage_output_drift_vs_float64": drift}
    del own64, own_relu, own_pool, stages32, h, out
    with relu.replay(), pool.replay():
        want = grads_of(e2e64, lambda: cross_entropy(e2e64(x.double(), train=True), y))
    del relu, pool
    e2e = {"loss": rel_err(got[0].reshape(1).double(), want[0].reshape(1))}
    e2e.update({n: rel_err(g.double(), want[1][n]) for n, g in got[1].items()})
    worst = max((k for k in e2e if k != "loss"), key=e2e.get)
    buf = {n: rel_err(b.double(), dict(e2e64.named_buffers())[n]) for n, b in m32.named_buffers()}
    worst_buf = max(buf, key=buf.get)
    for m in (m32, local64, e2e64):
        optim.sgd(VISION_LR, momentum=VISION_MOMENTUM).init(m.parameters()).step()
    step_errs = param_errs(m32, local64, "ResNet-50 parameters after SGD vs float64 (stage "
                           "grads)", MAIN_PATH_REL_TOL)
    e2e_step = rel_errs(dict(m32.named_parameters()), dict(e2e64.named_parameters()),
                        "ResNet-50 parameters after SGD vs float64 (whole step)", float("inf"))
    worst_step = max(e2e_step, key=e2e_step.get)
    loss = float(got[0])
    del m32, local64, e2e64, got, want
    macs = forward_macs(model, x[:1])
    figs = vision_figures(model, x, y, macs, peak_fp32, {"train": True})
    return dict(model="resnet50 (Bottleneck (3, 4, 6, 3), width 64, 1000 classes, uncut)",
                params=onn.param_count(model), batch=RESNET_BATCH,
                input=[3, VISION_SIZE, VISION_SIZE], dtype="float32", tf32=False,
                step="forward(train=True) + cross_entropy + backward + "
                     f"sgd(lr={VISION_LR}, momentum={VISION_MOMENTUM})",
                eval_logits_rel_err_vs_float64=eval_err, loss=loss,
                train_stage_rel_err_vs_float64=stage_errs,
                train_params_after_sgd_vs_float64=step_errs,
                train_end_to_end_rel_err_vs_float64={
                    "loss": float(f"{e2e['loss']:.3e}"), "worst_grad": worst,
                    "worst_grad_rel_err": float(f"{e2e[worst]:.3e}"),
                    "grads_above_1e-4": sum(1 for k, v in e2e.items() if k != "loss" and v > 1e-4),
                    "worst_bn_buffer": worst_buf,
                    "worst_bn_buffer_rel_err": float(f"{buf[worst_buf]:.3e}"),
                    "worst_param_after_sgd": worst_step,
                    "worst_param_after_sgd_rel_err": e2e_step[worst_step]},
                **flips, **figs, seconds=round(time.perf_counter() - t_phase, 2))


def vision_models_phase(gen, peak_fp32: float) -> dict:
    """VGG16 and AlexNet (1,000 classes, uncut, seeded weights) on
    VISION_BATCH x 3 x 224 x 224 in float32: the eval logits against
    float64; a train-mode forward with a seeded CUDA generator twice (its
    dropout masks reproducible: the two equal, both off the eval logits)
    and once without a generator (no dropout: the eval logits); then the
    eval and training-step times."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    x = torch.randn((VISION_BATCH, 3, VISION_SIZE, VISION_SIZE), generator=gen).to(dev)
    y = torch.randint(0, VISION_CLASSES, (VISION_BATCH,), generator=gen).to(dev)
    rows = {}
    for seed, (name, make) in enumerate((("vgg16", vgg16), ("alexnet", alexnet)), 12):
        model = make(generator=torch.Generator().manual_seed(seed))
        logits, err = eval_vs_float64(model, x, name)
        with torch.inference_mode():
            a, b = (model(x, train=True, generator=torch.Generator(device=dev).manual_seed(7))
                    for _ in range(2))
            plain = model(x, train=True)
        no_dropout_err = rel_err(plain, logits)
        if not torch.equal(a, b) or rel_err(a, logits) < 1e-3 or no_dropout_err > MAIN_PATH_REL_TOL:
            raise AssertionError(f"{name} dropout: two seeded runs equal {torch.equal(a, b)}, "
                                 f"off eval by {rel_err(a, logits)}; without a generator "
                                 f"{no_dropout_err} off eval")
        rows[name] = {
            "params": onn.param_count(model), "eval_logits_rel_err_vs_float64": err,
            "dropout": {"seeded_runs_equal": True,
                        "rel_change_vs_eval": float(f"{rel_err(a, logits):.3e}"),
                        "no_generator_rel_err_vs_eval": float(f"{no_dropout_err:.3e}")},
            **vision_figures(model, x, y, forward_macs(model, x[:1]), peak_fp32,
                             {"train": True,
                              "generator": torch.Generator(device=dev).manual_seed(8)})}
        del model, logits, a, b, plain
    return dict(models="vgg16 (configuration D), alexnet (torchvision's single tower); 1000 "
                       "classes, uncut", batch=VISION_BATCH, input=[3, VISION_SIZE, VISION_SIZE],
                dtype="float32", tf32=False,
                step="forward(train=True, generator) + cross_entropy + backward + "
                     f"sgd(lr={VISION_LR}, momentum={VISION_MOMENTUM})",
                **rows, seconds=round(time.perf_counter() - t_phase, 2))


def _leaves(out) -> list:
    return [t for o in out for t in _leaves(o)] if isinstance(out, (tuple, list)) else [out]


def nn_module_cases() -> list:
    """(name, make(device, generator), input shapes, forward kwargs): each
    ported module at one size a user would run."""
    return [
        ("lstm", lambda d, g: onn.LSTM(RNN_I, RNN_H, device=d, generator=g),
         [(RNN_T, RNN_B, RNN_I)], {}),
        ("gru", lambda d, g: onn.GRU(RNN_I, RNN_H, device=d, generator=g),
         [(RNN_T, RNN_B, RNN_I)], {}),
        ("conv3d", lambda d, g: onn.Conv3d(16, 32, 3, padding=1, device=d, generator=g),
         [(4, 16, 16, 56, 56)], {}),
        ("conv_transpose2d_stride2", lambda d, g: onn.ConvTranspose2d(
            64, 32, 4, stride=2, padding=1, device=d, generator=g), [(8, 64, 56, 56)], {}),
        ("interpolate_bilinear_x2", lambda d, g: onn.Upsample(2, mode="bilinear"),
         [(8, 64, 56, 56)], {}),
        ("groupnorm", lambda d, g: onn.GroupNorm(32, 256, device=d), [(8, 256, 56, 56)], {}),
        ("instancenorm2d", lambda d, g: onn.InstanceNorm2d(256, affine=True, device=d),
         [(8, 256, 56, 56)], {}),
        ("batchnorm_train", lambda d, g: onn.BatchNorm(256, device=d), [(8, 56, 56, 256)],
         {"train": True}),
    ]


def nn_modules_phase(gen) -> dict:
    """Each ported module of nn/ on the card against the same module (the
    same weights) on the CPU on the same inputs: the outputs, and where
    the module has parameters the gradients of sum(out * cot) with
    respect to them and to the inputs (BatchNorm's updated buffers too),
    at MAIN_PATH_REL_TOL max-relative; the card's forward and forward +
    backward ms."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    rows = {}
    for i, (name, make, shapes, kw) in enumerate(nn_module_cases()):
        host = make("cpu", torch.Generator().manual_seed(20 + i))
        card = copy.deepcopy(host).to(dev)
        xs = [torch.randn(shape, generator=gen) for shape in shapes]
        has_params = any(True for _ in host.parameters())
        results = []
        for mod, inputs in ((host, [x.clone().requires_grad_(has_params) for x in xs]),
                            (card, [x.to(dev).requires_grad_(has_params) for x in xs])):
            out = _leaves(mod(*inputs, **kw))
            got = {f"out{j}": o for j, o in enumerate(out)}
            if has_params:
                cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(j)).to(
                    o.device) for j, o in enumerate(out)]
                sum((o * c).sum() for o, c in zip(out, cots)).backward()
                got.update({f"grad_{n}": p.grad for n, p in mod.named_parameters()})
                got.update({f"grad_input{j}": x.grad for j, x in enumerate(inputs)})
                got.update({f"buffer_{n}": b for n, b in mod.named_buffers()})
            results.append({k: v.detach().cpu() for k, v in got.items()})
        errs = rel_errs(results[1], results[0], f"nn {name} card vs CPU")
        xd = [x.to(dev).requires_grad_(has_params) for x in xs]
        with torch.inference_mode():
            fwd_ms = time_cuda(lambda: card(*[x.detach() for x in xd], **kw), iters=VISION_ITERS)

        def fwd_bwd():
            sum(o.sum() for o in _leaves(card(*xd, **kw))).backward()

        row = {"input": [list(s) for s in shapes], "params": onn.param_count(card),
               "max_rel_err_vs_cpu": max(errs.values()), "worst": max(errs, key=errs.get),
               "compared": sorted(errs), "forward_ms": round(fwd_ms, 4)}
        if has_params:
            row["forward_backward_ms"] = round(time_cuda(fwd_bwd, iters=VISION_ITERS), 4)
        rows[name] = row
        del host, card, results, xd
    return dict(modules=rows, dtype="float32", tf32=False,
                seconds=round(time.perf_counter() - t_phase, 2))


# ---------------------------------------------------------------------------
# The embedding path and the input pipeline (no kernel of the port: the JAX
# package computes them with XLA gathers and scatters and host numpy).
# ---------------------------------------------------------------------------


def power_law_ids(rng, n: int, n_ids: int, exponent: float) -> np.ndarray:
    """n ids in [0, n_ids) with P(id = k) ~ (k + 1)^-exponent (the bounded
    continuous power law's inverse CDF, floored)."""
    u = rng.random(n)
    a = 1.0 - exponent
    ids = np.floor(((n_ids ** a - 1.0) * u + 1.0) ** (1.0 / a)) - 1.0
    return np.minimum(ids, n_ids - 1).astype(np.int64)


def profiled(fn) -> tuple:
    """fn()'s result, its wall seconds (to a synchronize) and the kernel ms
    torch.profiler's device events sum to meanwhile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def sharded_embedding_phase(gen, peak_bw: float) -> dict:
    """ShardedEmbedding(SHARDED_ROWS, SHARDED_DIM) S(0) over SHARDED_SHARDS
    shards of the card, seeded ids (B = SHARDED_BATCH, about
    SHARDED_OUT_OF_RANGE of them negative or >= SHARDED_ROWS): the forward
    against a dense zero-filled lookup of the same table bit for bit, the
    table's grad against the dense lookup's at 1e-5 + 1e-4|p| (touched
    rows; every other row zero in both), one SGD step; forward, forward +
    backward and update ms, peak memory, the forward's byte bound, the
    dense grad's zero-fill, and the same lookup through gather_rows on the
    flattened table (bit-equal; its launches counted apart)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = ShardMesh([str(dev)] * SHARDED_SHARDS)
    emb = ShardedEmbedding(SHARDED_ROWS, SHARDED_DIM)
    t0 = time.perf_counter()
    params = emb.init(torch.Generator().manual_seed(21), mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w = params["weight"].local  # (S, rows, D), a leaf
    table = w.detach().reshape(-1, SHARDED_DIM)  # the same storage, one table
    rng = np.random.default_rng(22)
    ids = rng.integers(0, SHARDED_ROWS, SHARDED_BATCH)
    bad = rng.choice(SHARDED_BATCH, int(SHARDED_OUT_OF_RANGE * SHARDED_BATCH), replace=False)
    half = len(bad) // 2
    ids[bad[:half]] = -rng.integers(1, SHARDED_ROWS, half)
    ids[bad[half:]] = rng.integers(SHARDED_ROWS, 2 * SHARDED_ROWS, len(bad) - half)
    ids_t = torch.from_numpy(ids).to(dev)
    cot = torch.randn((SHARDED_BATCH, SHARDED_DIM), generator=gen).to(dev)
    valid = (ids_t >= 0) & (ids_t < SHARDED_ROWS)
    touched = torch.unique(ids_t[valid])

    def forward():
        with torch.no_grad():
            return emb.apply(params, ids_t, mesh)

    def forward_backward():
        w.grad = None
        (emb.apply(params, ids_t, mesh) * cot).sum().backward()

    (out, launched) = counted(forward)
    want = ref.gather(table, ids_t)
    if launched or not torch.equal(out, want) or out[~valid].any():
        raise AssertionError(f"sharded lookup vs dense zero-filled lookup: bit-equal "
                             f"{torch.equal(out, want)}, launches {launched}")
    # the same lookup through the gather_rows kernel on the flattened table
    ids32 = ids_t.to(torch.int32)
    got, g_launched = counted(lambda: kernels.gather_rows(table, ids32))
    if not torch.equal(got, want) or g_launched != {"gather_rows": 1}:
        raise AssertionError(f"gather_rows on the flattened table: not bit-equal or launches "
                             f"{g_launched}")
    del got, want

    _, launched = counted(forward_backward)
    grad = w.grad.reshape(-1, SHARDED_DIM)
    got_rows = grad[touched].clone()
    got_nonzero = int((grad != 0).any(1).sum())
    del grad
    w.grad = None
    dense = table.detach().requires_grad_()  # the same storage, a leaf of its own
    (gather(dense, ids_t) * cot).sum().backward()
    want_nonzero = int((dense.grad != 0).any(1).sum())
    grad_err = check_close(got_rows, dense.grad[touched], "sharded lookup grad vs dense")
    del dense, got_rows
    if launched or got_nonzero != want_nonzero or got_nonzero > touched.numel():
        raise AssertionError(f"sharded grad: nonzero rows {got_nonzero} vs dense "
                             f"{want_nonzero} ({touched.numel()} touched), launches {launched}")

    forward_backward()
    sample = torch.randint(0, SHARDED_ROWS, (SHARDED_BATCH,), generator=gen).to(dev)
    before, before_sample = table[touched].clone(), table[sample].clone()
    step_want = before.add(w.grad.reshape(-1, SHARDED_DIM)[touched], alpha=-SHARDED_LR)

    def sgd():
        with torch.no_grad():
            w.add_(w.grad, alpha=-SHARDED_LR)

    _, launched = counted(sgd)
    untouched = ~torch.isin(sample, touched)
    if launched or not torch.equal(table[touched], step_want) or not torch.equal(
            table[sample][untouched], before_sample[untouched]):
        raise AssertionError("sharded SGD step: touched rows off or an untouched row changed")
    del before, before_sample, step_want

    fwd_ms = time_cuda(forward, iters=SHARDED_ITERS)
    fb_ms = time_cuda(forward_backward, iters=SHARDED_ITERS)
    sgd_ms = time_cuda(sgd, iters=SHARDED_ITERS)
    w.grad = None
    fill = torch.empty_like(table)
    fill_ms = time_cuda(fill.zero_, iters=SHARDED_ITERS)
    del fill
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    n_rows = int(touched.numel())
    fwd_bytes = ids_t.numel() * 8 + n_rows * SHARDED_DIM * 4 + out.numel() * 4
    grad_bytes = SHARDED_ROWS * SHARDED_DIM * 4

    gather_ms = time_cuda(lambda: kernels.gather_rows(table, ids32), iters=20)
    del params, w, table, out
    torch.cuda.empty_cache()
    return dict(
        table=[SHARDED_ROWS, SHARDED_DIM], shards=SHARDED_SHARDS, mesh="ShardMesh(['cuda:0'] * 4)",
        table_gb=round(grad_bytes / 1e9, 3), batch=SHARDED_BATCH,
        ids_out_of_range=int(len(bad)), unique_rows=n_rows, init_seconds=round(init_s, 3),
        forward_bit_equal_to_dense_lookup=True, grad_max_abs_err_vs_dense=grad_err,
        grad_tolerance="|k-p| <= 1e-5 + 1e-4|p| on touched rows; the rest zero in both",
        grad_nonzero_rows=got_nonzero, sgd_lr=SHARDED_LR,
        forward_ms=round(fwd_ms, 4), forward_backward_ms=round(fb_ms, 4),
        update_ms=round(sgd_ms, 4), peak_gib=round(peak, 3),
        forward_bytes=fwd_bytes, forward_bound_ms=round(fwd_bytes / peak_bw * 1e3, 4),
        forward_fraction_of_bound=round(fwd_bytes / peak_bw * 1e3 / fwd_ms, 4),
        dense_grad_zero_fill_ms=round(fill_ms, 4),
        dense_grad_zero_fill_bound_ms=round(grad_bytes / peak_bw * 1e3, 4),
        zero_fill_share_of_backward=round(fill_ms / max(fb_ms - fwd_ms, 1e-9), 4),
        update_bound_ms=round(3 * grad_bytes / peak_bw * 1e3, 4),
        gather_rows_flattened_ms=round(gather_ms, 4), gather_rows_bit_equal=True,
        gather_rows_launches=g_launched,
        rank_form="gloo ranks on the CPU (tests/test_torch_parallel_rank.py): NCCL refuses "
                  "two ranks on one card",
        seconds=round(time.perf_counter() - t_phase, 2))


def cache_tables(root: str, device) -> MultiTableEmbedding:
    """CACHE_TABLES cached tables under ``root``, each a PersistentTable of
    CACHE_TABLE_ROWS rows of CACHE_DIM (seed = its index) behind
    CACHE_SLOTS slots on ``device``."""
    return MultiTableEmbedding({
        f"t{i}": CachedEmbedding(PersistentTable(os.path.join(root, f"t{i}"), CACHE_DIM,
                                                 CACHE_TABLE_ROWS, seed=i),
                                 CACHE_SLOTS, device=device) for i in range(CACHE_TABLES)})


def cache_targets(device) -> torch.Tensor:
    """The regression targets: id x's target row is row x % 4096 of a seeded
    table (the same bits on every device)."""
    t = torch.randn((4096, CACHE_DIM), generator=torch.Generator().manual_seed(31))
    return t.to(device)


def cache_run(mt: MultiTableEmbedding, steps: list, device, stats: dict = None) -> tuple:
    """The JAX training loop (tests/test_one_embedding.py: lookup, loss, the
    rows' grad, apply_grad) over ``steps`` (per step, each table's ids),
    each phase inside a profiler range; with ``stats`` (on the card) the
    per-step host ms, the device part's CUDA events, hits, evictions and
    write-backs land there. Returns (caches, losses, slots)."""
    caches = mt.init_caches()
    targets = cache_targets(device)
    losses, slots_all = [], []
    for step_ids in steps:
        step_losses, step_slots = [], []
        for (name, emb), ids in zip(mt.tables.items(), step_ids):
            cache, meta = caches[name]
            if stats is not None:
                uniq, counts = np.unique(ids, return_counts=True)
                hit = np.fromiter((x in meta.index for x in uniq.tolist()), bool, len(uniq))
                old_ids, old_dirty = meta.slot_ids.copy(), meta.dirty.copy()
            t0 = time.perf_counter()
            with profiler.record("prepare"):
                slots, cache = emb.prepare(ids, cache, meta)
            host = time.perf_counter() - t0
            tgt = targets[torch.from_numpy(ids % 4096).to(device)]
            if stats is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            with profiler.record("lookup_grad_apply"):
                rows = emb.lookup(cache, slots).requires_grad_()
                loss = ((rows - tgt) ** 2).sum(1).mean()
                loss.backward()
                emb.apply_grad(cache, slots, rows.grad, meta, lr=CACHE_LR)
            step_losses.append(loss.detach())
            step_slots.append(slots)
            if stats is not None:
                ev[1].record()
                evicted = (old_ids >= 0) & (old_ids != meta.slot_ids)
                stats.setdefault("prepare_ms", []).append(host * 1e3)
                stats.setdefault("events", []).append(ev)
                stats.setdefault("hits", []).append(int(counts[hit].sum()))
                stats.setdefault("evictions", []).append(int(evicted.sum()))
                stats.setdefault("write_backs", []).append(int((evicted & old_dirty).sum()))
        losses.append([float(v) for v in torch.stack(step_losses).cpu()])
        slots_all.append(step_slots)
    return caches, losses, slots_all


def one_embedding_main_path() -> dict:
    """A MultiTableEmbedding of CACHE_TABLES CachedEmbeddings (dim
    CACHE_DIM, PersistentTables of CACHE_TABLE_ROWS rows, CACHE_SLOTS cache
    slots on the card) through CACHE_STEPS steps of the JAX training loop,
    each drawing CACHE_BATCH ids a table from a seeded power law
    (exponent CACHE_ZIPF over CACHE_TABLE_ROWS ids); prepare (host) and
    lookup + grad + apply_grad (device) in profiler ranges and under
    torch.profiler for the device's idle share. LRU evictions with dirty
    write-back must happen. The same ids through the port on the CPU:
    slots and meta equal, losses, caches and flushed rows within 1e-5 +
    1e-4|p|. Then flush, save_snapshot, load_snapshot (the round trip
    exact after the tables change), and the losses through SummaryWriter
    and read_events."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    rngs = [np.random.default_rng((41, i)) for i in range(CACHE_TABLES)]
    steps = [[power_law_ids(r, CACHE_BATCH, CACHE_TABLE_ROWS, CACHE_ZIPF) for r in rngs]
             for _ in range(CACHE_STEPS)]
    with tempfile.TemporaryDirectory() as root:
        mt = cache_tables(os.path.join(root, "card"), dev)
        stats = {}
        with profiler.profile() as ranges:
            ((caches, losses, slots), launched), wall, busy = profiled(
                lambda: counted(lambda: cache_run(mt, steps, dev, stats)))
        device_ms = [a.elapsed_time(b) for a, b in stats["events"]]
        if launched:
            raise AssertionError(f"one_embedding launched port kernels: {launched}")
        timed = slice(CACHE_TABLES, None)  # after the first step's cold fill
        if sum(stats["write_backs"][timed]) == 0:
            raise AssertionError(f"no LRU eviction with write-back in {CACHE_STEPS} steps: "
                                 f"{stats['evictions']}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"one_embedding losses {losses}")

        cpu = cache_tables(os.path.join(root, "cpu"), "cpu")
        t0 = time.perf_counter()
        cpu_caches, cpu_losses, cpu_slots = cache_run(cpu, steps, "cpu")
        cpu_s = time.perf_counter() - t0
        errs = {"loss": check_close(torch.tensor(losses), torch.tensor(cpu_losses),
                                    "one_embedding losses card vs CPU")}
        for s, cs in zip(slots, cpu_slots):
            if not all(np.array_equal(a, b) for a, b in zip(s, cs)):
                raise AssertionError("one_embedding slots differ between the card and the CPU")
        for name in mt.tables:
            (cache, meta), (ccache, cmeta) = caches[name], cpu_caches[name]
            if not (all(np.array_equal(getattr(meta, k), getattr(cmeta, k))
                        for k in ("slot_ids", "last_used", "dirty"))
                    and meta.clock == cmeta.clock and meta.index == cmeta.index):
                raise AssertionError(f"one_embedding meta {name} differs between card and CPU")
            errs[f"cache_{name}"] = check_close(cache.cpu(), ccache,
                                                f"one_embedding cache {name} card vs CPU")

        t0 = time.perf_counter()
        with profiler.profile() as flush_ranges:
            for name, emb in mt.tables.items():
                with profiler.record("flush"):
                    emb.flush(*caches[name])
        flush_s = time.perf_counter() - t0
        for name, emb in cpu.tables.items():
            emb.flush(*cpu_caches[name])
        live = {}
        for name in mt.tables:
            table, ctable = mt.tables[name].table, cpu.tables[name].table
            live[name] = np.nonzero(table._ids >= 0)[0]
            if not np.array_equal(table._ids, ctable._ids):
                raise AssertionError(f"one_embedding table {name}: ids differ card vs CPU")
            ids = table._ids[live[name]]
            errs[f"table_{name}"] = check_close(torch.from_numpy(table.get(ids)),
                                                torch.from_numpy(ctable.get(ids)),
                                                f"one_embedding flushed rows {name} card vs CPU")
        t0 = time.perf_counter()
        mt.save_snapshot("snap")
        save_s = time.perf_counter() - t0
        saved = {n: e.table.get(e.table._ids[live[n]]) for n, e in mt.tables.items()}
        for n, e in mt.tables.items():  # change the tables, then restore them
            e.table.put(e.table._ids[live[n]][:1000], np.zeros((1000, CACHE_DIM), np.float32))
        t0 = time.perf_counter()
        mt.load_snapshot("snap")
        load_s = time.perf_counter() - t0
        for n, e in mt.tables.items():
            if e.table.n_rows != len(live[n]) or not np.array_equal(
                    e.table.get(e.table._ids[live[n]]), saved[n]):
                raise AssertionError(f"one_embedding snapshot round trip of {n} not exact")
        logdir = os.path.join(root, "summary")
        with SummaryWriter(logdir) as sw:
            for i, step in enumerate(losses):
                sw.add_scalars("loss", dict(zip(mt.tables, step)), step=i)
        logged = [e["value"] for e in read_events(logdir)]
        if logged != [v for step in losses for v in step]:
            raise AssertionError("one_embedding: the summary's losses differ from the run's")
        table_rows = {n: int(len(v)) for n, v in live.items()}
    n = CACHE_STEPS * CACHE_TABLES
    lookups = n * CACHE_BATCH
    return dict(
        tables=CACHE_TABLES, dim=CACHE_DIM, table_rows=CACHE_TABLE_ROWS,
        table_gib=round(CACHE_TABLE_ROWS * CACHE_DIM * 4 / 2 ** 30, 3),
        cache_slots=CACHE_SLOTS, cache_mib=round(CACHE_SLOTS * CACHE_DIM * 4 / 2 ** 20, 1),
        batch=CACHE_BATCH, steps=CACHE_STEPS, zipf=CACHE_ZIPF, lr=CACHE_LR,
        loss="((rows - target) ** 2).sum(1).mean()",
        losses_first_last=[losses[0], losses[-1]],
        prepare_host_ms_per_table_step=round(float(np.mean(stats["prepare_ms"][timed])), 3),
        device_ms_per_table_step=round(float(np.mean(device_ms[timed])), 4),
        prepare_host_ms_per_step=round(float(np.sum(stats["prepare_ms"][timed])) /
                                       (CACHE_STEPS - 1), 3),
        device_ms_per_step=round(float(np.sum(device_ms[timed])) / (CACHE_STEPS - 1), 4),
        wall_seconds=round(wall, 3), kernel_ms=round(busy, 3),
        device_idle_share=round(1 - busy / (wall * 1e3), 4),
        hit_rate=round(sum(stats["hits"]) / lookups, 4),
        hit_rate_after_first_step=round(sum(stats["hits"][timed]) / (lookups - CACHE_TABLES *
                                                                      CACHE_BATCH), 4),
        evictions=int(sum(stats["evictions"])), write_backs=int(sum(stats["write_backs"])),
        evictions_per_step=[sum(stats["evictions"][i:i + CACHE_TABLES])
                            for i in range(0, n, CACHE_TABLES)],
        table_rows_touched=table_rows,
        max_abs_err_vs_cpu=max(errs.values()), cpu_seconds=round(cpu_s, 2),
        flush_seconds=round(flush_s, 3), save_snapshot_seconds=round(save_s, 3),
        load_snapshot_seconds=round(load_s, 3), snapshot_round_trip_exact=True,
        ranges={"steps": ranges.key_averages().splitlines(),
                "flush": flush_ranges.key_averages().splitlines()},
        summary_events=len(logged), kernel_launches=launched,
        seconds=round(time.perf_counter() - t_phase, 2))


class RecordImages(Dataset):
    """The record files' images decoded, through a transform seeded per
    index (rank 0 of 1): (float32 CHW image, int64 label)."""

    def __init__(self, paths, transform):
        self.records, self.transform = RecordDataset(paths), transform

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        ex = self.records[i]
        img = np.frombuffer(ex["image"], np.uint8).reshape(tuple(ex["shape"]))
        return self.transform(img, np.random.default_rng((RECORD_SEED, i))), np.int64(
            ex["label"][0])


def records_input_pipeline(resnet_step_ms: float) -> dict:
    """RECORD_IMAGES seeded uint8 images of RECORD_SHAPE (a raw-bytes
    feature beside its shape and a label in 0-999) written into
    RECORD_FILES files with RecordWriter and read back through
    RecordDataset, through Compose(RandomResizedCrop(224),
    RandomHorizontalFlip(), Normalize()) and the port's DataLoader (B =
    RECORD_BATCH, shuffled) with each of RECORD_WORKERS workers: the two
    passes bit-equal, each one's images/s; then RECORD_STEPS SGD steps of
    resnet50() fed from it (momentum), end to end and under the profiler
    for the device's idle share, beside resnet_main_path's step."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    tf = Compose((RandomResizedCrop(VISION_SIZE), RandomHorizontalFlip(), Normalize()))
    rng = np.random.default_rng(RECORD_SEED)
    with tempfile.TemporaryDirectory() as root:
        paths = [os.path.join(root, f"part-{i}.rec") for i in range(RECORD_FILES)]
        t0 = time.perf_counter()
        writers = [RecordWriter(p) for p in paths]
        for i in range(RECORD_IMAGES):
            img = rng.integers(0, 256, RECORD_SHAPE, dtype=np.uint8)
            writers[i % RECORD_FILES].write_example(
                {"image": img.tobytes(), "shape": list(RECORD_SHAPE),
                 "label": [int(rng.integers(0, VISION_CLASSES))]})
        for w in writers:
            w.close()
        write_s = time.perf_counter() - t0
        file_bytes = sum(os.path.getsize(p) for p in paths)
        ds = RecordImages(paths, tf)
        passes, rates = {}, {}
        for workers in RECORD_WORKERS:
            loader = DataLoader(ds, batch_size=RECORD_BATCH, shuffle=True, seed=RECORD_SEED,
                                num_workers=workers)
            t0 = time.perf_counter()
            passes[workers] = [(x.numpy().copy(), y.numpy().copy()) for x, y in loader]
            rates[workers] = len(ds) / (time.perf_counter() - t0)
        first, second = (passes[w] for w in RECORD_WORKERS)
        if len(first) != len(ds) // RECORD_BATCH or not all(
                np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(first, second)):
            raise AssertionError("records pipeline: two passes with one seed differ")
        del passes, first, second

        model = resnet50(generator=torch.Generator().manual_seed(12))
        opt = optim.sgd(VISION_LR, momentum=VISION_MOMENTUM).init(model.parameters())
        loader = DataLoader(ds, batch_size=RECORD_BATCH, shuffle=True, seed=RECORD_SEED + 1,
                            num_workers=RECORD_WORKERS[-1])

        waits = []

        def train_from_records():
            losses, batches = [], iter(loader)
            for _ in range(RECORD_STEPS):
                t0 = time.perf_counter()
                x, y = next(batches)
                waits.append(time.perf_counter() - t0)
                opt.zero_grad(set_to_none=True)
                loss = cross_entropy(model(x.to(dev), train=True), y.to(dev))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            batches.close()
            return [float(v) for v in torch.stack(losses).cpu()]

        # end to end: the workers' start and first batches included (cuDNN's
        # algorithms for ResNet-50 at this batch are chosen in resnet_main_path)
        (losses, launched), wall, busy = profiled(lambda: counted(train_from_records))
    if launched or len(losses) != RECORD_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"records training: losses {losses}, launches {launched}")
    return dict(
        images=RECORD_IMAGES, image_shape=list(RECORD_SHAPE), files=RECORD_FILES,
        file_bytes=file_bytes, write_seconds=round(write_s, 3),
        transform="Compose(RandomResizedCrop(224), RandomHorizontalFlip(), Normalize())",
        resize_branch="PIL" if vision_data.HAVE_PIL else "numpy", batch=RECORD_BATCH,
        pipeline_images_per_s={str(w): round(r, 1) for w, r in rates.items()},
        passes_bit_equal=True, train_steps=RECORD_STEPS, train_workers=RECORD_WORKERS[-1],
        losses=[round(v, 5) for v in losses], train_wall_seconds=round(wall, 3),
        train_images_per_s=round(RECORD_STEPS * RECORD_BATCH / wall, 1),
        train_kernel_ms=round(busy, 3), device_idle_share=round(1 - busy / (wall * 1e3), 4),
        input_wait_ms=[round(t * 1e3, 2) for t in waits],
        input_wait_share=round(sum(waits) / wall, 4),
        resnet_main_path_step_ms=resnet_step_ms,
        resnet_main_path_images_per_s=round(RESNET_BATCH / (resnet_step_ms / 1e3), 1),
        kernel_launches=launched, seconds=round(time.perf_counter() - t_phase, 2))


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_flash(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """|k - p| <= atol + rtol |p| (FLASH_TOL of the working type) on the
    two results' values; returns max |k - p|."""
    atol, rtol = FLASH_TOL[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if got.dtype != want.dtype or not torch.isfinite(g).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of tolerance, "
                             f"max abs err {float(err.max())}, dtype {got.dtype}")
    return float(err.max())


def flash_kernel_cases(gen) -> dict:
    """flash_attention against its plain version (with the case's JAX
    blocks) on FLASH_CASES in float32, bfloat16 and float16, and the
    host-side refusal of T = 100 with blocks of 64."""
    dev = torch.device("cuda", 0)
    errs = {dtype_name(dt): 0.0 for dt in FLASH_TOL}
    for BH, Tq, Tk, d, bq, bk, causal in FLASH_CASES:
        q = torch.randn((BH, Tq, d), generator=gen)
        k, v = (torch.randn((BH, Tk, d), generator=gen) for _ in range(2))
        for dtype in FLASH_TOL:
            qd, kd, vd = (t.to(dev, dtype) for t in (q, k, v))
            got = fakernels.flash_attention(qd, kd, vd, causal)
            want = fakernels.flash_attention_torch(qd, kd, vd, causal, bq, bk)
            torch.cuda.synchronize()
            e = check_flash(got, want, f"flash_attention BH={BH} Tq={Tq} Tk={Tk} d={d} "
                                       f"causal={causal}")
            errs[dtype_name(dtype)] = max(errs[dtype_name(dtype)], e)
    # no keys: every row has l = 0 and is zero (every warp's output goes
    # through Q-tile rows that other warps' Q copies fill)
    for dtype in FLASH_TOL:
        for d in FLASH_NO_KEY_WIDTHS:
            q = torch.randn((4, 200, d), generator=gen).to(dev, dtype)
            empty = torch.empty((4, 0, d), device=dev, dtype=dtype)
            for causal in (False, True):
                got = fakernels.flash_attention(q, empty, empty, causal)
                torch.cuda.synchronize()
                if not torch.equal(got, torch.zeros_like(q)):
                    raise AssertionError(f"flash_attention {dtype_name(dtype)} d={d} "
                                         f"causal={causal} with no keys: not zeros")
    x = torch.zeros((1, 1, 100, 64), device=dev)
    try:
        flash_attention(x, x, x, block_q=64, block_k=64)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("flash_attention took T = 100 with blocks of 64")
    return {"cases": [dict(zip(("BH", "Tq", "Tk", "d", "block_q", "block_k", "causal"), c))
                      for c in FLASH_CASES],
            "dtypes": list(errs), "max_abs_err": errs,
            "tolerance": {dtype_name(dt): f"|k-p| <= {a} + {r}|p|"
                          for dt, (a, r) in FLASH_TOL.items()},
            "no_keys": {"Tq": 200, "d": FLASH_NO_KEY_WIDTHS, "dtypes": list(errs),
                        "result": "zeros"},
            "ragged_blocks_refused": refusal}


def transformer_main_path(gen) -> tuple:
    """BERT-base inference (seeded weights and tokens, B = 8, T = 512,
    float32) through TransformerEncoder.forward, whose blocks run the
    dense attention as in the JAX package; then every block's attention
    input from that forward (a forward hook: a test harness) run again
    through MultiheadAttention(flash=True) with the block's own
    parameters, non-causal and causal, held against the block's dense
    attention (the forward's own output when non-causal). Returns the
    flash launches per mode, the phase's fields and the flash MHA modules
    with their inputs (for flash_grad)."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    model = bert_base(generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tokens = torch.randint(0, model.vocab_size, (BERT_BATCH, BERT_SEQ), generator=gen).to(dev)
    seen = []
    hooks = [b.attn.register_forward_hook(lambda mod, args, out: seen.append((args[0], out)))
             for b in model.blocks]
    with torch.inference_mode():
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()  # weights, tokens, earlier phases' data
        hidden = model(tokens)
        torch.cuda.synchronize()
        fwd_launches = dict(kernels.LAUNCHES)
        peak_bytes = torch.cuda.max_memory_allocated() - start_bytes
    for h in hooks:
        h.remove()
    if (hidden.shape != (BERT_BATCH, BERT_SEQ, model.embed_dim)
            or not torch.isfinite(hidden).all() or len(seen) != model.num_layers):
        raise AssertionError(f"BERT-base hidden states {tuple(hidden.shape)} not finite, "
                             f"wrong shape, or {len(seen)} blocks seen")
    if any(fwd_launches.values()):
        raise AssertionError(f"the encoder's forward launched port kernels: {fwd_launches}")
    flash = []
    for b in model.blocks:
        f = MultiheadAttention(model.embed_dim, model.num_heads, flash=True)
        f.load_state_dict(b.attn.state_dict())
        flash.append(f)
    launches, modes = {}, {}
    with torch.inference_mode():
        for causal in (False, True):
            mode = "causal" if causal else "non_causal"
            kernels.reset_launch_counts()
            outs = [f(x, is_causal=causal) for f, (x, _) in zip(flash, seen)]
            torch.cuda.synchronize()
            launches[mode] = dict(kernels.LAUNCHES)
            expected = {k: 0 for k in SOURCES}
            expected["flash_attention"] = model.num_layers
            if launches[mode] != expected:
                raise AssertionError(f"flash MHA ({mode}) launches {launches[mode]}, "
                                     f"expected {expected}")
            errs = [rel_err(o, out if not causal else b.attn(x, is_causal=True))
                    for o, b, (x, out) in zip(outs, model.blocks, seen)]
            if max(errs) > MAIN_PATH_REL_TOL or not all(torch.isfinite(o).all() for o in outs):
                raise AssertionError(f"flash MHA ({mode}) vs dense MHA: rel errs {errs}")
            x0 = seen[0][0]
            modes[mode] = {
                "launches": launches[mode]["flash_attention"],
                "rel_err_vs_dense_per_block": errs,
                "flash_mha_ms": time_cuda(lambda: flash[0](x0, is_causal=causal), iters=20),
                "dense_mha_ms": time_cuda(lambda: model.blocks[0].attn(x0, is_causal=causal),
                                          iters=20)}
        fwd_ms = time_cuda(lambda: model(tokens), iters=10)
        fwd_wall_ms = wall_ms(lambda: model(tokens), iters=10)
    fields = dict(model="bert_base (BERT-base: 12 layers, width 768, 12 heads, MLP 3072, "
                        "vocabulary 30522; seeded random weights)",
                  batch=BERT_BATCH, seq=BERT_SEQ, dtype="float32",
                  tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                        "cudnn": torch.backends.cudnn.allow_tf32},
                  params=sum(p.numel() for p in model.parameters()),
                  weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
                  init_seconds=round(t_init, 2), forward_launches=fwd_launches,
                  forward_ms=fwd_ms, forward_wall_ms=fwd_wall_ms,
                  forward_peak_extra_bytes=peak_bytes, hidden_finite=True,
                  flash_mha=modes, mha_scope="block 0's attention at (8, 512, 768)")
    return launches, fields, flash[0], seen[0][0], model.blocks[0].attn


def flash_grad(flash: MultiheadAttention, dense: MultiheadAttention, x: torch.Tensor) -> dict:
    """One block's MHA at BERT-base width, causal: gradients of
    sum(o ** 2) with respect to q, k, v (three copies of the block's
    input) and every parameter, through flash=True and through the dense
    core, held within GRAD_TOL (|f - d| <= 2e-4 + 2e-4 |d|)."""
    grads = []
    for mod in (dense, flash):
        mod.zero_grad(set_to_none=True)
        qkv = [x.clone().requires_grad_(True) for _ in range(3)]
        (mod(*qkv, is_causal=True) ** 2).sum().backward()
        grads.append([t.grad for t in qkv] + [p.grad for p in mod.parameters()])
    names = ["q", "k", "v"] + [n for n, _ in dense.named_parameters()]
    errs = {}
    for name, d, f in zip(names, *grads):
        err = (f - d).abs()
        bad = err > GRAD_TOL + GRAD_TOL * d.abs()
        if not torch.isfinite(f).all() or bad.any():
            raise AssertionError(f"flash MHA grad {name}: {int(bad.sum())} elements out of "
                                 f"tolerance, max abs err {float(err.max())}")
        errs[name] = {"max_abs_err": float(err.max()), "rel_err": rel_err(f, d)}
    dense.zero_grad(set_to_none=True)
    flash.zero_grad(set_to_none=True)
    return {"shape": list(x.shape), "causal": True, "loss": "sum(o ** 2)",
            "tolerance": f"|f-d| <= {GRAD_TOL} + {GRAD_TOL}|d|", "grads": errs}


def flash_scale(gen, peak_bw: float, peak_fp32: float, peak_t16: float,
                peak_tf32: float) -> list:
    """flash_attention at BERT-base's attention shape (BH = 96, T = 512,
    d = 64), float32, bfloat16 and float16, non-causal and causal: its
    time (float32 on the tensor cores in 3xTF32, bf16 / fp16 in their own
    type), its plain version's, torch's scaled_dot_product_attention on
    the same (B, H, T, d) tensors (timed only; the port never calls it),
    and the bound of the work (AttentionTraffic: bytes over HBM bandwidth,
    operations over the type's peak: for float32 the faster of the CUDA
    cores and three TF32 products on the tensor cores, for bfloat16 /
    float16 the tensor cores). The CUDA-core bound stays beside it
    (bound_ms_operations, fraction_of_cuda_core_bound). Raises if a row
    reads above its bound, which would mean a miscounted bound."""
    dev = torch.device("cuda", 0)
    BH, T, d = BERT_BATCH * 12, BERT_SEQ, 64
    qkv = [torch.randn((BH, T, d), generator=gen) for _ in range(3)]
    rows = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = (t.to(dev, dtype) for t in qkv)
            q4, k4, v4 = (t.view(BERT_BATCH, 12, T, d) for t in (q, k, v))
            for causal in (False, True):
                got = fakernels.flash_attention(q, k, v, causal)
                want = fakernels.flash_attention_torch(q, k, v, causal)
                lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
                torch.cuda.synchronize()
                err = check_flash(got, want, f"flash_attention at scale {dtype} causal={causal}")
                ms = time_cuda(lambda: fakernels.flash_attention(q, k, v, causal), iters=50)
                plain_ms = time_cuda(lambda: fakernels.flash_attention_torch(q, k, v, causal),
                                     iters=5)
                lib_ms = time_cuda(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                    iters=50)
                traffic = AttentionTraffic(BH, T, T, d, q.element_size(), causal)
                fp32 = dtype == torch.float32
                peak = peak_fp32 if fp32 else peak_t16
                bound, term = traffic.bound(peak_bw, peak, peak_tf32 if fp32 else None)
                row = {"dtype": dtype_name(dtype), "causal": causal, "BH": BH, "T": T,
                       "d": d, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "library": "torch.nn.functional.scaled_dot_product_attention",
                       "library_max_abs_err": float((lib.reshape(BH, T, d).float()
                                                     - want.float()).abs().max()),
                       "max_abs_err": err, "bytes": traffic.bytes,
                       "flops": traffic.flops,
                       "bound_ms_bytes": traffic.bytes / peak_bw * 1e3,
                       "bound_ms_operations": traffic.flops / peak * 1e3,
                       "peak_tflops": peak / 1e12, "bound_ms": bound,
                       "bound_by": "bytes" if term == "bytes" else "operations",
                       "bound_term": term, "fraction_of_bound": bound / ms}
                if fp32:
                    row.update(bound_ms_operations_tf32x3=3 * traffic.flops / peak_tf32 * 1e3,
                               peak_tf32_tflops=peak_tf32 / 1e12,
                               fraction_of_cuda_core_bound=traffic.bound(peak_bw, peak)[0] / ms)
                rows.append(row)
    over = [r for r in rows if r["fraction_of_bound"] > 1.0]
    if over:
        raise AssertionError(f"flash_attention reads above its bound (a miscounted bound): {over}")
    return rows


def check_norm(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |k - p| <= MICROBENCH_NORM_TOL max |p|; returns max |k - p|."""
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or err > MICROBENCH_NORM_TOL * float(want.abs().max()):
        raise AssertionError(f"{what}: max abs err {err} against max |p| "
                             f"{float(want.abs().max())}")
    return err


def run_tool(tool, expected: dict, argv: tuple = ()) -> tuple:
    """The tool's entry point at its default size, on the card (its printed
    lines go to stderr), with every launch count set to 0 just before it;
    (its rows, the counts just after), the counts held to ``expected``."""
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        rows = tool.main(list(argv))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in SOURCES}
    want.update(expected)
    if launches != want:
        raise AssertionError(f"{tool.__name__} launches {launches}, expected {want}")
    return rows, launches


def blockfma_phase(dev) -> tuple:
    """tools/microbench_blockfma at its default size through its entry
    point, then both kernels against their plain versions on two small
    seeded cases and the default inputs, B also at its edges
    (blockfma_b_edges), and the plain versions' times."""
    calls = WARMUP_CALLS + tblockfma.ITERS
    rows, launches = run_tool(tblockfma, {"microbench_blockfma_a": calls,
                                          "microbench_blockfma_b": calls})
    with torch.inference_mode():
        for row in rows:
            v = row["variant"]
            plain = kblockfma.blockfma_a_torch if v == "A" else kblockfma.blockfma_b_torch
            err = 0.0
            for C, T, K, seed in BLOCKFMA_SMALL + ((tblockfma.C, tblockfma.T, tblockfma.K, 0),):
                a = [torch.from_numpy(x).to(dev) for x in tblockfma.inputs(v, C, T, K, seed)]
                got, want = tblockfma.run(v, *a), plain(*a)
                torch.cuda.synchronize()
                err = max(err, check_close(got, want, f"blockfma {v} C={C} T={T} K={K}"))
            if v == "B":
                err = max(err, blockfma_b_edges(dev, row))
            else:
                err = max(err, blockfma_a_edges(dev, row))
            row["max_abs_err"] = err
            row["plain_ms"] = time_cuda(lambda: plain(*a), iters=3)
            lib_name, lib = blockfma_library(v, *a)
            check_close(lib(), plain(*a), f"{lib_name} for blockfma {v}")
            row["library"], row["library_ms"] = lib_name, time_cuda(lib, iters=10)
    expect_device_assert(BAD_SLICED_PROBE.format(C=8192),
                         "blockfma_a's sliced kernel with a start past the tier")
    return rows, launches


def blockfma_a_edges(dev, row: dict) -> float:
    """blockfma_a on both of its paths at its edges (tools' A_EDGES: C on
    each side of both switches of a_plan, R 257, K 40, a start at C - 8;
    EDGE_SEEDS): the L2 kernel and, where a 4-column slice fits, the sliced
    kernel, each output on NaN-poisoned memory, bit-equal to each other and
    held to the plain version; the largest error. Records the stages of the
    default size's path and of the edges' (0: the L2 kernel) into
    ``row``."""
    optin = kblockfma.smem_optin(dev)
    err, stages = 0.0, {}
    for seed in EDGE_SEEDS:
        for case in tblockfma.A_EDGES:
            a = [torch.from_numpy(x).to(dev) for x in tblockfma.a_edge_inputs(case, seed)]
            what = f"blockfma A edge {case} seed={seed}"
            stages[case] = kblockfma.a_plan(a[2].shape[0], optin)
            outs = []
            for sliced in (False, True) if kblockfma.a_stages(a[2].shape[0], optin) else (False,):
                at = poison_block(a[0].shape[0], dev)
                outs.append(kblockfma._launch(0, "microbench_blockfma_a", *a, sliced=sliced))
                torch.cuda.synchronize()
                if outs[-1].data_ptr() != at:
                    raise AssertionError(f"{what}: the output is not the poisoned block")
            if not torch.equal(outs[0], outs[-1]):
                raise AssertionError(f"{what}: the sliced and L2 kernels differ")
            err = max(err, check_close(outs[-1], kblockfma.blockfma_a_torch(*a), what))
    if min(stages.values()) != 0 or max(stages.values()) < 2:
        raise AssertionError(f"blockfma A edges {stages} do not run both paths")
    row["stages"] = kblockfma.a_plan(tblockfma.C, optin)
    row["edges"], row["edge_stages"] = sorted(tblockfma.A_EDGES), stages
    return err


def blockfma_b_edges(dev, row: dict) -> float:
    """blockfma_b at its edges (tools' B_EDGES, EDGE_SEEDS), each output on
    NaN-poisoned memory, against the plain version, every row no slot
    names exactly 0; the largest error. Counts the zero rows into ``row``."""
    err, empty = 0.0, 0
    for seed in EDGE_SEEDS:
        for case in tblockfma.B_EDGES:
            a = [torch.from_numpy(x).to(dev) for x in tblockfma.b_edge_inputs(case, seed=seed)]
            at = poison_block(a[0].shape[0], dev)
            got, want = kblockfma.blockfma_b(*a), kblockfma.blockfma_b_torch(*a)
            torch.cuda.synchronize()
            what = f"blockfma B edge {case} seed={seed}"
            if got.data_ptr() != at:
                raise AssertionError(f"{what}: the output is not the poisoned block")
            err = max(err, check_close(got, want, what))
            unnamed = ~tblockfma.named_rows(a[0])
            if got[unnamed].any():
                raise AssertionError(f"{what}: a row no slot names is not 0")
            empty += int(unnamed.sum())
    row["edges"] = sorted(tblockfma.B_EDGES)
    row["empty_rows_zero_on_poison"] = empty
    return err


def blockfma_library(variant: str, starts: torch.Tensor, w: torch.Tensor, tier: torch.Tensor):
    """(name, call) of the one PyTorch call that computes a blockfma
    variant's function, its index arrays built here, outside the call:
    A as embedding_bag over the (8R, K) slot rows (row 8r + j's slot k
    reads tier[s_k + j]) with the weights; B as torch.sparse.mm on the CSR
    of its slots (slot k of step r adds v tier[c] into row 8r + c % 8)."""
    R8 = starts.shape[0]
    s = kblockfma._slots(starts, starts.shape[1] * kblockfma.ROWS)  # (R, K)
    j = torch.arange(kblockfma.ROWS, device=tier.device)
    if variant == "A":
        idx = (s[:, None, :] + j[None, :, None]).reshape(R8, -1)
        return ("torch.nn.functional.embedding_bag",
                lambda: F.embedding_bag(idx, tier, per_sample_weights=w, mode="sum"))
    R, K = s.shape
    v = w.view(R, kblockfma.ROWS, K // kblockfma.ROWS).permute(0, 2, 1).reshape(R, K)
    rows = torch.arange(R, device=tier.device)[:, None] * kblockfma.ROWS + s % kblockfma.ROWS
    sp = torch.sparse_coo_tensor(torch.stack([rows.reshape(-1), s.reshape(-1)]), v.reshape(-1),
                                 (R8, tier.shape[0]), check_invariants=False
                                 ).coalesce().to_sparse_csr()
    return "torch.sparse.mm", lambda: torch.sparse.mm(sp, tier)


def mxu_phase(dev) -> tuple:
    """tools/microbench_mxu at its default size through its entry point,
    then every variant against the plain version on two small seeded cases,
    the default inputs and the kernels' edges (tools' EDGES, EDGE_SEEDS),
    each output on NaN-poisoned memory; the plain version's times, the
    library call's (torch.sparse.mm of the count matrix's CSR, built
    outside the timed call, times the window's halves added) and
    device-assert probes (a block, a lane index, a tile row out of range)."""
    rows, launches = run_tool(tmxu, {"microbench_mxu": len(kmxu.VARIANTS)
                                     * (WARMUP_CALLS + tmxu.ITERS)})
    err = {v: 0.0 for v in kmxu.VARIANTS}
    cases = [(f"S={S} seed={seed}", (*tmxu.inputs(S, seed=seed), tmxu.R))
             for S, seed in MXU_SMALL]
    cases += [(f"edge {case} seed={seed}", tmxu.edge_inputs(case, seed=seed))
              for seed in EDGE_SEEDS for case in sorted(tmxu.EDGES)]
    cases.append((f"S={tmxu.S} seed=0", (*tmxu.inputs(tmxu.S, seed=0), tmxu.R)))
    with torch.inference_mode():
        for what, (*m, R) in cases:
            m = [t.to(dev) for t in m]
            for v in kmxu.VARIANTS:
                at = poison_block(kmxu.tile_rows(v, R), dev)
                got, want = kmxu.mxu_step(v, *m, R), kmxu.mxu_step_torch(v, *m, R)
                torch.cuda.synchronize()
                if got.data_ptr() != at:
                    raise AssertionError(f"microbench_mxu {v} {what}: the output is not the "
                                         "poisoned block")
                err[v] = max(err[v], check_norm(got, want, f"microbench_mxu {v} {what}"))
            del got, want
        # m: the default inputs (seed 0), as the tool's run
        halves = m[3][:, :128].float() + m[3][:, 128:].float()
        for row in rows:
            v = row["variant"]
            row["max_abs_err"] = err[v]
            row["edges"] = sorted(tmxu.EDGES)
            row["count_plan"] = kmxu.count_plan(v, tmxu.S, tmxu.G, m[3].shape[0],
                                                kmxu.tile_rows(v, tmxu.R),
                                                torch.cuda.get_device_properties(
                                                    dev).multi_processor_count)
            row["plain_ms"] = time_cuda(lambda: kmxu.mxu_step_torch(v, *m), iters=3)
            row["library"], row["library_ms"] = None, None
            if v != "noop":
                sp = kmxu.count_csr(v, *m[:3], m[3].shape[0])
                check_norm(torch.sparse.mm(sp, halves), kmxu.mxu_step_torch(v, *m),
                           f"torch.sparse.mm for microbench_mxu {v}")
                row["library"], row["library_ms"] = "torch.sparse.mm", time_cuda(
                    lambda: torch.sparse.mm(sp, halves), iters=10)
                row["library_nnz"] = int(sp._nnz())
                del sp
    expect_device_asserts([(BAD_MXU_PROBE.format(bad=bad), f"mxu_step with {bad} out of range")
                           for bad in ("blk", "lidx", "lrow")])
    return rows, launches


def cond_phase(dev) -> tuple:
    """tools/microbench_cond at its default size through its entry point,
    then every mode (every step's tile) against the plain version on two
    small seeded cases, the default inputs and the kernel's edges
    (tools' EDGES, each output on NaN-poisoned memory), and the plain
    version's times."""
    rows, launches = run_tool(tcond, {"microbench_cond": len(tcond.RUNS)
                                      * (WARMUP_CALLS + tcond.ITERS)})
    err = {mode: 0.0 for mode, _ in tcond.RUNS}
    with torch.inference_mode():
        for steps, seed in COND_SMALL + ((tcond.STEPS, 0),):
            _, masks, win = (t.to(dev) for t in tcond.inputs(1.0, steps, seed))
            for mode, frac in tcond.RUNS:
                c = (torch.full((steps,), int(tcond.G * frac), dtype=torch.int32, device=dev),
                     masks, win)
                got, want = kcond.cond_steps(mode, *c), kcond.cond_steps_torch(mode, *c)
                torch.cuda.synchronize()
                err[mode] = max(err[mode], check_norm(got, want, f"microbench_cond {mode} "
                                                                 f"steps={steps}"))
                del got, want
                if steps == tcond.STEPS:
                    row = next(r for r in rows if r["variant"] == mode)
                    row["plain_ms"] = time_cuda(lambda: kcond.cond_steps_torch(mode, *c), iters=3)
        for seed in EDGE_SEEDS:
            for case in tcond.EDGES:
                for mode, frac in tcond.RUNS:
                    c = [t.to(dev) for t in tcond.edge_inputs(case, frac, seed=seed)]
                    at = poison_block(c[0].shape[0] * 128, dev)
                    got, want = kcond.cond_steps(mode, *c), kcond.cond_steps_torch(mode, *c)
                    torch.cuda.synchronize()
                    what = f"microbench_cond {mode} edge {case} seed={seed}"
                    if got.data_ptr() != at:
                        raise AssertionError(f"{what}: the output is not the poisoned block")
                    err[mode] = max(err[mode], check_norm(got, want, what))
    for row in rows:
        row["max_abs_err"] = err[row["variant"]]
        row["edges"] = sorted(tcond.EDGES)
    return rows, launches


def poison_block(n_rows: int, dev) -> int:
    """Leave a freed block of (n_rows, 128) float32 holding NaN and return
    its address: the caching allocator hands it to the next allocation of
    that size, so a row a kernel leaves unwritten shows."""
    return torch.full((n_rows, 128), float("nan"), device=dev).data_ptr()


def proto_phase(dev) -> tuple:
    """tools/proto_fused at its default size through its entry point, then
    every mode against the plain version (dma's staging buffer bit-exact,
    compute on that buffer, fused against the plain oracle) on
    PROTO_SMALL's seeded cases and the default inputs, compute's and
    fused's output on NaN-poisoned memory with every row no lane selects
    exactly 0, and the plain version's times."""
    rows, launches = run_tool(tproto, {"proto_fused": 1 + len(tproto.MODES)
                                       * (WARMUP_CALLS + tproto.ITERS)})
    err = {mode: 0.0 for mode in tproto.MODES}
    empty_rows = 0
    default = (tproto.N, tproto.R, tproto.T, tproto.S, tproto.TILES, 0)
    with torch.inference_mode():
        for N, R, T, S, TILES, seed in PROTO_SMALL + (default,):
            args = [t.to(dev) for t in tproto.inputs(N, R, T, S, TILES, tproto.SPT, seed)]
            size = dict(R=R, S=S, SPT=tproto.SPT, TILES=TILES)
            staged_k, staged_p = (torch.empty(kproto.staged_shape(S, TILES), device=dev)
                                  for _ in range(2))
            what = f"proto_fused N={N} R={R} T={T} S={S} TILES={TILES}"
            zeros = kproto.proto_fused("dma", *args, **size, staged=staged_k)
            kproto.proto_fused_torch("dma", *args, **size, staged=staged_p)
            torch.cuda.synchronize()
            if not torch.equal(staged_k, staged_p) or zeros.any():
                raise AssertionError(f"{what} dma: staging not bit-exact or output not zero")
            # the rows no lane selects
            G = args[3].shape[-1]
            t, _ = kproto.lane_sources(args[0], args[1], args[3], S, tproto.SPT, TILES, 0,
                                       TILES * tproto.SPT, False)
            lrow = args[2][tproto.SPT * G:(TILES + 1) * tproto.SPT * G].reshape(-1).long()
            empty = torch.bincount(t * R + lrow, minlength=TILES * R) == 0
            empty_rows += int(empty.sum())
            del t, lrow
            for mode in ("compute", "fused"):
                at = poison_block(TILES * R, dev)
                got = kproto.proto_fused(mode, *args, **size, staged=staged_k)
                want = kproto.proto_fused_torch(mode, *args, **size, staged=staged_p)
                torch.cuda.synchronize()
                if got.data_ptr() != at:
                    raise AssertionError(f"{what} {mode}: the output is not the poisoned block")
                err[mode] = max(err[mode], check_close(got, want, f"{what} {mode}"))
                if got[empty].any():
                    raise AssertionError(f"{what} {mode}: a row no lane selects is not 0")
            del got, want, zeros, empty
        for row in rows:
            mode = row["variant"]
            row["max_abs_err"] = err[mode]
            row["empty_rows_zero_on_poison"] = None if mode == "dma" else empty_rows
            row["plain_ms"] = time_cuda(lambda: kproto.proto_fused_torch(
                mode, *args, **size, staged=staged_p), iters=3)
        # fused mode's function in one PyTorch call: torch.sparse.mm on the
        # CSR of its lanes (lane l adds X row src(l) into row t(l) R + lrow)
        scols, lidx, lrow, blk, xp = args
        G = blk.shape[-1]
        t, src = kproto.lane_sources(scols, lidx, blk, S, tproto.SPT, TILES, 0, TILES * tproto.SPT,
                                     False)
        dst = t * R + lrow[tproto.SPT * G:(tproto.SPT + TILES * tproto.SPT) * G].reshape(-1).long()
        sp = torch.sparse_coo_tensor(torch.stack([dst, src]), torch.ones(dst.shape[0], device=dev),
                                     (TILES * R, xp.shape[0]), check_invariants=False
                                     ).coalesce().to_sparse_csr()
        del t, src, dst
        check_close(torch.sparse.mm(sp, xp), kproto.proto_fused_torch(
            "fused", *args, **size, staged=staged_p), "torch.sparse.mm for proto_fused fused")
        for row in rows:
            row["library"], row["library_ms"] = None, None
            if row["variant"] == "fused":
                row["library"] = "torch.sparse.mm"
                row["library_ms"] = time_cuda(lambda: torch.sparse.mm(sp, xp), iters=10)
    return rows, launches


# the gather kernel's inputs and the sizes a tool row carries for them
GATHER_KEYS = {
    "gather_vmem_loop": ("C", "T", "K"), "gather_vmem_take": ("C", "T"),
    "gather_onehot": ("C", "T", "dtype"), "gather_block_slice": ("C", "T", "K"),
    "gather_row_dma": ("table_rows", "T", "W"), "gather2_onehot_pair": ("C", "T"),
    "gather2_take_fused": ("C", "T", "K"), "gather2_dma_deep": ("table_rows", "T", "W"),
    "gather2_window_pair": ("TILE", "CW", "T", "U"), "gather2_twosided": ("TILE", "CW", "R", "T"),
    "dyngather_take_along": ("C", "T", "shape", "steps"), "dyngather_smem_cap": ("nbytes",),
}


def gather_case(kernel: str, dev, seed: int, **p) -> tuple:
    """(kernel call, plain call, (library call's name, the call) or None)
    of one gather kernel on its tool's seeded inputs at the sizes ``p``,
    placed on ``dev``. A library call's index arrays are built here,
    outside the timed call."""
    def on(ts):
        return [t.to(dev) for t in ts]

    def bag(idx, table, w=None):
        return ("torch.nn.functional.embedding_bag",
                lambda: F.embedding_bag(idx, table, per_sample_weights=w, mode="sum"))

    def select(table, idx):
        return "torch.index_select", lambda: torch.index_select(table, 0, idx)

    if kernel in ("gather_vmem_loop", "gather2_take_fused"):
        loop = kernel == "gather_vmem_loop"
        make = tgather.inputs_vmem_loop if loop else tgather2.inputs_take_fused
        cols, vals, tier = on(make(p["C"], p["T"], p["K"], seed))
        k, plain = ((kgather.vmem_loop, kgather.vmem_loop_torch) if loop
                    else (kgather2.take_fused, kgather2.take_fused_torch))
        return (lambda: k(cols, vals, tier), lambda: plain(cols, vals, tier),
                bag(cols.long(), tier, vals))
    if kernel in ("gather_vmem_take", "gather_onehot"):
        dtype = getattr(torch, p.get("dtype", "float32"))
        cols, tier = tgather.inputs_take(p["C"], p["T"], seed, dtype)
        if p.get("outside"):
            cols = tgather.with_outside(cols, p["C"])
        cols, tier = on((cols, tier))
        k, plain = ((kgather.vmem_take, kgather.vmem_take_torch) if kernel == "gather_vmem_take"
                    else (kgather.onehot, kgather.onehot_torch))
        return (lambda: k(cols, tier), lambda: plain(cols, tier),
                select(tier.float(), cols.reshape(-1).long()))
    if kernel == "gather_block_slice":
        starts, tier = on(tgather.inputs_block_slice(p["C"], p["T"], p["K"], seed))
        s8 = starts.view(starts.shape[0] // 8, -1).long()
        idx = (s8[:, None, :] + torch.arange(8, device=dev)[None, :, None]).reshape(
            starts.shape[0], -1)
        return (lambda: kgather.block_slice(starts, tier),
                lambda: kgather.block_slice_torch(starts, tier), bag(idx, tier))
    if kernel in ("gather_row_dma", "gather2_dma_deep"):
        cols, table = on(tgather.inputs_row_dma(p["table_rows"], p["T"], seed))
        W = p["W"]
        if kernel == "gather_row_dma":
            k, plain, group = kgather.row_dma, kgather.row_dma_torch, kgather.GROUP
        else:
            k, plain, group = kgather2.dma_deep, kgather2.dma_deep_torch, kgather2.DEEP_GROUP
        return (lambda: k(cols, table, W), lambda: plain(cols, table, W),
                bag(cols.view(-1, group).long(), table))
    if kernel == "gather2_onehot_pair":
        cols, hi, lo = tgather2.inputs_onehot_pair(p["C"], p["T"], seed)
        if p.get("outside"):
            cols = tgather.with_outside(cols, p["C"])
        cols, hi, lo = on((cols, hi, lo))
        return (lambda: kgather2.onehot_pair(cols, hi, lo),
                lambda: kgather2.onehot_pair_torch(cols, hi, lo),
                select(hi.float() + lo.float(), cols.reshape(-1).long()))
    if kernel in ("gather2_window_pair", "gather2_twosided"):
        TILE, CW, T = p["TILE"], p["CW"], p["T"]
        if kernel == "gather2_twosided":
            made = list(tgather2.inputs_twosided(TILE, CW, p["R"], T, seed=seed))
            if p.get("outside"):
                made[1] = tgather.with_outside(made[1], CW)
            bases, lidx, rows, vals, hi, lo = on(made)
            args = (bases, lidx, rows, vals, hi, lo, CW, p["R"])
            li = lidx.view(-1).long()
            inside = (li >= 0) & (li < CW)
            src = bases.view(-1).long().repeat_interleave(TILE) + li
            sp = torch.sparse_coo_tensor(
                torch.stack([rows.view(-1).long()[inside], src[inside]]), vals.view(-1)[inside],
                (p["R"], hi.shape[0]), check_invariants=False).coalesce().to_sparse_csr()
            table = hi.float() + lo.float()
            return (lambda: kgather2.twosided(*args), lambda: kgather2.twosided_torch(*args),
                    ("torch.sparse.mm", lambda: torch.sparse.mm(sp, table)))
        *made, _ = tgather2.inputs_window_pair(TILE, CW, T, U=p["U"], seed=seed)
        if p.get("outside"):
            made[1] = tgather.with_outside(made[1], CW)
        bases, lidx, hi, lo = on(made)
        src = bases.view(-1).long().repeat_interleave(TILE) + lidx.view(-1).long()
        return (lambda: kgather2.window_pair(bases, lidx, hi, lo, CW),
                lambda: kgather2.window_pair_torch(bases, lidx, hi, lo, CW),
                select(hi.float() + lo.float(), src))
    if kernel == "dyngather_take_along":
        idx, table = on(tdyn.inputs(p["C"], p["T"], p["shape"], seed))
        steps, idx_l = p["steps"], idx.long()
        return (lambda: kdyn.take_along(idx, table, steps),
                lambda: kdyn.take_along_torch(idx, table, steps),
                ("torch.gather", lambda: torch.gather(table, 0, idx_l)))
    if kernel == "dyngather_smem_cap":
        x = torch.from_numpy(np.random.default_rng(seed).random((8, 128), np.float32)).to(dev)
        n = p["nbytes"]
        return lambda: kdyn.smem_cap(x, n), lambda: kdyn.smem_cap_torch(x, n), None
    raise ValueError(f"no gather kernel {kernel!r}")


def gather_check(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """The kernel's result against its plain version at the kernel's
    tolerance (GATHER_EXACT bit for bit); returns max |k - p|."""
    torch.cuda.synchronize()
    if kernel in GATHER_EXACT:
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: not bit-exact against the plain version")
        return 0.0
    if kernel == "gather2_twosided":
        return check_norm(got, want, what)
    return check_close(got, want, what)


def gather_rows_check(dev, rows: list) -> None:
    """Every kernel row of a gather tool's run: the kernel against its plain
    version on the row's inputs (the default size, seed 0) and on
    GATHER_SMALL's cases; the plain version's and the library call's times
    (the library's result held to the plain version's as well)."""
    small_err = {}
    with torch.inference_mode():
        for row in rows:
            k = row["kernel"]
            if k is None:
                continue
            run, plain, lib = gather_case(k, dev, 0, **{key: row[key] for key in GATHER_KEYS[k]})
            want = plain()
            row["max_abs_err"] = gather_check(k, run(), want, f"{k} {row['variant']}")
            row["plain_ms"] = time_cuda(plain, iters=3)
            row["library"], row["library_ms"] = None, None
            if lib is not None:  # twosided: lanes summed in another order (normwise)
                (check_norm if k == "gather2_twosided" else check_close)(
                    lib[1](), want, f"{lib[0]} for {k} {row['variant']}")
                row["library"], row["library_ms"] = lib[0], time_cuda(lib[1], iters=10)
            del run, plain, lib, want
            if k not in small_err:
                small_err[k] = 0.0
                for seed, size in enumerate(GATHER_SMALL[k], start=1):
                    run, plain, _ = gather_case(k, dev, seed, **size)
                    at = poison_block(size["C"] if size.get("shape") == "eq" else size["T"],
                                      dev) if k == "dyngather_take_along" else None
                    got = run()
                    if at is not None and got.data_ptr() != at:
                        raise AssertionError(f"{k} {size}: the output is not the poisoned block")
                    small_err[k] = max(small_err[k], gather_check(k, got, plain(),
                                                                  f"{k} {size} seed {seed}"))
                    del got
    for row in rows:
        if row["kernel"] is not None:
            row["max_abs_err"] = max(row["max_abs_err"], small_err[row["kernel"]])


def gather_phase(dev) -> tuple:
    """tools/microbench_gather at its default size through its entry point,
    then its kernels against their plain versions, the plain versions' and
    the library calls' times, and a device-assert probe."""
    calls = WARMUP_CALLS + tgather.ITERS
    rows, launches = run_tool(tgather, {"gather_vmem_loop": len(tgather.VMEM_C) * calls,
                                        "gather_vmem_take": len(tgather.TAKE_C) * calls,
                                        "gather_onehot": 2 * len(tgather.ONEHOT_C) * calls,
                                        "gather_block_slice": calls, "gather_row_dma": calls})
    gather_rows_check(dev, rows)
    expect_device_assert(BAD_GATHER_PROBE, "vmem_take with a row outside the tier")
    return rows, launches


def gather2_phase(dev) -> tuple:
    """tools/microbench_gather2 with its default list plus window and
    twosided, then as gather_phase (the probe: window_pair with a window
    past the table's end)."""
    calls = WARMUP_CALLS + tgather.ITERS
    g = tgather2
    rows, launches = run_tool(g, {"gather_vmem_take": len(g.VTAKE_C) * calls,
                                  "gather_onehot": len(g.SMALL_C) * calls,
                                  "gather2_onehot_pair": len(g.SMALL_C) * calls,
                                  "gather2_take_fused": len(g.FUSED_C) * calls,
                                  "gather2_dma_deep": len(g.DEEP_W) * calls,
                                  "gather2_window_pair": len(g.WINDOW) * calls,
                                  "gather2_twosided": len(g.TWOSIDED) * calls},
                              argv=(*g.DEFAULT, "window", "twosided"))
    gather_rows_check(dev, rows)
    expect_device_assert(BAD_PAIR_WINDOW_PROBE, "window_pair with a window past the table")
    return rows, launches


def dyngather_phase(dev) -> tuple:
    """tools/microbench_dyngather at its default size through its entry
    point (vmem_cap must find the card's opt-in limit: every larger size
    refused), then as gather_phase."""
    calls = WARMUP_CALLS + tdyn.ITERS
    rows, launches = run_tool(tdyn, {"dyngather_take_along": len(tdyn.RUNS) * calls,
                                     "dyngather_smem_cap": 1 + calls})
    cap = next(r for r in rows if r["kernel"] == "dyngather_smem_cap")
    limit = cap["optin_limit"]
    if cap["nbytes"] != limit or any(ok != (n <= limit) for n, ok in cap["tried"]):
        raise AssertionError(f"vmem_cap: sizes {cap['tried']} against the opt-in limit {limit}")
    gather_rows_check(dev, rows)
    # take_along's two paths: shared-memory slices and, past one lane, L2
    lanes = {size["C"]: kdyn.slice_lanes(size["C"], limit)
             for size in GATHER_SMALL["dyngather_take_along"]}
    if not (min(lanes.values()) == 0 < max(lanes.values())):
        raise AssertionError(f"take_along's cases {lanes} do not run both paths")
    for row in rows:
        if row["kernel"] == "dyngather_take_along":
            row["slice_lanes"] = kdyn.slice_lanes(row["C"], limit)
            row["edge_slice_lanes"] = lanes
    expect_device_asserts([(BAD_TAKE_ALONG_PROBE.format(C=C),
                            f"take_along with an index past the table (C={C})")
                           for C in (64, 65536)])
    return rows, launches


def microbench_entry(name: str, rows: list, launches: dict) -> dict:
    """The kernels-line entry of one microbenchmark kernel: its main
    variant's times and bound, and for a TPU one-hot product the count of
    its prescribed multiply-adds (the kernels here run none). The SpMM inner-loop kernels
    list every variant's beside them; the gathers' variants (45 rows) are
    in their tools' phase lines only, which keeps this line under 16 KB."""
    main_row = next(r for r in rows if r["variant"] == MICROBENCH_MAIN[name])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    entry = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name], "launches": launches[name],
             "launches_scope": "one run of the entry point at its default size",
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             **{k: main_row[k] for k in keys}, "library_ms": main_row.get("library_ms"),
             **({"library": main_row["library"]} if main_row.get("library")
                else {"library": LIBRARY_NONE[name]} if name in LIBRARY_NONE else {}),
             **({"onehot_macs": main_row["onehot_macs"]} if "onehot_macs" in main_row else {}),
             "times_scope": f"variant {MICROBENCH_MAIN[name]} at the tool's default size"}
    if "per_pass_ms" in main_row:  # take_along: the library call is one pass
        entry["per_pass_ms"] = main_row["per_pass_ms"]
        entry["library_scope"] = (f"one pass ({main_row['library']}); ms is "
                                  f"{main_row['steps']} passes, per_pass_ms one")
    if "gather" not in tool_of(name):
        entry["variants"] = [{"variant": r["variant"], **{k: r[k] for k in keys},
                              "library_ms": r.get("library_ms"),
                              "fraction_of_bound": r["fraction_of_bound"]} for r in rows]
    return entry


def tool_of(kname: str) -> str:
    """The tool whose entry point drives a microbenchmark kernel."""
    for prefix, tool in (("microbench_blockfma", "microbench_blockfma"),
                         ("gather2_", "microbench_gather2"), ("gather_", "microbench_gather"),
                         ("dyngather_", "microbench_dyngather")):
        if kname.startswith(prefix):
            return tool
    return kname


# ---------------------------------------------------------------------------
# export, the testing harness, autoprof and the entry points
# ---------------------------------------------------------------------------

# a saved program loaded in a fresh python3 (the package imported, nothing
# else): each case's artifact run on its saved inputs, its output saved
# and its launches reported
FRESH_LOAD_PROBE = """
import json, sys, torch
from of_spmm_tpu_torch.export import load_model
from of_spmm_tpu_torch.ops.cuda import build
torch.backends.cuda.matmul.allow_tf32 = False
cases = json.load(open(sys.argv[1]))
for c in cases:
    m = load_model(c["path"])
    args = [torch.load(f, map_location="cuda:0") for f in c["inputs"]]
    with torch.no_grad():
        m(*args)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        y = m(*args)
        torch.cuda.synchronize()
    c["launches"] = {k: n for k, n in build.LAUNCHES.items() if n}
    torch.save(y.cpu(), c["out"])
print(json.dumps(cases))
"""

# the dispatch cost of the ofs ops: the tiered arxiv GCN forward (9
# launches) and a BERT-base masked-LM TrainGraph step (no port kernel), in
# a fresh process on the package at argv[1] (this checkout or a parent's)
OP_OVERHEAD_PROBE = """
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from of_spmm_tpu_torch.data import load_graph, random_features
from of_spmm_tpu_torch.examples import train_bert
from of_spmm_tpu_torch.models import GCN, bert_base, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator
from of_spmm_tpu_torch.ops.cuda import build
from of_spmm_tpu_torch.utils.roofline import time_cuda, wall_ms
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
iters = int(sys.argv[2])
csr, cfg = load_graph("ogbn-arxiv", symmetrize=True)
op = make_operator(normalized_adjacency(csr))
x = torch.from_numpy(random_features(cfg)[0]).to("cuda:0")
model = GCN((128, 256, 256, 40), generator=torch.Generator().manual_seed(0))

def issue_ms(fn, n):
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(ts)

with torch.inference_mode():
    fwd = lambda: model(op, x)
    fwd()
    torch.cuda.synchronize()
    build.reset_launch_counts()
    fwd()
    torch.cuda.synchronize()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    gcn = {"ms": time_cuda(fwd, iters=iters), "wall_ms": wall_ms(fwd, iters=iters),
           "issue_ms": issue_ms(fwd, iters), "launches": launches}
g = train_bert.make_graph(bert_base(generator=torch.Generator().manual_seed(3)), 100, 1e-4)
batch = next(train_bert.batch_stream(8, 128, 30522, torch.device("cuda", 0), seed=1))
step = lambda: g(*batch)
build.reset_launch_counts()
bert = {"ms": time_cuda(step, iters=5), "wall_ms": wall_ms(step, iters=5),
        "launches": {k: n for k, n in build.LAUNCHES.items() if n}}
print(json.dumps({"gcn_forward": gcn, "bert_base_mlm_step": bert}))
"""
EXPORT_LAYOUTS = ("tiered", "panels", "fused", "ranges", "expansion")
OP_OVERHEAD_ITERS = 50
AUTOTEST_ITERS = 10  # autoprof's timed calls per module


def export_case(name: str, fn, args: tuple, root: str, check, tol: str) -> tuple:
    """Export ``fn`` at ``args``, hold ir_stats' ofs nodes against the
    eager launches, save, load in this process, hold the output (``check``
    of loaded against eager) and the launches, and time both. Returns the
    row and what the fresh-process load needs (its case and the eager
    output)."""
    path = os.path.join(root, name)
    with torch.no_grad():
        want, eager_launches = counted(lambda: fn(*args))
        stats = ir_stats(fn, args)
        nodes = {k.split(".", 1)[1]: n for k, n in stats["ops"].items() if k.startswith("ofs.")}
        if nodes != eager_launches:
            raise AssertionError(f"export {name}: ofs nodes {nodes} != eager launches "
                                 f"{eager_launches}")
        t0 = time.perf_counter()
        export_model(fn, args, path, name=name)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_model(path)
        t_load = time.perf_counter() - t0
        loaded(*args)
        got, loaded_launches = counted(lambda: loaded(*args))
        if loaded_launches != eager_launches:
            raise AssertionError(f"export {name}: loaded launches {loaded_launches} != eager "
                                 f"{eager_launches}")
        err = check(got, want, f"export {name}: loaded vs eager")
        row = {"case": name, "ofs_nodes": nodes, "launches": eager_launches,
               "graph_lines": stats["n_lines"], "export_seconds": round(t_export, 3),
               "load_seconds": round(t_load, 3),
               "artifact_bytes": sum(os.path.getsize(os.path.join(path, f))
                                     for f in os.listdir(path)),
               "loaded_err": err, "tolerance": tol,
               "eager": times(lambda: fn(*args), iters=20),
               "loaded": times(lambda: loaded(*args), iters=20)}
    inputs = []
    for i, a in enumerate(args):
        inputs.append(os.path.join(root, f"{name}.in{i}.pt"))
        torch.save(a, inputs[-1])
    case = {"name": name, "path": path, "inputs": inputs,
            "out": os.path.join(root, f"{name}.out.pt")}
    del loaded
    return row, case, want


def export_main_path(a_hat: CSR, cfg, x: torch.Tensor, model) -> dict:
    """The arxiv GCN (GCN_DIMS) on each operator layout, spmm_expansion2 on
    arxiv at d = 128, and the BERT-base encoder with flash=True at B 8,
    T 512 (float32, TF32 off): each exported on the card with its ofs
    nodes counted against the eager launches, saved, loaded here and in a
    fresh python3, and held against the eager output (the kernel bar, or
    max-relative 1e-4 for BERT) with the launches held exactly."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ofs_export_")
    rows, cases, wants = [], [], {}

    def kernel_bar(got, want, what):
        return check_close(got, want, what)

    def rel_bar(got, want, what):
        return rel_errs({"y": got}, {"y": want}, what)["y"]

    try:
        for layout in EXPORT_LAYOUTS:
            lop = make_operator(a_hat, layout=layout)
            row, case, wants[layout] = export_case(
                f"gcn_{layout}", lambda xx, lop=lop: model(lop, xx), (x,), root, kernel_bar,
                "|k-p| <= 1e-5 + 1e-4|p|")
            rows.append({"layout": layout, **row})
            cases.append(case)
            del lop
        e2plan = place_plan(build_expansion2_plan(a_hat), x.device)
        h = torch.randn((cfg.n_nodes, 128), generator=torch.Generator().manual_seed(20))
        h = h.to(x.device)
        row, case, wants["expansion2"] = export_case(
            "spmm_expansion2", lambda xx: spmm_expansion2(e2plan, xx), (h,), root, kernel_bar,
            "|k-p| <= 1e-5 + 1e-4|p|")
        rows.append({"layout": "spmm_expansion2 (d=128)", **row})
        cases.append(case)
        del e2plan, h
        bert = bert_base(generator=torch.Generator().manual_seed(0))
        for b in bert.blocks:
            b.attn.flash = True
        tokens = torch.randint(0, bert.vocab_size, (BERT_BATCH, BERT_SEQ),
                               generator=torch.Generator().manual_seed(21)).to(x.device)
        row, case, wants["bert"] = export_case("bert_base_flash", bert, (tokens,), root,
                                               rel_bar, f"max-relative {MAIN_PATH_REL_TOL}")
        rows.append({"layout": f"bert_base flash=True (B {BERT_BATCH}, T {BERT_SEQ})", **row})
        cases.append(case)
        del bert
        spec = os.path.join(root, "cases.json")
        with open(spec, "w") as f:
            json.dump(cases, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", FRESH_LOAD_PROBE, spec],
                              capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        t_fresh = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fresh-process load failed (rc {proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        for row, c, key in zip(rows, fresh, [*EXPORT_LAYOUTS, "expansion2", "bert"]):
            got = torch.load(c["out"]).to(x.device)
            check = rel_bar if key == "bert" else kernel_bar
            row["fresh_process"] = {"err": check(got, wants[key], f"fresh load {c['name']}"),
                                    "launches": c["launches"]}
            if c["launches"] != row["launches"]:
                raise AssertionError(f"fresh load {c['name']}: launches {c['launches']} != "
                                     f"eager {row['launches']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", dims=GCN_DIMS,
                rows=rows, fresh_process_seconds=round(t_fresh, 2),
                seconds=round(time.perf_counter() - t_phase, 2))


def op_overhead_run(root: str) -> dict:
    """OP_OVERHEAD_PROBE on the package at ``root`` in a fresh python3."""
    proc = subprocess.run([sys.executable, "-c", OP_OVERHEAD_PROBE, root, str(OP_OVERHEAD_ITERS)],
                          capture_output=True, text=True, timeout=600, cwd=root,
                          env={**os.environ, "PYTHONPATH": root})
    if proc.returncode != 0:
        raise AssertionError(f"op_overhead probe on {root} failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def op_overhead_phase(parent) -> dict:
    """The tiered arxiv GCN forward (device, wall and issue ms, launches)
    and a BERT-base masked-LM TrainGraph step, each in a fresh process on
    this checkout and, given ``parent`` (the root of the parent commit's
    checkout), on it too, in the order parent, this, this, parent."""
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    order = [("parent", parent), ("this", here), ("this", here), ("parent", parent)]
    runs = {"this": [], "parent": []}
    for who, root in (order if parent else order[1:2]):
        runs[who].append(op_overhead_run(root))
    for r in runs["this"]:
        if r["gcn_forward"]["launches"] != {"bucket_spmm": 3, "gather_rows": 6}:
            raise AssertionError(f"op_overhead: tiered GCN launches {r['gcn_forward']['launches']}")
    return dict(graph="ogbn-arxiv (synthetic, symmetrized, self-loops)", dims=GCN_DIMS,
                iters=OP_OVERHEAD_ITERS, order=[w for w, _ in order] if parent else ["this"],
                this=runs["this"], parent=runs["parent"] or "not given (--parent DIR)",
                seconds=round(time.perf_counter() - t_phase, 2))


def autotest_modules(dev, gen) -> list:
    """(name, module, inputs, check kwargs) for each converter's class at a
    width its users run, MultiheadAttention(flash=True) at BERT-base's."""
    g = torch.Generator().manual_seed(30)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    E = PAR_EMBED
    return [
        ("Linear", onn.Linear(E, PAR_FFN, device=dev, generator=g), (rand(512, E),), {}),
        ("Conv2d", onn.Conv2d(64, 64, 3, padding=1, device=dev, generator=g),
         (rand(8, 64, 56, 56),), {}),
        ("Conv1d", onn.Conv1d(64, 128, 5, stride=2, device=dev, generator=g),
         (rand(8, 64, 512),), {}),
        ("LayerNorm", onn.LayerNorm(E, device=dev), (rand(8, 128, E),), {}),
        ("BatchNorm", onn.BatchNorm(E, device=dev), (rand(1024, E),), {"train": True}),
        ("Embedding", onn.Embedding(MLM_VOCAB, E, device=dev, generator=g),
         (torch.randint(0, MLM_VOCAB, (8, 128), generator=gen).to(dev),),
         {"int_inputs": True}),
        ("LSTM", onn.LSTM(256, 512, device=dev, generator=g), (rand(64, 16, 256),), {}),
        ("GRU", onn.GRU(256, 512, device=dev, generator=g), (rand(64, 16, 256),), {}),
        ("RNN", onn.RNN(256, 512, device=dev, generator=g), (rand(64, 16, 256),), {}),
        ("MultiheadAttention", MultiheadAttention(E, PAR_HEADS, device=dev, generator=g),
         (rand(BERT_BATCH, BERT_SEQ, E),), {}),
        ("MultiheadAttention(flash=True)",
         MultiheadAttention(E, PAR_HEADS, flash=True, device=dev, generator=g),
         (rand(BERT_BATCH, BERT_SEQ, E),), {}),
        ("MaxPool2d", onn.MaxPool2d(3, stride=2, padding=1), (rand(8, 64, 112, 112),), {}),
        ("AvgPool2d", onn.AvgPool2d(2), (rand(8, 64, 56, 56),), {}),
    ]


def autotest_card_phase(gen, dev=torch.device("cuda", 0)) -> dict:
    """check_module_against_torch on the card for each converter's module
    (forward, input and parameter grads at rtol 1e-4 / atol 1e-5,
    normwise: at these widths a gradient is a sum of thousands of float32
    terms that the port and torch take in different orders), the flash
    MHA's launches counted; then autoprof's table of the same modules."""
    t_phase = time.perf_counter()
    rows, prof = [], []
    for name, module, inputs, kw in autotest_modules(dev, gen):
        _, launched = counted(lambda: check_module_against_torch(module, inputs, norm=True,
                                                                 **kw))
        if ("flash" in name) != bool(launched.get("flash_attention")):
            raise AssertionError(f"autotest {name}: launches {launched}")
        r = profile_module(module, inputs, iters=AUTOTEST_ITERS)
        r.name = name
        prof.append(r)
        rows.append({"module": name, "inputs": [list(t.shape) for t in inputs],
                     "launches": launched, "ours_ms": round(r.ours_ms, 4),
                     "torch_ms": None if r.torch_ms is None else round(r.torch_ms, 4)})
    return dict(tolerance=f"max|k-t| <= {AUTOTEST_ATOL} + {AUTOTEST_RTOL} max|t| (normwise): "
                          "forward, input and parameter grads under one seeded cotangent",
                rows=rows, table=table(prof).splitlines(),
                seconds=round(time.perf_counter() - t_phase, 2))


def entry_main_path_phase() -> dict:
    """entry() on the card with the products-small canary: (2708, 7)
    finite logits, the fused, bucket and flash kernels launched; then
    dryrun_multichip(4) on ShardMesh(["cuda:0"] * 4)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fn, args = entry()
    t_entry = time.perf_counter() - t0
    with torch.no_grad():
        out, launched = counted(lambda: fn(*args))
        fwd = times(lambda: fn(*args), iters=10)
    if tuple(out.shape) != (2708, 7) or not torch.isfinite(out).all():
        raise AssertionError(f"entry: output {tuple(out.shape)} not (2708, 7) or not finite")
    for k in ("fused_spmm", "bucket_spmm", "flash_attention"):
        if not launched.get(k):
            raise AssertionError(f"entry: {k} not launched ({launched})")
    del fn, args
    t0 = time.perf_counter()
    res, dry_launched = counted(lambda: dryrun_multichip(DIST_SHARDS))
    t_dry = time.perf_counter() - t0
    return dict(canary_graph="products-small (synthetic, symmetrized, self-loops)",
                output=list(out.shape), finite=True, launches=launched,
                entry_seconds=round(t_entry, 2), forward=fwd,
                dryrun_multichip={"shards": DIST_SHARDS,
                                  "mesh": f"ShardMesh(['cuda:0'] * {DIST_SHARDS})",
                                  "loss": res["loss"], "pp_loss": res["pp_loss"],
                                  "loss_1f1b": res["loss_1f1b"], "moe_loss": res["moe_loss"],
                                  "launches": dry_launched, "seconds": round(t_dry, 2)},
                seconds=round(time.perf_counter() - t_phase, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA H100.")
    ap.add_argument("--parent", default=None,
                    help="root of the parent commit's checkout: op_overhead runs it too")
    parent = ap.parse_args(argv).parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    if cap != (9, 0):
        raise RuntimeError(f"{name} has compute capability {cap}; the kernels are built for sm_90a")
    peak_bw, peak_fp32 = detect_peak_bw(name), detect_peak_fp32(name)
    peak_t16, peak_tf32 = detect_peak_tensor16(name), detect_peak_tf32(name)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         peak_hbm_gb_s=peak_bw / 1e9, peak_fp32_tflops=peak_fp32 / 1e12,
         peak_bf16_tensor_tflops=peak_t16 / 1e12, peak_tf32_tensor_tflops=peak_tf32 / 1e12)

    # -- 2. build: one nvcc per source, started together, beside the host
    #       planner's g++ build ------------------------------------------------
    t0 = time.perf_counter()
    planner = threading.Thread(target=native.available)
    planner.start()
    kmods = (kernels, pkernels, fkernels, rkernels, ekernels, e2kernels, fakernels, kblockfma,
             kmxu, kcond, kproto, kgather, kgather2, kdyn)
    with ThreadPoolExecutor(len(kmods)) as pool:
        futures = {k.SOURCE: pool.submit(k.build) for k in kmods}
        built = {src: f.result() for src, f in futures.items()}
    for k in kmods:
        k._lib()
    planner.join()
    emit("build", total_seconds=round(time.perf_counter() - t0, 2),
         native_planner=native.available(),
         **{src: {"nvcc_seconds": round(b["seconds"], 2), "library": b["path"],
                  "ptxas": [ln.strip() for ln in b["log"].splitlines()
                            if "registers" in ln or "spill" in ln]}
            for src, b in built.items()})

    max_err = {k: 0.0 for k in SOURCES}

    # -- 3. kernels against their plain versions -------------------------------
    gen = torch.Generator().manual_seed(0)
    n_x, off, R = 60_000, 1_000, 4_093  # R not a multiple of 8: a ragged last block
    for d in FEATURE_WIDTHS:
        x = torch.randn((n_x, d), generator=gen).to(dev)
        for K in BUCKET_WIDTHS:
            cols, vals = random_bucket(R, K, n_x - off, gen, dev)
            buf = torch.full((R + 16, d), float("nan"), device=dev)
            got = kernels.bucket_spmm(cols, vals, x, off, out=buf[8:8 + R])
            want = kernels.bucket_spmm_torch(cols, vals, x, off)
            torch.cuda.synchronize()
            e = check_close(got, want, f"bucket_spmm K={K} d={d}")
            if not (torch.isnan(buf[:8]).all() and torch.isnan(buf[8 + R:]).all()):
                raise AssertionError(f"bucket_spmm K={K} d={d} wrote outside its rows")
            max_err["bucket_spmm"] = max(max_err["bucket_spmm"], e)
        table = torch.randn((100_000, d), generator=gen).to(dev)
        idx = torch.randint(0, 100_000, (50_000,), generator=gen, dtype=torch.int32)
        sentinels = torch.tensor([100_000, -1, 1 << 30, 100_001], dtype=torch.int32)
        idx = torch.cat([idx, sentinels]).to(dev)
        got = kernels.gather_rows(table, idx)
        want = kernels.gather_rows_torch(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or got[-4:].any():
            raise AssertionError(f"gather_rows d={d}: not bit-exact or sentinel rows not zero")
    expect_device_assert(BAD_COLUMN_PROBE, "bucket_spmm with a column outside x")
    emit("kernels", bucket_spmm={"widths": BUCKET_WIDTHS, "d": FEATURE_WIDTHS,
                                 "row_offset": off, "rows": R,
                                 "max_abs_err": max_err["bucket_spmm"],
                                 "tolerance": "|k-p| <= 1e-5 + 1e-4|p|"},
         gather_rows={"d": FEATURE_WIDTHS, "rows": 50_004, "sentinels": 4,
                      "bit_exact": True},
         bad_column="bucket_spmm stopped with a device-side assertion")

    # -- 4. main path: GCN inference on synthetic ogbn-arxiv --------------------
    t0 = time.perf_counter()
    csr, cfg = load_graph("ogbn-arxiv", symmetrize=True)
    a_hat = normalized_adjacency(csr)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = make_operator(a_hat)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    plan = op.binned
    if not isinstance(plan, TieredEll) or not op.transpose_aliased:
        raise AssertionError("ogbn-arxiv should plan as an aliased tiered operator")
    x_np, _ = random_features(cfg)
    x = torch.from_numpy(x_np).to(dev)
    model = GCN(GCN_DIMS, generator=torch.Generator().manual_seed(0))

    n_buckets = sum(len(t.buckets) for t in plan.tiers)
    n_extra = int(plan.finish.extra_rids.shape[0])
    with torch.inference_mode():
        kernels.reset_launch_counts()
        logits = model(op, x)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in SOURCES}
        # one bucket_spmm launch per SpMM, whatever the buckets
        expected.update(bucket_spmm=3, gather_rows=3 * (1 + (n_extra > 0)))
        if launches != expected:
            raise AssertionError(f"main path launches {launches}, expected {expected}")
        want = model(op, x, impl="torch")
        torch.cuda.synchronize()
    if logits.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or wrong shape")
    gcn_err = rel_err(logits, want)
    if gcn_err > MAIN_PATH_REL_TOL:
        raise AssertionError(f"GCN logits vs impl=torch: rel err {gcn_err}")

    # every kernel at the shapes the main path gives it, against its plain
    # version: the whole arxiv plan in one launch (and cut at a small unit
    # cap), a binned and a small tiered plan, at d = 128, 256 and 60
    bucket_plans = [("arxiv tiered", plan, op.work),
                    (f"arxiv tiered, cap {BUCKET_SMALL_CAP}", plan,
                     kernels.bucket_work(plan, BUCKET_SMALL_CAP))]
    bucket_plans += [(name, bop.binned, bop.work) for name, bop in bucket_cases(
        np.random.default_rng(1))]
    with torch.inference_mode():
        for d in FEATURE_WIDTHS:
            for name, bplan, bwork in bucket_plans:
                xd = torch.randn((bplan.shape[1], d), generator=gen).to(dev)
                e = bucket_check(bplan, bwork, xd, f"bucket_spmm {name} d={d}")
                max_err["bucket_spmm"] = max(max_err["bucket_spmm"], e)
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            cat = kernels.bucket_spmm_plan(plan, xd, op.work)
            for idx in (plan.finish.pos, plan.finish.extra_idx):
                if not torch.equal(kernels.gather_rows(cat, idx),
                                   kernels.gather_rows_torch(cat, idx)):
                    raise AssertionError(f"arxiv finish gather d={d} not bit-exact")
        torch.cuda.synchronize()
    bucket_plan_cases = [{"plan": name, "buckets": len(kernels.plan_buckets(bplan)),
                          "units": int(bwork.units.shape[0]), "ell_rows": bwork.n_ell_rows}
                         for name, bplan, bwork in bucket_plans]
    del bucket_plans

    # times: forward, each layer's SpMM, and each kernel over one SpMM at d=128
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: model(op, x), iters=20)
        fwd_wall_ms = wall_ms(lambda: model(op, x), iters=20)
        fwd_plain_ms = time_cuda(lambda: model(op, x, impl="torch"), iters=5)
        spmm_rows = []
        for layer, d in enumerate(GCN_DIMS[:-1]):
            h = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            ms = time_cuda(lambda: spmm_internal(op, h), iters=20)
            rep = spmm_report(ms, SpmmTraffic(a_hat.nnz, cfg.n_nodes, cfg.n_nodes, d),
                              peak_bw)
            spmm_rows.append({"layer": layer, "d": d, **{k: round(v, 4) for k, v in rep.items()}})
    emit("main_path", graph="ogbn-arxiv (synthetic, symmetrized, self-loops)",
         n_nodes=cfg.n_nodes, nnz=a_hat.nnz, dims=GCN_DIMS, layout="tiered",
         buckets=n_buckets,
         cold_buckets=sum(len(t.buckets) for t in plan.tiers if t.tier < 0),
         ell_rows=plan.n_ell_rows, finish_extras=n_extra, bucket_load=bucket_load(plan, op.work),
         bucket_plan_cases=bucket_plan_cases,
         graph_seconds=round(t_graph, 2), plan_seconds=round(t_plan, 2),
         launches_per_forward=launches,
         logits_rel_err_vs_torch=gcn_err, forward_ms=round(fwd_ms, 4),
         forward_wall_ms=round(fwd_wall_ms, 4), forward_plain_ms=round(fwd_plain_ms, 4),
         spmm=spmm_rows)

    # the small-input reference: cora (binned, relabeled) against a dense
    # float64 forward on the host
    ccsr, ccfg = load_graph("cora", symmetrize=True)
    ca = normalized_adjacency(ccsr)
    cop = make_operator(ca)
    cx_np, _ = random_features(ccfg)
    cmodel = GCN((ccfg.feature_dim, 64, ccfg.n_classes),
                 generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        kernels.reset_launch_counts()
        clog = cmodel(cop, torch.from_numpy(cx_np).to(dev)).cpu().double()
        cora_launches = dict(kernels.LAUNCHES)
    dense = ca.to_dense().astype(np.float64)
    h = cx_np.astype(np.float64)
    for i, layer in enumerate(cmodel.layers):
        w, bias = (p.detach().cpu().double().numpy() for p in (layer.w, layer.b))
        h = dense @ h @ w + bias
        if i < len(cmodel.layers) - 1:
            h = np.maximum(h, 0.0)
    cora_err = rel_err(clog, torch.from_numpy(h))
    if cora_err > MAIN_PATH_REL_TOL or cora_launches["bucket_spmm"] == 0:
        raise AssertionError(f"cora GCN vs dense float64: rel err {cora_err}, {cora_launches}")
    emit("reference", graph="cora", layout="binned (relabeled)", dims=cmodel.feature_dims,
         rel_err_vs_dense_float64=cora_err, launches=cora_launches)

    a_fig = kernel_figures(plan, op.work, cfg.n_nodes, 128, gen, peak_bw, peak_fp32)
    h = torch.randn((cfg.n_nodes, 128), generator=gen).to(dev)
    with torch.inference_mode():
        h_want = torch.cat([kernels.bucket_spmm_torch(c, v, h, o)
                            for c, v, o in kernels.plan_buckets(plan)])
    emit("kernel_times", graph="ogbn-arxiv", **a_fig,
         bucket_cap_sweep=bucket_cap_sweep(plan, h, h_want))
    del h, h_want

    # -- 5. scale: one SpMM on products-small ---------------------------------
    t0 = time.perf_counter()
    pcsr, pcfg = load_graph("products-small", symmetrize=True)
    pa = normalized_adjacency(pcsr)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    pop = make_operator(pa)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    if not isinstance(pop.binned, TieredEll):
        raise AssertionError("products-small should plan as tiered")
    px = torch.randn((pcfg.n_nodes, 128), generator=gen).to(dev)
    with torch.inference_mode():
        py = spmm_internal(pop, px)
        py_plain = spmm_internal(pop, px, impl="torch")
        torch.cuda.synchronize()
        p_err = rel_err(py, py_plain)
        if p_err > MAIN_PATH_REL_TOL or not torch.isfinite(py).all():
            raise AssertionError(f"products-small SpMM vs impl=torch: rel err {p_err}")
        p_ms = time_cuda(lambda: spmm_internal(pop, px), iters=20)
        p_plain_ms = time_cuda(lambda: spmm_internal(pop, px, impl="torch"), iters=3)
    pcoo = pa.to_coo()
    p_sparse = torch_csr(pa, dev)
    p_lib_err = rel_err(torch.sparse.mm(p_sparse, px), py_plain)
    p_lib_ms = time_cuda(lambda: torch.sparse.mm(p_sparse, px), iters=20)
    rep = spmm_report(p_ms, SpmmTraffic(pcoo.nnz, pcfg.n_nodes, pcfg.n_nodes, 128), peak_bw)
    emit("scale", graph="products-small (synthetic, symmetrized, self-loops)",
         n_nodes=pcfg.n_nodes, nnz=pa.nnz, d=128, layout="tiered",
         buckets=sum(len(t.buckets) for t in pop.binned.tiers),
         graph_seconds=round(t_graph, 2), plan_seconds=round(t_plan, 2),
         rel_err_vs_torch=p_err, spmm_ms=p_ms, plain_ms=p_plain_ms,
         torch_sparse_mm_ms=p_lib_ms, torch_sparse_mm_rel_err=p_lib_err,
         **{k: round(v, 4) for k, v in rep.items() if k != "ms"})
    with torch.inference_mode():
        p_cat = torch.cat([kernels.bucket_spmm_torch(c, v, px, o)
                           for c, v, o in kernels.plan_buckets(pop.binned)])
    emit("kernel_times", graph="products-small",
         **kernel_figures(pop.binned, pop.work, pcfg.n_nodes, 128, gen, peak_bw, peak_fp32),
         bucket_load=bucket_load(pop.binned, pop.work),
         bucket_cap_sweep=bucket_cap_sweep(pop.binned, px, p_cat))
    del p_cat

    # -- 6. the panel kernel against its plain version -------------------------
    rng = np.random.default_rng(0)
    cases = []
    with torch.inference_mode():
        for case, pcase in panel_cases(rng):
            for d in PANEL_WIDTHS:
                xd = torch.randn((pcase.shape[1], d), generator=gen).to(dev)
                got = pkernels.panel_spmm(pcase, xd)
                want = pkernels.panel_spmm_torch(pcase, xd)
                torch.cuda.synchronize()
                e = check_close(got, want, f"panel_spmm {case} d={d}")
                max_err["panel_spmm"] = max(max_err["panel_spmm"], e)
            cases.append({"case": case, "shape": list(pcase.shape), "T": pcase.T,
                          "hot": pcase.n_hot, "ranges": pcase.n_ranges,
                          "segments": len(pcase.segments), "direct": pcase.n_direct,
                          "S_buf": pcase.S_buf, "per_edge": pcase.per_edge,
                          "units": sum(int(s.windows.units.shape[0]) for s in pcase.segments),
                          "split_tiles": sum(int(s.windows.split_tiles.shape[0])
                                             for s in pcase.segments)})
            del pcase
    expect_device_assert(BAD_WINDOW_PROBE, "panel_spmm with a window row outside x")
    emit("panel_kernel", d=PANEL_WIDTHS, cases=cases, max_abs_err=max_err["panel_spmm"],
         tolerance="|k-p| <= 1e-5 + 1e-4|p|",
         bad_window_row="panel_spmm stopped with a device-side assertion")

    # -- 7. main path on the panel engine: GCN inference on ogbn-arxiv ---------
    # plan, window provenance, mask expansion and the whole placement
    # (both of those and the copies) timed apart, then the user's entry
    # point drives it
    t0 = time.perf_counter()
    pan_plan = build_panels_plan(a_hat)
    t_pplan = time.perf_counter() - t0
    load = tile_load(pan_plan)
    t0 = time.perf_counter()
    windowed = attach_windows(pan_plan)
    t_pwin = time.perf_counter() - t0
    t0 = time.perf_counter()
    ensure_masks(windowed, dev)
    torch.cuda.synchronize()
    t_pexp = time.perf_counter() - t0
    del windowed
    t0 = time.perf_counter()
    place_operator(SpmmOperator(binned=pan_plan, binned_t=pan_plan, shape=a_hat.shape), dev)
    torch.cuda.synchronize()
    t_pplace = time.perf_counter() - t0
    del pan_plan
    t0 = time.perf_counter()
    pan_op = make_operator(a_hat, layout="panels")
    torch.cuda.synchronize()
    t_pop = time.perf_counter() - t0
    pp = pan_op.binned
    if not isinstance(pp, PanelPlan) or not pan_op.transpose_aliased or pp.per_edge:
        raise AssertionError("ogbn-arxiv should plan as an aliased rank-1 panel operator")
    n_seg = len(pp.segments)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        plogits = model(pan_op, x)
        torch.cuda.synchronize()
        pan_launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in SOURCES}
        expected["panel_spmm"] = 3 * n_seg
        if pan_launches != expected:
            raise AssertionError(f"panel main path launches {pan_launches}, expected {expected}")
        pwant = model(pan_op, x, impl="torch")
        torch.cuda.synchronize()
    if plogits.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(plogits).all():
        raise AssertionError(f"panel logits {tuple(plogits.shape)} not finite or wrong shape")
    p_vs_plain, p_vs_tiered = rel_err(plogits, pwant), rel_err(plogits, logits)
    if p_vs_plain > MAIN_PATH_REL_TOL or p_vs_tiered > MAIN_PATH_REL_TOL:
        raise AssertionError(f"panel GCN logits: rel err {p_vs_plain} vs impl=torch, "
                             f"{p_vs_tiered} vs the tiered CUDA path")
    with torch.inference_mode():
        # the kernel at the shapes the main path gives it
        for d in sorted(set(GCN_DIMS[:-1])):
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            e = check_close(pkernels.panel_spmm(pp, xd), pkernels.panel_spmm_torch(pp, xd),
                            f"arxiv panel_spmm d={d}")
            max_err["panel_spmm"] = max(max_err["panel_spmm"], e)
        torch.cuda.synchronize()
        pfwd_ms = time_cuda(lambda: model(pan_op, x), iters=20)
        pfwd_wall_ms = wall_ms(lambda: model(pan_op, x), iters=20)
        pspmm_rows = []
        for layer, d in enumerate(GCN_DIMS[:-1]):
            h = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            ms = time_cuda(lambda: spmm_internal(pan_op, h), iters=20)
            rep = spmm_report(ms, SpmmTraffic(a_hat.nnz, cfg.n_nodes, cfg.n_nodes, d), peak_bw)
            pspmm_rows.append({"layer": layer, "d": d,
                               **{k: round(v, 4) for k, v in rep.items()}})
    x_rows = int(np.unique(a_hat.cols).size)
    pan_fig = panel_figures(pp, torch_csr(a_hat, dev), x_rows, a_hat.nnz, 128, gen,
                            peak_bw, peak_fp32)
    emit("panels_main_path", graph="ogbn-arxiv (synthetic, symmetrized, self-loops)",
         n_nodes=cfg.n_nodes, nnz=a_hat.nnz, dims=GCN_DIMS, layout="panels", T=pp.T,
         hot_rows=pp.n_hot, RC=pp.RC, ranges=pp.n_ranges, segments=n_seg,
         steps=sum(s.n_steps for s in pp.segments),
         group_slots_real=PanelTraffic.from_plan(pp, 128, x_rows, a_hat.nnz).real_slots,
         group_slots_total=sum(int(s.masks.shape[0]) for s in pp.segments),
         mask_bytes=sum(int(s.masks.numel()) * 4 for s in pp.segments),
         plan_seconds=round(t_pplan, 4), windows_seconds=round(t_pwin, 4),
         mask_expansion_seconds=round(t_pexp, 4), placement_seconds=round(t_pplace, 4),
         make_operator_seconds=round(t_pop, 4), tile_load=load,
         launches_per_forward=pan_launches,
         logits_rel_err_vs_torch=p_vs_plain, logits_rel_err_vs_tiered=p_vs_tiered,
         forward_ms=round(pfwd_ms, 4), forward_wall_ms=round(pfwd_wall_ms, 4),
         tiered_forward_ms=round(fwd_ms, 4), tiered_forward_wall_ms=round(fwd_wall_ms, 4),
         spmm=pspmm_rows)
    h = torch.randn((cfg.n_nodes, 128), generator=gen).to(dev)
    with torch.inference_mode():
        h_want = pkernels.panel_spmm_torch(pp, h)
    emit("panel_kernel_times", graph="ogbn-arxiv", **pan_fig,
         unit_cap_sweep=unit_cap_sweep(pp, h, h_want))
    del h, h_want

    # -- 8. panel engine at scale: one SpMM on products-small -----------------
    t0 = time.perf_counter()
    pan_pop = make_operator(pa, layout="panels")
    torch.cuda.synchronize()
    t_pop = time.perf_counter() - t0
    ppp = pan_pop.binned
    with torch.inference_mode():
        y = spmm_internal(pan_pop, px)
        y_plain = spmm_internal(pan_pop, px, impl="torch")
        y_lib = torch.sparse.mm(p_sparse, px)
        torch.cuda.synchronize()
    pp_err, pp_lib_err = rel_err(y, y_plain), rel_err(y, y_lib)
    if pp_err > MAIN_PATH_REL_TOL or pp_lib_err > MAIN_PATH_REL_TOL or not torch.isfinite(y).all():
        raise AssertionError(f"products-small panel SpMM: rel err {pp_err} vs impl=torch, "
                             f"{pp_lib_err} vs torch.sparse.mm")
    ps_fig = panel_figures(ppp, p_sparse, int(np.unique(pa.cols).size), pa.nnz, 128, gen,
                           peak_bw, peak_fp32)
    emit("panels_scale", graph="products-small (synthetic, symmetrized, self-loops)",
         n_nodes=pcfg.n_nodes, nnz=pa.nnz, layout="panels", T=ppp.T,
         hot_rows=ppp.n_hot, ranges=ppp.n_ranges, segments=len(ppp.segments),
         steps=sum(s.n_steps for s in ppp.segments),
         group_slots_total=sum(int(s.masks.shape[0]) for s in ppp.segments),
         make_operator_seconds=round(t_pop, 2), rel_err_vs_torch=pp_err,
         rel_err_vs_torch_sparse_mm=pp_lib_err, tiered_spmm_ms=p_ms,
         units=sum(int(s.windows.units.shape[0]) for s in ppp.segments),
         split_tiles=sum(int(s.windows.split_tiles.shape[0]) for s in ppp.segments),
         **ps_fig, unit_cap_sweep=unit_cap_sweep(ppp, px, y_plain))

    # -- 9.-14. the fused and ranges engines: their kernel against its plain
    #           version on small plans of every shape, GCN inference on arxiv,
    #           one products-small SpMM ------------------------------------------
    staged_launches, staged_figs = {}, {}
    unshuffled_spmm_ms = {"panels": pspmm_rows[0]["ms"]}  # d = 128, for the reorder phase
    for engine in STAGED:
        kmod = STAGED[engine][0]
        kname = f"{engine}_spmm"
        cases = []
        with torch.inference_mode():
            for case, scase in staged_cases(engine, rng):
                for d in STAGED_WIDTHS:
                    xd = torch.randn((scase.shape[1], d), generator=gen).to(dev)
                    got = getattr(kmod, kname)(scase, xd)
                    want = getattr(kmod, f"{kname}_torch")(scase, xd)
                    torch.cuda.synchronize()
                    max_err[kname] = max(max_err[kname],
                                         check_close(got, want, f"{kname} {case} d={d}"))
                cases.append({"case": case, "shape": list(scase.shape), **plan_shape(scase)})
                del scase
        if engine == "ranges":
            expect_device_assert(BAD_STAGED_PROBE, "ranges_spmm with a window row outside x")
        emit(f"{engine}_kernel", d=STAGED_WIDTHS, cases=cases, max_abs_err=max_err[kname],
             tolerance="|k-p| <= 1e-5 + 1e-4|p|",
             **({"bad_window_row": "ranges_spmm stopped with a device-side assertion"}
                if engine == "ranges" else {}))
        launches_e, err, fields, fig = staged_main_path(engine, a_hat, cfg, x, model, logits,
                                                        gen, peak_bw, peak_fp32)
        max_err[kname] = max(max_err[kname], err)
        staged_launches[kname] = launches_e
        staged_figs[kname] = fig
        unshuffled_spmm_ms[engine] = fields["spmm"][0]["ms"]
        emit(f"{engine}_main_path", **fields, tiered_forward_ms=round(fwd_ms, 4),
             panels_forward_ms=round(pfwd_ms, 4))
        emit(f"{engine}_kernel_times", graph="ogbn-arxiv", **fig)
        scale = staged_scale(engine, pa, px, p_sparse, gen, peak_bw, peak_fp32)
        emit(f"{engine}_scale", **scale, tiered_spmm_ms=p_ms, panels_spmm_ms=ps_fig["ms"])

    # -- 15.-19. the expansion engines: both kernels against their plain
    #            versions on small plans of every shape, GCN inference on
    #            arxiv through layout="expansion", one products-small SpMM,
    #            and spmm_expansion2 on arxiv and products-small -------------
    cases = []
    with torch.inference_mode():
        for kname, case, ecase in expansion_cases(rng):
            kernel, plain = EXPANSION[kname]
            for d in EXPANSION_WIDTHS:
                xd = torch.randn((ecase.shape[1], d), generator=gen).to(dev)
                got, want = kernel(ecase, xd), plain(ecase, xd)
                torch.cuda.synchronize()
                max_err[kname] = max(max_err[kname],
                                     check_close(got, want, f"{kname} {case} d={d}"))
            cases.append({"kernel": kname, "case": case, "shape": list(ecase.shape),
                          **expansion_shape(ecase)})
            del ecase
    for v in ("", "2"):
        expect_device_assert(BAD_EXPANSION_PROBE.format(v=v),
                             f"expansion{v}_spmm with a staged row outside x")
    emit("expansion_kernel", d=EXPANSION_WIDTHS, cases=cases,
         max_abs_err={k: max_err[k] for k in EXPANSION}, tolerance="|k-p| <= 1e-5 + 1e-4|p|",
         bad_staged_row="expansion_spmm and expansion2_spmm stopped with a device-side assertion")
    exp_launches, err, fields, exp_fig = expansion_main_path(a_hat, cfg, x, model, logits, gen,
                                                             peak_bw, peak_fp32)
    max_err["expansion_spmm"] = max(max_err["expansion_spmm"], err)
    emit("expansion_main_path", **fields, tiered_forward_ms=round(fwd_ms, 4),
         panels_forward_ms=round(pfwd_ms, 4))
    emit("expansion_kernel_times", graph="ogbn-arxiv", **exp_fig)
    emit("expansion_scale", **expansion_scale(pa, px, p_sparse, gen, peak_bw, peak_fp32),
         tiered_spmm_ms=p_ms)
    e2_launches, err, fields, e2_fig = expansion2_run(
        "ogbn-arxiv (synthetic, symmetrized, self-loops)", a_hat, op, (128, 256), gen, peak_bw,
        peak_fp32, sweep=True)
    max_err["expansion2_spmm"] = max(max_err["expansion2_spmm"], err)
    emit("expansion2", **fields, expansion_spmm_ms=exp_fig["ms"])
    emit("expansion2_kernel_times", graph="ogbn-arxiv", **e2_fig)
    _, err, fields, e2p_fig = expansion2_run(
        "products-small (synthetic, symmetrized, self-loops)", pa, pop, (128,), gen, peak_bw,
        peak_fp32)
    max_err["expansion2_spmm"] = max(max_err["expansion2_spmm"], err)
    emit("expansion2_scale", **fields)
    emit("expansion2_kernel_times", graph="products-small", **e2p_fig)
    del pop, pa, px, p_sparse

    # -- 20.-21. training: GCN on arxiv on every layout (aliased transpose
    #            plans) and the example's train; GraphSAGE on arxiv's mean
    #            adjacency (built transpose plans) and one GAT step on cora --
    y = torch.from_numpy(random_features(cfg)[1]).long().to(dev)
    fields, train_launches = train_main_path(a_hat, cfg, x, y, gen)
    emit("train_main_path", **fields)
    fields, sage_launches = sage_train(csr, cfg, x, y, gen)
    emit("sage_train", **fields)

    # -- 21a.-21b. the training stack: the GCN example's TrainGraph on the
    #             tiered arxiv operator, fp32 and AMP; the BERT example and
    #             BERT-base masked LM through TrainGraph (no port kernel) ----
    fields, graph_launches = train_graph_gcn(op, cfg, x, y)
    emit("train_graph_gcn", **fields)
    fields, launched = counted(lambda: train_bert_phase(gen))
    if launched:
        raise AssertionError(f"train_bert launched port kernels: {launched}")
    emit("train_bert", **fields, kernel_launches=launched)

    # -- 22.-23. the locality reorder: GCN inference on shuffled arxiv
    #            through make_operator(reorder="match") on panels, fused and
    #            ranges; SpGEMM: the arxiv 2-hop product, host and card --
    fields, reorder_launches, errs = reorder_main_path(a_hat, cfg, x, y, model, logits,
                                                       unshuffled_spmm_ms, gen)
    for k, e in errs.items():
        max_err[k] = max(max_err[k], e)
    emit("reorder_main_path", **fields)
    emit("spgemm", **spgemm_phase(csr, gen, peak_bw))

    # -- 24. the distributed SpMM: arxiv in DIST_SHARDS shards on one card,
    #        four partition plans, GCN inference and a training step on them,
    #        and the rank form over NCCL at world size 1 --------------------
    fields, dist_launches = dist_main_path(a_hat, cfg, op, x, y, model, logits, gen)
    emit("dist_main_path", **fields)

    # -- 25. the distributed training example: arxiv in TRAIN_DIST_SHARDS
    #        shards on one card, its loop, and main through the launcher --
    fields, td_launches = train_dist_phase("ogbn-arxiv", a_hat, cfg, x, y)
    dist_launches["bucket_spmm"]["train_dist_loop"] = td_launches["bucket_spmm"]
    emit("train_dist", **fields)

    # -- 26.-29. the attention path: the flash kernel against its plain
    #            version, BERT-base inference with every block's attention
    #            run again through MultiheadAttention(flash=True), one
    #            block's gradients, the kernel at BERT-base's shape ---------
    fcases = flash_kernel_cases(gen)
    max_err["flash_attention"] = fcases["max_abs_err"]["float32"]
    emit("flash_kernel", **fcases)
    fa_launches, fields, fa_mha, fa_x, dense_mha = transformer_main_path(gen)
    emit("transformer_main_path", **fields)
    emit("flash_grad", **flash_grad(fa_mha, dense_mha, fa_x))
    del fa_mha, fa_x, dense_mha
    fa_rows = flash_scale(gen, peak_bw, peak_fp32, peak_t16, peak_tf32)
    emit("flash_scale", rows=fa_rows)
    fa_main = next(r for r in fa_rows if r["dtype"] == "float32" and not r["causal"])
    max_err["flash_attention"] = max(max_err["flash_attention"],
                                     max(r["max_abs_err"] for r in fa_rows
                                         if r["dtype"] == "float32"))

    # -- 30.-33. the parallel strategies on PAR_SHARDS shards of the card:
    #            Ulysses and the ring, the TP MLP and the MoE layer, the
    #            GPipe and 1F1B pipeline, DDP, the global view, the rank
    #            form at NCCL world size 1 --------------------------------------
    # (no Pallas kernel of the JAX package is on these paths, so the port
    # launches none of its kernels there)
    for name, phase in (("parallel_attention", parallel_attention_phase),
                        ("parallel_mlp", parallel_mlp_phase),
                        ("parallel_pipeline", parallel_pipeline_phase),
                        ("parallel_ddp_global", parallel_ddp_global_phase)):
        fields, launched = counted(lambda: phase(gen))
        if launched:
            raise AssertionError(f"{name} launched port kernels: {launched}")
        emit(name, **fields, kernel_launches=launched)

    # -- 33a.-33c. the vision path: ResNet-50, VGG16 and AlexNet at ImageNet
    #             width, and each module of nn/ on the card against the CPU
    # (the JAX package computes these with XLA outside any Pallas kernel, so
    # the port launches none of its kernels there)
    vision = {}
    for name, phase in (("resnet_main_path", lambda: resnet_main_path(gen, peak_fp32)),
                        ("vision_models", lambda: vision_models_phase(gen, peak_fp32)),
                        ("nn_modules", lambda: nn_modules_phase(gen))):
        fields, launched = counted(phase)
        if launched:
            raise AssertionError(f"{name} launched port kernels: {launched}")
        vision[name] = fields
        emit(name, **fields, kernel_launches=launched)

    # -- 33d.-33f. the embedding path and the input pipeline: the sharded
    #             lookup at DLRM's Criteo Terabyte table, the tiered cache
    #             under a power-law id stream, ResNet-50 trained from record
    #             files (no kernel of the port: each phase holds its launches
    #             at none, but for sharded_embedding's gather_rows comparison,
    #             counted apart)
    emit("sharded_embedding", **sharded_embedding_phase(gen, peak_bw))
    emit("one_embedding_main_path", **one_embedding_main_path())
    emit("records_input_pipeline",
         **records_input_pipeline(vision["resnet_main_path"]["train_step_ms"]))

    # -- 33g.-33j. export with the kernels kept in the saved program (in
    #             this process and a fresh one), the ops' dispatch cost
    #             beside the parent commit's (--parent DIR), the testing
    #             harness and autoprof on the card, the entry points
    emit("export_main_path", **export_main_path(a_hat, cfg, x, model))
    emit("op_overhead", **op_overhead_phase(parent))
    emit("autotest_card", **autotest_card_phase(gen))
    emit("entry_main_path", **entry_main_path_phase())

    # -- 34.-40. the microbenchmarks: each tool's entry point at its
    #            default size, then its kernels against their plain
    #            versions -------------------------------------------------------
    micro = {}
    gather_tol = ("bit-exact: row gathers, one-hot products, take_along, smem_cap; "
                  "|k-p| <= 1e-5 + 1e-4|p|: ELL forms, block_slice; "
                  f"max|k-p| <= {MICROBENCH_NORM_TOL} max|p|: twosided")
    for tool, phase in (("microbench_blockfma", blockfma_phase), ("microbench_mxu", mxu_phase),
                        ("microbench_cond", cond_phase), ("proto_fused", proto_phase),
                        ("microbench_gather", gather_phase),
                        ("microbench_gather2", gather2_phase),
                        ("microbench_dyngather", dyngather_phase)):
        t0 = time.perf_counter()
        rows, tool_launches = phase(dev)
        micro[tool] = (rows, tool_launches)
        emit(tool, seconds=round(time.perf_counter() - t0, 2),
             launches={k: n for k, n in tool_launches.items() if n},
             tolerance=("|k-p| <= 1e-5 + 1e-4|p|" if tool in ("microbench_blockfma", "proto_fused")
                        else gather_tol if "gather" in tool
                        else f"max|k-p| <= {MICROBENCH_NORM_TOL} max|p|"),
             rows=rows)

    # -- 41. the kernels, 42. the card, 43. the result ------------------------
    # launches: one GCN forward (three SpMMs) on the kernel's engine, or
    # (expansion2) the two arxiv SpMMs of its entry point; the times and
    # the bound: all launches of one SpMM at d=128, launches_per_spmm of
    # them
    figs = {"bucket_spmm": {**a_fig["bucket_spmm"], "d": a_fig["d"]},
            "gather_rows": {**a_fig["gather_rows"], "d": a_fig["d"]},
            "panel_spmm": pan_fig, **staged_figs, "expansion_spmm": exp_fig,
            "expansion2_spmm": e2_fig}
    scopes = {"bucket_spmm": ("one GCN forward on ogbn-arxiv (tiered)", launches),
              "gather_rows": ("one GCN forward on ogbn-arxiv (tiered)", launches),
              "panel_spmm": ("one GCN forward on ogbn-arxiv (layout='panels')", pan_launches),
              **{f"{e}_spmm": (f"one GCN forward on ogbn-arxiv (layout='{e}')",
                               staged_launches[f"{e}_spmm"]) for e in STAGED},
              "expansion_spmm": ("one GCN forward on ogbn-arxiv (layout='expansion')",
                                 exp_launches),
              "expansion2_spmm": ("spmm_expansion2 on ogbn-arxiv at d=128 and d=256",
                                  e2_launches)}
    entries = [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": scopes[k][1][k], "launches_scope": scopes[k][0],
         "max_abs_err": max_err[k],
         **{f: figs[k][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "launches_per_spmm": figs[k]["launches"],
         "times_scope": f"one SpMM on ogbn-arxiv at d={figs[k]['d']}",
         **({"train_launches": train_launches[TRAIN_KERNELS[k]][k],
             "sage_train_launches": sage_launches[TRAIN_KERNELS[k]][k],
             "train_launches_scope": f"one training step on ogbn-arxiv "
                                     f"(layout='{TRAIN_KERNELS[k]}'): GCN, GraphSAGE"}
            if k in TRAIN_KERNELS else {}),
         **({"graph_train_launches": graph_launches[k],
             "graph_train_launches_scope": "one TrainGraph step of the GCN example on "
                                           "ogbn-arxiv (tiered), fp32 and AMP alike"}
            if k in ("bucket_spmm", "gather_rows") else {}),
         **({"reorder_launches": reorder_launches[k],
             "reorder_launches_scope": "one GCN forward on shuffled ogbn-arxiv through "
                                       f"make_operator(reorder='{REORDER_METHOD}')"}
            if k in reorder_launches else {}),
         **({"dist_launches": dist_launches[k],
             "dist_launches_scope": f"dist_spmm on ogbn-arxiv in {DIST_SHARDS} shards: per "
                                    "plan one forward and one backward at d=128; gcn_<plan> "
                                    "one dist_gcn_apply; train_step_P1 one training step; "
                                    f"train_dist_loop {TRAIN_DIST_STEPS} steps of the "
                                    "distributed example (hidden 32)"}
            if k in dist_launches else {})}
        for k in SOURCES if k not in MICROBENCH_MAIN and k != "flash_attention"]
    entries.append(
        {"name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"],
         "replaces": REPLACES["flash_attention"],
         "launches": sum(m["flash_attention"] for m in fa_launches.values()),
         "launches_scope": "every BERT-base block's attention input through "
                           "MultiheadAttention(flash=True), non-causal and causal "
                           "(12 launches each)",
         "max_abs_err": max_err["flash_attention"],
         **{f: fa_main[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "bound_term": fa_main["bound_term"],
         "max_abs_err_by_dtype": fcases["max_abs_err"],
         "times_scope": "one call at (BH, T, d) = (96, 512, 64), float32, non-causal",
         "by_dtype": {f"{r['dtype']}{' causal' if r['causal'] else ''}":
                      {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_term",
                                         "library_ms", "fraction_of_bound")}
                      for r in fa_rows}})
    for kname, variant in MICROBENCH_MAIN.items():
        tool = tool_of(kname)
        rows, tool_launches = micro[tool]
        if tool == "microbench_blockfma":
            rows = [r for r in rows if r["variant"] == variant]
        elif "gather" in tool:
            rows = [r for r in rows if r["kernel"] == kname]
        entries.append(microbench_entry(kname, rows, tool_launches))
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
