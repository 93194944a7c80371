#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (of_spmm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with the card

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

Then the attention path: the flash-attention kernel against its plain
version on small cases (float32, bfloat16, float16), BERT-base inference
(bert_base -> TransformerEncoder.forward, seeded weights, B = 8,
T = 512, float32 with TF32 off) whose every block's attention input is
run again through MultiheadAttention(flash=True) with the block's own
parameters, non-causal and causal, against the dense attention; one
block's gradients through flash=True against the dense core; and the
kernel alone at BERT-base's attention shape.

Last, the SpMM inner-loop microbenchmarks (of_spmm_tpu_torch/tools/:
microbench_blockfma, microbench_mxu, microbench_cond, proto_fused): each
tool's entry point at its default size, the TPU tool's full width, then
its kernels against their plain versions on two small seeded cases and
the default inputs.

Each phase prints one JSON line. Before the last line come the
``{"kernels": [...]}`` summary and the card's name and power limit as
nvidia-smi reports them; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.data import load_graph, random_features
from of_spmm_tpu_torch.models import GCN, bert_base, normalized_adjacency
from of_spmm_tpu_torch.nn import MultiheadAttention
from of_spmm_tpu_torch.ops import (
    make_operator, place_operator, place_plan, spmm_expansion2, spmm_internal)
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import expansion as ekernels
from of_spmm_tpu_torch.ops.cuda import expansion2 as e2kernels
from of_spmm_tpu_torch.ops.cuda import flash_attention as fakernels
from of_spmm_tpu_torch.ops.cuda import fused as fkernels
from of_spmm_tpu_torch.ops.cuda import microbench_blockfma as kblockfma
from of_spmm_tpu_torch.ops.cuda import microbench_cond as kcond
from of_spmm_tpu_torch.ops.cuda import microbench_mxu as kmxu
from of_spmm_tpu_torch.ops.cuda import panels as pkernels
from of_spmm_tpu_torch.ops.cuda import proto_fused as kproto
from of_spmm_tpu_torch.ops.cuda import ranges as rkernels
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
from of_spmm_tpu_torch.ops.flash_attention import flash_attention
from of_spmm_tpu_torch.sparse import staged_windows
from of_spmm_tpu_torch.sparse.expansion import (
    ExpansionPlan, attach_stage_rows, build_expansion_plan, plan_memory_report)
from of_spmm_tpu_torch.sparse.expansion2 import build_expansion2_plan
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.fused import FusedPlan, build_fused_plan
from of_spmm_tpu_torch.sparse.panels import (
    C_SBIG, C_TFIRST, C_TILE, PanelPlan, attach_windows, build_panels_plan, ensure_masks)
from of_spmm_tpu_torch.sparse.ranges import RangesPlan, build_ranges_plan
from of_spmm_tpu_torch.sparse.tiled import TieredEll
from of_spmm_tpu_torch.tools import microbench_blockfma as tblockfma
from of_spmm_tpu_torch.tools import microbench_cond as tcond
from of_spmm_tpu_torch.tools import microbench_mxu as tmxu
from of_spmm_tpu_torch.tools import proto_fused as tproto
from of_spmm_tpu_torch.utils.roofline import (
    AttentionTraffic, ExpansionTraffic, PanelTraffic, SpmmTraffic, StagedTraffic, detect_peak_bw,
    WARMUP_CALLS, detect_peak_fp32, detect_peak_tensor16, spmm_report, time_cuda, wall_ms)

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
MAIN_PATH_REL_TOL = 1e-4
# flash_attention against its plain version, |k - p| <= atol + rtol |p| in
# the working type: bf16 / fp16 are looser because the kernel sums in
# another order and rounds P to that type before P V
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2),
             torch.float16: (1e-2, 1e-2)}
# (BH, Tq, Tk, d, block_q, block_k, causal): the JAX tests' shapes, T = 100
# at the default blocks, Tq != Tk causal, and the head widths of the
# repository (8, 32, 64, 128) up to the kernel's limit (256); T = 100 and
# 160 leave ragged ends of the kernel's 64-row tiles
FLASH_CASES = ((6, 128, 128, 128, 128, 128, False), (6, 128, 128, 128, 128, 128, True),
               (6, 384, 384, 128, 128, 128, False), (6, 384, 384, 128, 128, 128, True),
               (6, 100, 100, 64, 256, 256, False), (6, 100, 100, 64, 256, 256, True),
               (6, 128, 256, 64, 128, 128, True), (6, 256, 128, 64, 128, 128, True),
               *((4, 160, 160, d, 256, 256, c) for d in (8, 32, 64, 128, 256)
                 for c in (False, True)))
BERT_BATCH, BERT_SEQ = 8, 512  # BERT-base attention: BH = 96 heads of d = 64
GRAD_TOL = 2e-4  # tests/test_flash_attention.py's bar for the flash gradients
# the microbenchmark kernels against their plain versions: elementwise
# 1e-5 + 1e-4|p| where every term is positive (blockfma, proto_fused);
# normwise max |k - p| <= 1e-4 max |p| where long float32 sums of both
# signs are taken in another order (mxu: up to 16,000 terms a row; cond:
# 4,096 terms a tile, and the window's halves added first)
MICROBENCH_NORM_TOL = 1e-4
# two small seeded cases per tool, beside its default size (seed 0)
BLOCKFMA_SMALL = ((64, 256, 32, 1), (1000, 8192, 64, 2))  # C, T, K, seed
MXU_SMALL = ((3, 1), (50, 2))                            # S, seed
COND_SMALL = ((3, 1), (40, 2))                           # steps, seed
PROTO_SMALL = ((4096, 128, 256, 1600, 2, 1), (50_000, 512, 1024, 3200, 5, 2))  # N R T S TILES seed
# the variant whose time stands in the kernels line
MICROBENCH_MAIN = {"microbench_blockfma_a": "A", "microbench_blockfma_b": "B",
                   "microbench_mxu": "chain2", "microbench_cond": "nocond",
                   "proto_fused": "fused"}

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


def kernel_figures(plan, n_cols: int, d: int, gen, peak_bw: float, peak_fp32: float) -> dict:
    """Each kernel over all its launches in one SpMM of a tiered plan at
    width d: its launches (counted over one such SpMM), its time, its
    plain version's, the one PyTorch call that computes the same function,
    and the bound of that work.

    The bucket phase's function is X -> the concatenation of every
    bucket's partial rows; its library call is torch.sparse.mm with one
    CSR holding every bucket's entries (tier offsets applied). The
    gather phase's is the finish's row gathers from that concatenation;
    its library call is torch.index_select (indices clamped into range:
    index_select has no zero-fill).
    """
    dev = torch.device("cuda", 0)
    x = torch.randn((n_cols, d), generator=gen).to(dev)
    buckets = [(0 if t.tier < 0 else t.tier * plan.tier_size, b)
               for t in plan.tiers for b in t.buckets]
    cat = torch.empty((plan.n_ell_rows, d), device=dev)

    def run_buckets(fn):
        r0 = 0
        for o, b in buckets:
            fn(b.cols, b.vals, x, o, out=cat[r0:r0 + b.n_ell_rows])
            r0 += b.n_ell_rows

    with torch.inference_mode():
        kernels.reset_launch_counts()
        run_buckets(kernels.bucket_spmm)
        bucket_launches = kernels.LAUNCHES["bucket_spmm"]
        bucket_ms = time_cuda(lambda: run_buckets(kernels.bucket_spmm), iters=20)
        bucket_plain_ms = time_cuda(lambda: run_buckets(kernels.bucket_spmm_torch), iters=5)
        rows_l, cols_l, vals_l = [], [], []
        r0 = 0
        for o, b in buckets:
            r, k = (b.vals != 0).nonzero(as_tuple=True)
            rows_l.append(r + r0)
            cols_l.append(b.cols[r, k].long() + o)
            vals_l.append(b.vals[r, k])
            r0 += b.n_ell_rows
        cols_all = torch.cat(cols_l)
        ell_csr = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows_l), cols_all]), torch.cat(vals_l),
            (plan.n_ell_rows, n_cols), check_invariants=False).coalesce().to_sparse_csr()
        run_buckets(kernels.bucket_spmm)
        bucket_lib_err = rel_err(torch.sparse.mm(ell_csr, x), cat)
        bucket_lib_ms = time_cuda(lambda: torch.sparse.mm(ell_csr, x), iters=20)
        bucket_bytes = (sum(b.n_ell_rows * b.width * 8 for _, b in buckets)  # cols + vals
                        + int(torch.unique(cols_all).numel()) * d * 4  # X rows read once
                        + plan.n_ell_rows * d * 4)  # partial rows written once
        bucket_ops = 2 * int(cols_all.numel()) * d

        run_buckets(kernels.bucket_spmm)
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


def expect_device_assert(code: str, what: str) -> None:
    """Run ``code`` in a child process; it must stop with a device-side
    assertion (which leaves the child's CUDA context unusable)."""
    probe = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    if probe.returncode == 0 or "device-side assert" not in probe.stdout + probe.stderr:
        raise AssertionError(f"{what} did not stop with a device-side assertion "
                             f"(rc {probe.returncode}):\n"
                             f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")


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
    (SCQ) scattered chunks, and the per-edge mode. Yields (name, plan);
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


def tile_load(plan: PanelPlan) -> dict:
    """How the panel kernel's work falls on its blocks and warps: edges
    (mask bits) per 128-row output tile (one block each), per warp's 8
    rows and per row, counted on the host from a compact plan's edges."""
    G = plan.T // 128
    rows, tile0 = [], 0
    for seg in plan.segments:
        slot = np.repeat(np.arange(seg.mask_counts.shape[0]), seg.mask_counts.astype(np.int64))
        tile = tile0 + seg.ctrl[slot // G, 0, C_TILE].astype(np.int64)
        rows.append(tile * 128 + (seg.mask_edges.astype(np.int64) & 255))
        tile0 += seg.n_tiles
    per_row = np.bincount(np.concatenate(rows), minlength=tile0 * 128)
    per_tile = per_row.reshape(tile0, 128).sum(1)
    per_warp = per_row.reshape(tile0, 16, 8).sum(2)
    return {"tiles": tile0, "tile_edges_mean": float(per_tile.mean()),
            "tile_edges_p99": float(np.percentile(per_tile, 99)),
            "tile_edges_max": int(per_tile.max()), "heaviest_tile": int(per_tile.argmax()),
            "warp_edges_max": int(per_warp.max()), "row_edges_max": int(per_row.max())}


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
    rows staging and window mode, for ranges scattered overflow pieces and
    ranges at the clamped top end of X (one wider than x itself, which
    reads the TPU wrapper's zero padding). Yields (name, plan); raises if a
    plan lacks what it is here for."""
    dev = torch.device("cuda", 0)
    build = build_fused_plan if engine == "fused" else build_ranges_plan

    def placed(csr, **kw):
        plan = build(csr, **kw)
        return place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=csr.shape),
                              dev).binned

    def n_virtual(plan):
        return sum(int(((s.ctrl[:, 0, 0] >= 0) & (s.ctrl[:, 0, 1] == 1)).sum())
                   for s in plan.segments) - sum(s.n_tiles for s in plan.segments)

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
        if not (plan.window and n_virtual(plan) and len(plan.segments) > 1):
            raise AssertionError("window case lacks virtual tiles or segments")
        yield "window mode+virtual tiles+segments", plan
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
    """How the fused or ranges kernel's work falls on its blocks: window
    row selections per lane group slot (one block each) and per control
    step, counted on the host from the plan's real lanes."""
    per_slot = []
    sent = staged_windows.geometry(plan)[4]
    for seg in plan.segments:
        lrow, lidx = seg.lrow.cpu().numpy(), seg.lidx.cpu().numpy()
        real = lrow < sent
        if plan.multihot:
            words = np.where(real[:, None, :], lidx, 0).astype(np.uint32)
            n = np.unpackbits(words.view(np.uint8), axis=None).reshape(words.shape[0], -1).sum(1)
        else:
            n = real.sum(1)
        per_slot.append(n)
    per_slot = np.concatenate(per_slot).astype(np.int64)
    per_step = per_slot.reshape(-1, plan.T // 128).sum(1)
    live = per_slot > 0
    return {"selections": int(per_slot.sum()), "real_slots": int(live.sum()),
            "slot_selections_mean": float(per_slot[live].mean()),
            "slot_selections_max": int(per_slot.max()),
            "step_selections_mean": float(per_step[per_step > 0].mean()),
            "step_selections_p99": float(np.percentile(per_step[per_step > 0], 99)),
            "step_selections_max": int(per_step.max())}


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
                rel_err_vs_torch_sparse_mm=lib_err, **fig)


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


def lane_load(plan) -> dict:
    """How the expansion kernels' work falls on their blocks: real lanes
    (lanes that add a row) per 128-lane group slot (one block each) and
    per step, counted on the host from the placed plan."""
    per_slot = []
    for g in plan.groups:
        real = g.lrow < plan.R
        if g.val_hi is not None:
            real &= (ekernels.bf16_tensor_value(g.val_hi)
                     + ekernels.bf16_tensor_value(g.val_lo)) != 0
        per_slot.append(real.sum(1).cpu().numpy())
    per_slot = np.concatenate(per_slot).astype(np.int64)
    per_step = per_slot.reshape(plan.n_steps, -1).sum(1)
    return {"lanes_per_step": per_slot.shape[0] // max(plan.n_steps, 1) * 128,
            "real_lanes": int(per_slot.sum()), "real_slots": int((per_slot > 0).sum()),
            "slots": int(per_slot.shape[0]),
            "step_real_lanes_mean": float(per_step.mean()),
            "step_real_lanes_min": int(per_step.min()),
            "step_real_lanes_max": int(per_step.max())}


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
    n_launch = sum(1 for g in sp.groups if g.n_steps)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        logits = model(op, x)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in launches}
        expected["expansion_spmm"] = 3 * n_launch
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
                rel_err_vs_torch_sparse_mm=lib_err, **fig)


def expansion2_run(graph: str, a: CSR, tiered_op, widths, gen, peak_bw: float,
                   peak_fp32: float):
    """spmm_expansion2 on one graph, as tools/bench_expansion2.py drives
    the JAX package's: the plan and its placement timed, then per width
    one SpMM through the entry point against the kernel's plain version
    and the tiered SpMM, and its time. Returns (the launches of the
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
    n_launch = sum(1 for g in placed.groups if g.n_steps)
    xs = [torch.randn((a.shape[1], d), generator=gen).to(dev) for d in widths]
    rows, err = [], 0.0
    with torch.inference_mode():
        kernels.reset_launch_counts()
        ys = [spmm_expansion2(placed, xd) for xd in xs]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {k: 0 for k in launches}
        expected["expansion2_spmm"] = n_launch * len(widths)
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
    mem = plan_memory_report(placed, d=widths[0])
    fields = dict(graph=graph, n_nodes=a.shape[0], nnz=a.nnz, **expansion_shape(placed),
                  padding_efficiency=placed.padding_efficiency(a.nnz),
                  lane_load=lane_load(placed), plan_bytes=mem["plan_bytes"],
                  stage_row_bytes=mem["stage_row_bytes"], plan_seconds=round(t_plan, 4),
                  placement_seconds=round(t_place, 4), launches=launches, spmm=rows)
    return launches, err, fields, fig


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


def flash_scale(gen, peak_bw: float, peak_fp32: float, peak_t16: float) -> list:
    """flash_attention at BERT-base's attention shape (BH = 96, T = 512,
    d = 64), float32 and bfloat16, non-causal and causal: its time, its
    plain version's, torch's scaled_dot_product_attention on the same
    (B, H, T, d) tensors (timed only; the port never calls it), and the
    bound of the work (AttentionTraffic: bytes over HBM bandwidth,
    operations over the type's peak: CUDA cores for float32, tensor cores
    for bfloat16)."""
    dev = torch.device("cuda", 0)
    BH, T, d = BERT_BATCH * 12, BERT_SEQ, 64
    qkv = [torch.randn((BH, T, d), generator=gen) for _ in range(3)]
    rows = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
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
                peak = peak_fp32 if dtype == torch.float32 else peak_t16
                bound, by = traffic.bound(peak_bw, peak)
                rows.append({"dtype": dtype_name(dtype), "causal": causal, "BH": BH, "T": T,
                             "d": d, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                             "library": "torch.nn.functional.scaled_dot_product_attention",
                             "library_max_abs_err": float((lib.reshape(BH, T, d).float()
                                                           - want.float()).abs().max()),
                             "max_abs_err": err, "bytes": traffic.bytes,
                             "flops": traffic.flops,
                             "bound_ms_bytes": traffic.bytes / peak_bw * 1e3,
                             "bound_ms_operations": traffic.flops / peak * 1e3,
                             "peak_tflops": peak / 1e12, "bound_ms": bound, "bound_by": by,
                             "fraction_of_bound": bound / ms})
    return rows


def check_norm(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |k - p| <= MICROBENCH_NORM_TOL max |p|; returns max |k - p|."""
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or err > MICROBENCH_NORM_TOL * float(want.abs().max()):
        raise AssertionError(f"{what}: max abs err {err} against max |p| "
                             f"{float(want.abs().max())}")
    return err


def run_tool(tool, expected: dict) -> tuple:
    """The tool's entry point at its default size, on the card (its printed
    lines go to stderr), with every launch count set to 0 just before it;
    (its rows, the counts just after), the counts held to ``expected``."""
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        rows = tool.main([])
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
    seeded cases and the default inputs, and the plain versions' times."""
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
            row["max_abs_err"] = err
            row["plain_ms"] = time_cuda(lambda: plain(*a), iters=3)
    return rows, launches


def mxu_phase(dev) -> tuple:
    """tools/microbench_mxu at its default size through its entry point,
    then every variant against the plain version on two small seeded cases
    and the default inputs, and the plain version's times."""
    rows, launches = run_tool(tmxu, {"microbench_mxu": len(kmxu.VARIANTS)
                                     * (WARMUP_CALLS + tmxu.ITERS)})
    err = {v: 0.0 for v in kmxu.VARIANTS}
    with torch.inference_mode():
        for S, seed in MXU_SMALL + ((tmxu.S, 0),):
            m = [t.to(dev) for t in tmxu.inputs(S, seed=seed)]
            for v in kmxu.VARIANTS:
                got, want = kmxu.mxu_step(v, *m), kmxu.mxu_step_torch(v, *m)
                torch.cuda.synchronize()
                err[v] = max(err[v], check_norm(got, want, f"microbench_mxu {v} S={S}"))
        for row in rows:
            row["max_abs_err"] = err[row["variant"]]
            row["plain_ms"] = time_cuda(lambda: kmxu.mxu_step_torch(row["variant"], *m), iters=3)
    return rows, launches


def cond_phase(dev) -> tuple:
    """tools/microbench_cond at its default size through its entry point,
    then every mode (every step's tile) against the plain version on two
    small seeded cases and the default inputs, and the plain version's
    times."""
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
    for row in rows:
        row["max_abs_err"] = err[row["variant"]]
    return rows, launches


def proto_phase(dev) -> tuple:
    """tools/proto_fused at its default size through its entry point, then
    every mode against the plain version (dma's staging buffer bit-exact,
    compute on that buffer, fused against the plain oracle) on two small
    seeded cases and the default inputs, and the plain version's times."""
    rows, launches = run_tool(tproto, {"proto_fused": 1 + len(tproto.MODES)
                                       * (WARMUP_CALLS + tproto.ITERS)})
    err = {mode: 0.0 for mode in tproto.MODES}
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
            for mode in ("compute", "fused"):
                got = kproto.proto_fused(mode, *args, **size, staged=staged_k)
                want = kproto.proto_fused_torch(mode, *args, **size, staged=staged_p)
                torch.cuda.synchronize()
                err[mode] = max(err[mode], check_close(got, want, f"{what} {mode}"))
            del got, want, zeros
        for row in rows:
            mode = row["variant"]
            row["max_abs_err"] = err[mode]
            row["plain_ms"] = time_cuda(lambda: kproto.proto_fused_torch(
                mode, *args, **size, staged=staged_p), iters=3)
    return rows, launches


def microbench_entry(name: str, rows: list, launches: dict) -> dict:
    """The kernels-line entry of one microbenchmark kernel: its main
    variant's times and bound, every variant's beside them."""
    main_row = next(r for r in rows if r["variant"] == MICROBENCH_MAIN[name])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name],
            "launches_scope": "one run of the entry point at its default size",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main_row[k] for k in keys}, "library_ms": None,
            "times_scope": f"variant {MICROBENCH_MAIN[name]} at the tool's default size",
            "variants": [{"variant": r["variant"], **{k: r[k] for k in keys},
                          "fraction_of_bound": r["fraction_of_bound"]} for r in rows]}


def main() -> int:
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
    peak_t16 = detect_peak_tensor16(name)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         peak_hbm_gb_s=peak_bw / 1e9, peak_fp32_tflops=peak_fp32 / 1e12,
         peak_bf16_tensor_tflops=peak_t16 / 1e12)

    # -- 2. build: one nvcc per source, started together, beside the host
    #       planner's g++ build ------------------------------------------------
    t0 = time.perf_counter()
    planner = threading.Thread(target=native.available)
    planner.start()
    kmods = (kernels, pkernels, fkernels, rkernels, ekernels, e2kernels, fakernels, kblockfma,
             kmxu, kcond, kproto)
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
        expected.update(bucket_spmm=3 * n_buckets, gather_rows=3 * (1 + (n_extra > 0)))
        if launches != expected:
            raise AssertionError(f"main path launches {launches}, expected {expected}")
        want = model(op, x, impl="torch")
        torch.cuda.synchronize()
    if logits.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or wrong shape")
    gcn_err = rel_err(logits, want)
    if gcn_err > MAIN_PATH_REL_TOL:
        raise AssertionError(f"GCN logits vs impl=torch: rel err {gcn_err}")

    # every kernel at the shapes the main path gives it, against its plain version
    with torch.inference_mode():
        for d in sorted(set(GCN_DIMS[:-1])):
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            parts = []
            for t in plan.tiers:
                o = 0 if t.tier < 0 else t.tier * plan.tier_size
                for b in t.buckets:
                    got = kernels.bucket_spmm(b.cols, b.vals, xd, o)
                    e = check_close(got, kernels.bucket_spmm_torch(b.cols, b.vals, xd, o),
                                    f"arxiv bucket K={b.width} tier={t.tier} d={d}")
                    max_err["bucket_spmm"] = max(max_err["bucket_spmm"], e)
                    parts.append(got)
            cat = torch.cat(parts)
            for idx in (plan.finish.pos, plan.finish.extra_idx):
                if not torch.equal(kernels.gather_rows(cat, idx),
                                   kernels.gather_rows_torch(cat, idx)):
                    raise AssertionError(f"arxiv finish gather d={d} not bit-exact")
        torch.cuda.synchronize()

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
         ell_rows=plan.n_ell_rows, finish_extras=n_extra,
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

    a_fig = kernel_figures(plan, cfg.n_nodes, 128, gen, peak_bw, peak_fp32)
    emit("kernel_times", graph="ogbn-arxiv", **a_fig)

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
    emit("kernel_times", graph="products-small",
         **kernel_figures(pop.binned, pcfg.n_nodes, 128, gen, peak_bw, peak_fp32))

    # -- 6. the panel kernel against its plain version -------------------------
    rng = np.random.default_rng(0)
    cases = []
    with torch.inference_mode():
        for case, pcase in panel_cases(rng):
            for d in FEATURE_WIDTHS:
                xd = torch.randn((pcase.shape[1], d), generator=gen).to(dev)
                got = pkernels.panel_spmm(pcase, xd)
                want = pkernels.panel_spmm_torch(pcase, xd)
                torch.cuda.synchronize()
                e = check_close(got, want, f"panel_spmm {case} d={d}")
                max_err["panel_spmm"] = max(max_err["panel_spmm"], e)
            cases.append({"case": case, "shape": list(pcase.shape), "T": pcase.T,
                          "hot": pcase.n_hot, "ranges": pcase.n_ranges,
                          "segments": len(pcase.segments), "direct": pcase.n_direct,
                          "S_buf": pcase.S_buf, "per_edge": pcase.per_edge})
            del pcase
    expect_device_assert(BAD_WINDOW_PROBE, "panel_spmm with a window row outside x")
    emit("panel_kernel", d=FEATURE_WIDTHS, cases=cases, max_abs_err=max_err["panel_spmm"],
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
    emit("panel_kernel_times", graph="ogbn-arxiv", **pan_fig)

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
         rel_err_vs_torch_sparse_mm=pp_lib_err, tiered_spmm_ms=p_ms, **ps_fig)

    # -- 9.-14. the fused and ranges engines: their kernel against its plain
    #           version on small plans of every shape, GCN inference on arxiv,
    #           one products-small SpMM ------------------------------------------
    staged_launches, staged_figs = {}, {}
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
        peak_fp32)
    max_err["expansion2_spmm"] = max(max_err["expansion2_spmm"], err)
    emit("expansion2", **fields, expansion_spmm_ms=exp_fig["ms"])
    emit("expansion2_kernel_times", graph="ogbn-arxiv", **e2_fig)
    _, err, fields, e2p_fig = expansion2_run(
        "products-small (synthetic, symmetrized, self-loops)", pa, pop, (128,), gen, peak_bw,
        peak_fp32)
    max_err["expansion2_spmm"] = max(max_err["expansion2_spmm"], err)
    emit("expansion2_scale", **fields)
    emit("expansion2_kernel_times", graph="products-small", **e2p_fig)

    # -- 20.-23. the attention path: the flash kernel against its plain
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
    fa_rows = flash_scale(gen, peak_bw, peak_fp32, peak_t16)
    emit("flash_scale", rows=fa_rows)
    fa_main = next(r for r in fa_rows if r["dtype"] == "float32" and not r["causal"])
    max_err["flash_attention"] = max(max_err["flash_attention"],
                                     max(r["max_abs_err"] for r in fa_rows
                                         if r["dtype"] == "float32"))

    # -- 24.-27. the SpMM inner-loop microbenchmarks: each tool's entry point
    #            at its default size, then its kernels against their plain
    #            versions -------------------------------------------------------
    micro = {}
    for tool, phase in (("microbench_blockfma", blockfma_phase), ("microbench_mxu", mxu_phase),
                        ("microbench_cond", cond_phase), ("proto_fused", proto_phase)):
        t0 = time.perf_counter()
        rows, tool_launches = phase(dev)
        micro[tool] = (rows, tool_launches)
        emit(tool, seconds=round(time.perf_counter() - t0, 2),
             launches={k: n for k, n in tool_launches.items() if n},
             tolerance=("|k-p| <= 1e-5 + 1e-4|p|" if tool in ("microbench_blockfma", "proto_fused")
                        else f"max|k-p| <= {MICROBENCH_NORM_TOL} max|p|"),
             rows=rows)

    # -- 28. the kernels, 29. the card, 30. the result ------------------------
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
         "times_scope": f"one SpMM on ogbn-arxiv at d={figs[k]['d']}"}
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
         "max_abs_err_by_dtype": fcases["max_abs_err"],
         "times_scope": "one call at (BH, T, d) = (96, 512, 64), float32, non-causal"})
    for kname, variant in MICROBENCH_MAIN.items():
        tool = "microbench_blockfma" if kname.startswith("microbench_blockfma") else kname
        rows, tool_launches = micro[tool]
        if tool == "microbench_blockfma":
            rows = [r for r in rows if r["variant"] == variant]
        entries.append(microbench_entry(kname, rows, tool_launches))
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
