"""Microbench: gather strategies for the SpMM kernels on Hopper.

The counterpart of tools/microbench_gather.py, with its names, sizes and
seeded inputs (numpy default_rng(0), the same calls in the same order):

  stream  streaming rate: a 64 MB elementwise pass (read + write), the
          roofline anchor; a PyTorch call, as the TPU tool's was XLA
  xla     torch.index_select row-gather rate against table size (the TPU
          tool's jnp.take, sorted and not); PyTorch calls
  vmem    ELL K = 128 weighted gather-reduce from a table in L2 (vmem_loop)
  take    row gather (vmem_take)
  onehot  the one-hot product gather's function, float32 and bfloat16
          tiers (onehot: a row gather, zero rows outside [0, C))
  block   unaligned 8-row block sums (block_slice: on the card the counts
          of 16 steps' starts times the shifted tier on the tensor cores,
          or the L2 kernel where block_slice_plan's models make it faster)
  dma     row gather from a 1 GiB table in device memory, groups of 16
          summed, W rows in flight per warp (row_dma)

The kernels are ops/cuda/microbench_gather.py's. Each prints Mrows/s and
GB/s of 512-byte rows as the TPU tool does, beside the card's bound for the
same work (utils/roofline.py). The TPU tool adds ``i & 1`` to the indices
on each timed iteration, to keep its compiler from hoisting the gather out
of the timing loop (hence indices drawn below C - 2); here every timed call
runs on the inputs as made.

    python -m of_spmm_tpu_torch.tools.microbench_gather [names] [--device cpu]

``blockpaths``, run only when named, times block_slice on each of its
paths apart across the path switch (card only).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_gather as kernels
from of_spmm_tpu_torch.tools.common import (
    bound_fields, describe, split_device, time_ms)
from of_spmm_tpu_torch.utils.roofline import (
    KernelWork, block_slice_work, ell_work, onehot_macs, onehot_work, row_gather_work)

D = 128
ROW_BYTES = D * 4
ITERS = 10
NAMES = ("stream", "xla", "vmem", "take", "onehot", "block", "dma")
# named only: block_slice's two paths timed apart across its path switch
EXTRA = ("blockpaths",)
# the TPU tool's sizes: gathered rows, the tables its main() sweeps
T = 1024 * 1024
STREAM_N = 16 * 1024 * 1024   # 64 MB float32
XLA_ROWS = (8192, 32768, 131072, 524288, 2 * 1024 * 1024)
VMEM_C, VMEM_K = (8192, 16384), 128
TAKE_C = (2048, 8192, 16384)
ONEHOT_C = (512, 1024, 2048)
BLOCK_C, BLOCK_K = 8192, 128
DMA_ROWS, DMA_T, DMA_W = 2 * 1024 * 1024, 256 * 1024, 16
# blockpaths: (C, K, R) on both sides of block_slice_plan's switch
BLOCK_PATHS = (tuple((C, 128, 128) for C in (8192, 16384, 24576, 32768))
               + tuple((C, 8, 128) for C in (1024, 4096))
               + tuple((C, 16, 16) for C in (1024, 2048))
               + tuple((C, 32, 16) for C in (1024, 4096, 8192))
               + tuple((C, 64, 32) for C in (4096, 8192, 12288)))
# block_slice's edges: one chunk and fewer than 16 steps; a ragged last
# group (R 17) and a ragged last chunk; counts past 256 (whole steps of equal
# starts, at 0, at C - 8 and across a chunk's edge: two base-256 digits);
# at K 32, R 16 the largest C (a multiple of 64) on the count path on an
# H100 and the next, on the L2 path; and K 16, whose steps' starts are too
# few for the count path (block_slice_plan)
H100 = (232448, 132)  # opt-in shared memory per block in bytes, SMs
BLOCK_EDGE_K, BLOCK_EDGE_R = 32, 16
BLOCK_EDGE_C = max(C for C in range(64, 1 << 15, 64)
                   if kernels.block_slice_plan(C, BLOCK_EDGE_K, BLOCK_EDGE_R, *H100))
BLOCK_EDGES = {"one_chunk": dict(C=64, K=8, R=4), "ragged": dict(C=3000, K=40, R=17),
               "over_256": dict(C=1000, K=64, R=20),
               "count_edge": dict(C=BLOCK_EDGE_C, K=BLOCK_EDGE_K, R=BLOCK_EDGE_R),
               "l2_edge": dict(C=BLOCK_EDGE_C + 64, K=BLOCK_EDGE_K, R=BLOCK_EDGE_R),
               "few_starts": dict(C=1024, K=16, R=BLOCK_EDGE_R)}


def _t(*arrays) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a) for a in arrays)


def inputs_vmem_loop(C: int, T: int, K: int = VMEM_K, seed: int = 0):
    """(cols (8R, K) int32, vals (8R, K) float32, tier (C, 128) float32),
    R = T / (8 K), as bench_vmem_loop makes them."""
    rng = np.random.default_rng(seed)
    R = T // (8 * K)
    cols = rng.integers(0, C - 2, (R * 8, K)).astype(np.int32)
    vals = rng.random((R * 8, K), np.float32)
    tier = rng.random((C, D), np.float32)
    return _t(cols, vals, tier)


def inputs_take(C: int, T: int, seed: int = 0, dtype=torch.float32):
    """(cols (T / 128, 128) int32, tier (C, 128)) as bench_vmem_take and
    bench_onehot_mxu make them; a bfloat16 tier rounds the float32 draws to
    nearest even, as numpy's astype(bfloat16) does."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, C - 2, T).astype(np.int32).reshape(-1, 128)
    tier = rng.random((C, D), np.float32)
    cols, tier = _t(cols, tier)
    return cols, tier.to(dtype)


def with_outside(idx: torch.Tensor, window: int) -> torch.Tensor:
    """A copy of ``idx`` with every 97th index at window, window + 1 or
    window + 2 and every 101st at -1 or -2: the edges of a gather that
    gives a zero row outside [0, window) (onehot, twosided's window)."""
    out = idx.clone()
    flat = out.view(-1)
    past, below = torch.arange(0, flat.numel(), 97), torch.arange(50, flat.numel(), 101)
    flat[past] = (window + past % 3).to(flat.dtype)
    flat[below] = (-1 - below % 2).to(flat.dtype)
    return out


def inputs_block_slice(C: int, T: int, K: int = BLOCK_K, seed: int = 0):
    """(starts (8R, K) int32, tier (C, 128) float32), R = T / (64 K), as
    bench_block_slice makes them."""
    rng = np.random.default_rng(seed)
    R = T // 8 // (8 * K)
    starts = rng.integers(0, C - 9, (R * 8, K)).astype(np.int32)
    tier = rng.random((C, D), np.float32)
    return _t(starts, tier)


def block_edge_inputs(case: str, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, tier) of the block_slice edge ``case`` (a key of
    BLOCK_EDGES) at its C, K and R; over_256's steps 0, 1 and 2 start all
    their 8K blocks at 0, at C - 8 and at 509 (counts of 8K = 512), and step
    3 its first 5 rows' at 700 (a count of 320: both digits)."""
    e = BLOCK_EDGES[case]
    starts, tier = inputs_block_slice(e["C"], e["R"] * 64 * e["K"], e["K"], seed)
    if case == "over_256":
        starts[0:8], starts[8:16], starts[16:24], starts[24:29] = 0, e["C"] - 8, 509, 700
    return starts, tier


def inputs_row_dma(table_rows: int, T: int, seed: int = 0):
    """(cols (T / 128, 128) int32, table (table_rows, 128) float32) as
    bench_row_dma (and bench_dma_deep) make them."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, table_rows - 2, T).astype(np.int32).reshape(-1, 128)
    table = rng.random((table_rows, D), np.float32)
    return _t(cols, table)


def measure(tool: str, kernel: Optional[str], variant: str, fn, work: KernelWork, rows: int,
            device: torch.device, macs: Optional[int] = None, **fields) -> Dict[str, object]:
    """Time ``fn`` (ITERS calls) and make its row: the bound of ``work``,
    the rate of ``rows`` 512-byte rows and, for a TPU one-hot product,
    ``macs``, its one-hot multiply-adds (utils/roofline.onehot_macs), the
    TPU's count beside the bound: the kernels here run none."""
    ms = time_ms(fn, device, ITERS)
    row = {"tool": tool, "kernel": kernel, "variant": variant, "T": rows, **fields,
           **bound_fields(work, ms, device)}
    if macs is not None:
        row["onehot_macs"] = macs
    row["mrows_per_s"] = rows / ms / 1e3
    row["gb_per_s"] = row["mrows_per_s"] * ROW_BYTES / 1e3
    return row


def show(row: Dict[str, object], tag: str, params: str, note: str = "") -> None:
    """Print a row as the TPU tool prints it, with the bound after it."""
    print(describe(row, f"[{tag}] {params}: {row['mrows_per_s']:8.0f} Mrows/s = "
                        f"{row['gb_per_s']:6.1f} GB/s{note}"), flush=True)


def bench_stream(device: torch.device, n: int) -> Dict[str, object]:
    """x * 1.000001 + 1 over 64 MB of float32 in one PyTorch call."""
    x = torch.arange(n, dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    row = measure("microbench_gather", None, "stream", lambda: torch.add(one, x, alpha=1.000001),
                  KernelWork(2 * n * 4, 2 * n), 2 * n * 4 // ROW_BYTES, device)
    show(row, "stream", f"{n * 4 / 2**20:.0f} MB", " (read + write)")
    return row


def bench_xla_take(device: torch.device, table_rows: int, n_idx: int,
                   sort: bool = False) -> Dict[str, object]:
    """torch.index_select of n_idx rows from a (table_rows, 128) table."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, table_rows - 2, n_idx).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    table = torch.from_numpy(rng.random((table_rows, D), np.float32)).to(device)
    idxd = torch.from_numpy(idx).to(device)
    idxl = idxd.long()
    row = measure("microbench_gather", None, f"xla rows={table_rows} sorted={sort}",
                  lambda: torch.index_select(table, 0, idxl), row_gather_work(idxd, table),
                  n_idx, device, table_rows=table_rows, sorted=sort)
    show(row, "torch index_select", f"table={table_rows:>9,} sorted={sort}")
    return row


def bench_vmem_loop(device: torch.device, C: int, T: int, K: int = VMEM_K) -> Dict[str, object]:
    cols, vals, tier = (a.to(device) for a in inputs_vmem_loop(C, T, K))
    row = measure("microbench_gather", "gather_vmem_loop", f"C={C}",
                  lambda: kernels.vmem_loop(cols, vals, tier),
                  ell_work(cols, K, tier, vals, resident=True), T, device, C=C, K=K)
    show(row, "vmem loop", f"C={C} K={K}", " (L2-side)")
    return row


def bench_vmem_take(device: torch.device, C: int, T: int) -> Dict[str, object]:
    cols, tier = (a.to(device) for a in inputs_take(C, T))
    row = measure("microbench_gather", "gather_vmem_take", f"C={C}",
                  lambda: kernels.vmem_take(cols, tier), row_gather_work(cols, tier), T, device,
                  C=C)
    show(row, "vmem take", f"C={C}", " (L2-side)")
    return row


def bench_onehot_mxu(device: torch.device, C: int, T: int,
                     dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """The one-hot product gather's function: the TPU kernel's C x 128
    multiply-adds per row counted beside the bound (a row gather's); the
    kernel here runs none."""
    cols, tier = (a.to(device) for a in inputs_take(C, T, dtype=dtype))
    name = str(dtype).replace("torch.", "")
    row = measure("microbench_gather", "gather_onehot", f"C={C} {name}",
                  lambda: kernels.onehot(cols, tier), onehot_work(cols, (tier,), C), T, device,
                  macs=onehot_macs(cols, 1, C), C=C, dtype=name)
    show(row, f"onehot {name}", f"C={C}", " (virtual)")
    return row


def bench_block_slice(device: torch.device, C: int, T: int,
                      K: int = BLOCK_K) -> Dict[str, object]:
    """T / 8 unaligned 8-row block loads, 8 K per output step."""
    starts, tier = (a.to(device) for a in inputs_block_slice(C, T, K))
    row = measure("microbench_gather", "gather_block_slice", f"C={C}",
                  lambda: kernels.block_slice(starts, tier), block_slice_work(starts, tier), T,
                  device, C=C, K=K)
    row["mblocks_per_s"] = row["mrows_per_s"] / 8
    if device.type == "cuda":  # the path the card takes: its chunk rows, 0 the L2 kernel
        row["chunk_rows"] = kernels.plan_on(starts, tier)
        row["count_macs"] = kernels.block_slice_macs(starts, C, row["chunk_rows"])
    show(row, "block slice", f"C={C}", f" ({row['mblocks_per_s']:6.0f} Mblocks/s)")
    return row


def block_paths(device: torch.device) -> List[Dict[str, object]]:
    """block_slice on each of its paths, named (block_slice_launch's
    chunk_rows: 0 the L2 kernel, else the count-matrix kernel's chunks) at
    BLOCK_PATHS; each row records the path block_slice_plan takes there."""
    rows = []
    optin, sms = kernels.card_shape(device)
    for C, K, R in BLOCK_PATHS:
        starts, tier = (a.to(device) for a in inputs_block_slice(C, R * 64 * K, K))
        for chunk_rows in (0, kernels.block_slice_chunk_rows(C, R, optin, sms)):
            row = measure("microbench_gather", "gather_block_slice",
                          f"paths C={C} K={K} R={R} rows={chunk_rows}",
                          lambda: kernels.block_slice_launch(starts, tier, chunk_rows),
                          block_slice_work(starts, tier), R * 64 * K, device, C=C, K=K, R=R,
                          chunk_rows=chunk_rows,
                          plan=kernels.block_slice_plan(C, K, R, optin, sms))
            show(row, "block paths", f"C={C} K={K} R={R} chunk rows={chunk_rows}")
            rows.append(row)
    return rows


def bench_row_dma(device: torch.device, table_rows: int, T: int,
                  W: int = DMA_W) -> Dict[str, object]:
    cols, table = (a.to(device) for a in inputs_row_dma(table_rows, T))
    row = measure("microbench_gather", "gather_row_dma", f"W={W}",
                  lambda: kernels.row_dma(cols, table, W), ell_work(cols, kernels.GROUP, table),
                  T, device, table_rows=table_rows, W=W)
    show(row, "row dma", f"table={table_rows:,} W={W}", " (HBM random)")
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    which = rest or list(NAMES)
    unknown = sorted(set(which) - set(NAMES) - set(EXTRA))
    if unknown:
        raise SystemExit(f"unknown names {unknown}; known: {' '.join(NAMES + EXTRA)}")
    rows = []
    if "stream" in which:
        rows.append(bench_stream(device, STREAM_N))
    if "xla" in which:
        for n in XLA_ROWS:
            rows.append(bench_xla_take(device, n, T))
        rows.append(bench_xla_take(device, XLA_ROWS[-1], T, sort=True))
    if "vmem" in which:
        for C in VMEM_C:
            rows.append(bench_vmem_loop(device, C, T, VMEM_K))
    if "take" in which:
        for C in TAKE_C:
            rows.append(bench_vmem_take(device, C, T))
    if "onehot" in which:
        for C in ONEHOT_C:
            rows.append(bench_onehot_mxu(device, C, T, torch.float32))
            rows.append(bench_onehot_mxu(device, C, T, torch.bfloat16))
    if "block" in which:
        rows.append(bench_block_slice(device, BLOCK_C, T, BLOCK_K))
    if "dma" in which:
        rows.append(bench_row_dma(device, DMA_ROWS, DMA_T))
    if "blockpaths" in which:
        rows.extend(block_paths(device))
    print("done", flush=True)
    return rows


if __name__ == "__main__":
    main()
