"""Second-round gather microbenchmarks on Hopper: kernel-design decision data.

The counterpart of tools/microbench_gather2.py, with its names, sizes and
seeded inputs (numpy default_rng(0), the same calls in the same order). All
rates are Mrows/s of 512-byte (d = 128 float32) rows:

  vtake        row gather from tables of 2k..32k rows (microbench_gather's)
  onehot_small the one-hot product gather's function at C = 128 / 256,
               bfloat16 (microbench_gather's onehot, a row gather)
  onehot_pair  hi/lo bfloat16 pair: the TPU's one one-hot and two products
               (float32 parity), a row gather of both tables here
  take_fused   gather + value multiply + width-8 reduce (the ELL inner loop)
  dma_deep     row gather from a 1 GiB table, W = 16 / 32 / 64 / 128 rows in
               flight per warp, rows of 128 summed
  xla_fused    index_select + multiply + sum as PyTorch calls (the TPU tool's
               XLA form)
  window       windowed pair gather with a base per step (named only; a
               row gather here, as onehot_pair)
  twosided     window pair gather, value scale and hi/lo scatter into an
               (R, 128) sum (named only)

The kernels are ops/cuda/microbench_gather2.py's (vtake and onehot_small
run microbench_gather's, as the TPU tool imports them). hi / lo are made as
the TPU tool makes them: hi = bf16(x), lo = bf16(x - f32(hi)), rounded to
nearest even. window clamps each index at CW - 1, as the TPU tool does, so
a lane past its step's window reads the window's last row.

    python -m of_spmm_tpu_torch.tools.microbench_gather2 [names] [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_gather2 as kernels
from of_spmm_tpu_torch.tools.common import split_device
from of_spmm_tpu_torch.tools.microbench_gather import (
    D, bench_onehot_mxu, bench_vmem_take, inputs_row_dma, measure, show)
from of_spmm_tpu_torch.utils.roofline import ell_work, onehot_macs, onehot_work, twosided_work

NAMES = ("vtake", "onehot_small", "onehot_pair", "take_fused", "dma_deep", "xla_fused",
         "window", "twosided")
DEFAULT = NAMES[:6]  # the TPU tool's default list: window and twosided run when named
T = 1024 * 1024
VTAKE_C = (2048, 8192, 16384, 32768)
SMALL_C = (128, 256)
FUSED_C, FUSED_K = (8192, 16384, 32768), 8
DEEP_ROWS, DEEP_T, DEEP_W = 2 * 1024 * 1024, 256 * 1024, ((16, 1), (32, 4), (64, 8), (128, 16))
XLA_C, XLA_T = (8192, 32768, 131072), 4 * 1024 * 1024
WINDOW = ((1024, 128), (1024, 256), (2048, 256), (2048, 512))              # TILE, CW
TWOSIDED = ((1024, 256, 256), (1024, 256, 512), (1024, 256, 1024), (2048, 512, 512))  # + R
WINDOW_U, DEDUP = 16384, 4


def hilo_pair(x: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bfloat16 of float32 x: hi = bf16(x), lo = bf16(x - f32(hi))."""
    xt = torch.from_numpy(x)
    hi = xt.to(torch.bfloat16)
    return hi, (xt - hi.float()).to(torch.bfloat16)


def inputs_onehot_pair(C: int, T: int = T, seed: int = 0):
    """(cols (T / 128, 128) int32, hi, lo (C, 128) bfloat16) as
    bench_onehot_pair makes them."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, C - 2, T).astype(np.int32).reshape(-1, 128)
    x = rng.random((C, D), np.float32)
    return (torch.from_numpy(cols), *hilo_pair(x))


def inputs_take_fused(C: int, T: int = T, K: int = FUSED_K, seed: int = 0):
    """(cols (T / K, K) int32, vals (T / K, K) float32, tier (C, 128)
    float32) as bench_take_fused makes them."""
    rng = np.random.default_rng(seed)
    n_rows = T // K
    cols = rng.integers(0, C - 2, (n_rows, K)).astype(np.int32)
    vals = rng.random((n_rows, K), np.float32)
    tier = rng.random((C, D), np.float32)
    return tuple(torch.from_numpy(a) for a in (cols, vals, tier))


def _sorted_idx(rng, U: int, T: int, dedup: int) -> np.ndarray:
    reps = rng.poisson(dedup, U) + 1
    return np.repeat(np.arange(U, dtype=np.int32), reps)[:T]


def _window(idx: np.ndarray, T: int, TILE: int, CW: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """(bases (steps,), lidx (steps, TILE), the share of lanes past their
    window) for sorted indices: a step's base is its least index rounded
    down to a multiple of 16, and lidx is clamped at CW - 1."""
    nsteps = T // TILE
    bases = (idx.reshape(nsteps, TILE).min(axis=1) // 16 * 16).astype(np.int32)
    rel = idx.reshape(nsteps, TILE) - bases[:, None]
    return bases, np.minimum(rel, CW - 1), float((rel >= CW).mean())


def inputs_window_pair(TILE: int, CW: int, T: int = T, U: int = WINDOW_U, dedup: int = DEDUP,
                       seed: int = 0):
    """(bases (T / TILE, 1) int32, lidx (T / 128, 128) int32, hi, lo
    (U + CW, 128) bfloat16, the spilled share) as bench_window_pair makes
    them: U indices repeated 1 + Poisson(dedup) times, the last repeated to
    fill T."""
    rng = np.random.default_rng(seed)
    idx = _sorted_idx(rng, U, T, dedup)
    if idx.shape[0] < T:
        idx = np.pad(idx, (0, T - idx.shape[0]), constant_values=U - 1)
    bases, lidx, spill = _window(idx, T, TILE, CW)
    x = rng.random((U + CW, D), np.float32)
    return (torch.from_numpy(bases.reshape(-1, 1)),
            torch.from_numpy(lidx.astype(np.int32).reshape(-1, 128)), *hilo_pair(x), spill)


def inputs_twosided(TILE: int, CW: int, R: int, T: int = T, dedup: int = DEDUP, seed: int = 0):
    """(bases, lidx, rows, vals, hi, lo) as bench_twosided makes them: U =
    T / dedup + CW indices, rows uniform in [0, R), vals uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    U = int(T // dedup) + CW
    idx = _sorted_idx(rng, U, T, dedup)
    nsteps = T // TILE
    bases, lidx, _ = _window(idx, T, TILE, CW)
    rows = rng.integers(0, R, (nsteps, TILE)).astype(np.int32)
    vals = rng.random((nsteps, TILE), np.float32)
    x = rng.random((U + CW, D), np.float32)
    return (torch.from_numpy(bases.reshape(-1, 1)),
            torch.from_numpy(lidx.astype(np.int32).reshape(-1, 128)),
            torch.from_numpy(rows.reshape(-1, 128)), torch.from_numpy(vals.reshape(-1, 128)),
            *hilo_pair(x))


def bench_onehot_pair(device: torch.device, C: int, T: int = T) -> Dict[str, object]:
    """float32-parity gather: on the TPU one one-hot feeds the hi and lo
    products, whose multiply-adds are counted beside the bound; the kernel
    here runs none."""
    cols, hi, lo = (a.to(device) for a in inputs_onehot_pair(C, T))
    row = measure("microbench_gather2", "gather2_onehot_pair", f"C={C}",
                  lambda: kernels.onehot_pair(cols, hi, lo), onehot_work(cols, (hi, lo), C), T,
                  device, macs=onehot_macs(cols, 2, C), C=C)
    show(row, "onehot pair", f"C={C}", " (fp32-parity)")
    return row


def bench_take_fused(device: torch.device, C: int, T: int = T,
                     K: int = FUSED_K) -> Dict[str, object]:
    """The ELL inner loop: gather T rows, multiply by vals, reduce width K."""
    cols, vals, tier = (a.to(device) for a in inputs_take_fused(C, T, K))
    row = measure("microbench_gather2", "gather2_take_fused", f"C={C}",
                  lambda: kernels.take_fused(cols, vals, tier), ell_work(cols, K, tier, vals), T,
                  device, C=C, K=K)
    show(row, "take fused", f"C={C} K={K}", " (take+mul+reduce)")
    return row


def bench_dma_deep(device: torch.device, table_rows: int, T: int, W: int,
                   NSEM: int) -> Dict[str, object]:
    """Rows of 128 summed, gathered from device memory W rows in flight per
    warp (NSEM, the TPU's semaphore count, has no counterpart)."""
    cols, table = (a.to(device) for a in inputs_row_dma(table_rows, T))
    row = measure("microbench_gather2", "gather2_dma_deep", f"W={W}",
                  lambda: kernels.dma_deep(cols, table, W),
                  ell_work(cols, kernels.DEEP_GROUP, table), T, device, table_rows=table_rows,
                  W=W, NSEM=NSEM)
    show(row, "dma deep", f"table={table_rows:,} W={W}", " (HBM random)")
    return row


def bench_window_pair(device: torch.device, TILE: int, CW: int, T: int = T,
                      U: int = WINDOW_U) -> Dict[str, object]:
    """The staged-expansion inner loop: the pair gather over a CW-row window
    at a base per step of TILE lanes (the TPU's one-hot multiply-adds
    counted beside the bound; the kernel here runs none)."""
    *args, spill = inputs_window_pair(TILE, CW, T, U)
    bases, lidx, hi, lo = (a.to(device) for a in args)
    row = measure("microbench_gather2", "gather2_window_pair", f"TILE={TILE} CW={CW}",
                  lambda: kernels.window_pair(bases, lidx, hi, lo, CW),
                  onehot_work(lidx, (hi, lo), CW, bases), T, device,
                  macs=onehot_macs(lidx, 2, CW), TILE=TILE, CW=CW, U=U, spill=spill)
    note = f" (fp32-parity, dyn base; {spill:.1%} spill clamped)"
    show(row, "window pair", f"TILE={TILE} CW={CW}", note)
    return row


def bench_twosided(device: torch.device, TILE: int, CW: int, R: int,
                   T: int = T) -> Dict[str, object]:
    """Window pair gather, scale, hi/lo split and scatter into (R, 128);
    the TPU kernel's one-hot multiply-adds counted beside the bound (the
    kernel here runs none)."""
    bases, lidx, rows, vals, hi, lo = (a.to(device) for a in inputs_twosided(TILE, CW, R, T))
    row = measure("microbench_gather2", "gather2_twosided", f"TILE={TILE} CW={CW} R={R}",
                  lambda: kernels.twosided(bases, lidx, rows, vals, hi, lo, CW, R),
                  twosided_work(bases, lidx, rows, vals, hi, lo, CW, R), T, device,
                  macs=onehot_macs(lidx, 2, CW), TILE=TILE, CW=CW, R=R)
    show(row, "twosided", f"TILE={TILE} CW={CW} R={R}", " (gather+scale+scatter)")
    return row


def bench_xla_fused(device: torch.device, C: int, T: int = XLA_T,
                    K: int = FUSED_K) -> Dict[str, object]:
    """index_select + multiply + sum over an ELL bucket, as PyTorch calls."""
    cols, vals, tier = (a.to(device) for a in inputs_take_fused(C, T, K))
    flat = cols.reshape(-1).long()

    def fused():
        g = torch.index_select(tier, 0, flat).view(-1, K, D)
        return (g * vals[:, :, None]).sum(1)

    row = measure("microbench_gather2", None, f"xla_fused C={C}", fused,
                  ell_work(cols, K, tier, vals), T, device, C=C, K=K)
    show(row, "torch fused", f"C={C:,} K={K}", " (index_select+mul+sum)")
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    which = rest or list(DEFAULT)
    unknown = sorted(set(which) - set(NAMES))
    if unknown:
        raise SystemExit(f"unknown names {unknown}; known: {' '.join(NAMES)}")
    rows = []
    if "vtake" in which:
        for C in VTAKE_C:
            rows.append(bench_vmem_take(device, C, T))
    if "onehot_small" in which:
        for C in SMALL_C:
            rows.append(bench_onehot_mxu(device, C, T, torch.bfloat16))
    if "onehot_pair" in which:
        for C in SMALL_C:
            rows.append(bench_onehot_pair(device, C, T))
    if "take_fused" in which:
        for C in FUSED_C:
            rows.append(bench_take_fused(device, C, T))
    if "dma_deep" in which:
        for w, ns in DEEP_W:
            rows.append(bench_dma_deep(device, DEEP_ROWS, DEEP_T, w, ns))
    if "window" in which:
        for tile, cw in WINDOW:
            rows.append(bench_window_pair(device, tile, cw, T))
    if "twosided" in which:
        for tile, cw, r in TWOSIDED:
            rows.append(bench_twosided(device, tile, cw, r, T))
    if "xla_fused" in which:
        for C in XLA_C:
            rows.append(bench_xla_fused(device, C, XLA_T))
    print("done", flush=True)
    return rows


if __name__ == "__main__":
    main()
