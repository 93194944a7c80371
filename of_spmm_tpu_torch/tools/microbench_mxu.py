"""Microbench: what sets a fused step's cost on Hopper, the gather or the
scatter?

The counterpart of tools/microbench_mxu.py. One output tile is summed over
S steps of G groups of 128 lanes on a window of 64 blocks of 128 bf16 rows
(width 256, its two halves added):

  noop     each step adds its first lane-index row to tile row 0 (floor)
  winread  each group adds a whole window block, chosen per step (blk)
  winstat  the same with block g of group g
  rawdyn   each lane gathers one row of its group's block (lidx)
  rawstat  the same from block g
  chain2   each lane's gathered row is scattered to its own row (lrow) of
           a 512-row tile

The variants run as the hand-written kernel of ops/cuda/microbench_mxu.py
on the same seeded inputs as the TPU tool, and report us/step beside the
card's bound for the same work (utils/roofline.mxu_work). rawdyn against
winread is the cost of the gather; chain2 against rawdyn, the scatter.

    python -m of_spmm_tpu_torch.tools.microbench_mxu [S] [variants] [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_mxu as kernels
from of_spmm_tpu_torch.tools.common import bound_fields, describe, split_device, time_ms
from of_spmm_tpu_torch.utils.roofline import mxu_work

_L = 128
S, G, R = 2000, 8, 512  # the TPU tool's defaults
VARIANTS = kernels.VARIANTS
ITERS = 20


def inputs(S: int = S, G: int = G, R: int = R,
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(blk, lidx, lrow, win) as the TPU tool makes them, on the CPU; win
    is rounded from float32 to bfloat16 to nearest even, as JAX rounds."""
    rng = np.random.default_rng(seed)
    win = rng.standard_normal((64 * _L, 256)).astype(np.float32)
    lidx = rng.integers(0, _L, (S * G, _L)).astype(np.int32)
    lrow = rng.integers(0, R, (S * G, _L)).astype(np.int32)
    blk = rng.integers(0, 64, (S, 1, G)).astype(np.int32)
    return (torch.from_numpy(blk), torch.from_numpy(lidx), torch.from_numpy(lrow),
            torch.from_numpy(win).to(torch.bfloat16))


def bench(variant: str, args, device: torch.device, R: int = R,
          iters: int = ITERS) -> Dict[str, object]:
    """Time one variant on placed inputs; its row (us/step, bound)."""
    blk, lidx, lrow, win = args
    steps = blk.shape[0]
    ms = time_ms(lambda: kernels.mxu_step(variant, blk, lidx, lrow, win, R), device, iters)
    work = mxu_work(variant, blk, lidx, lrow, kernels.tile_rows(variant, R))
    row = {"tool": "microbench_mxu", "variant": variant, "S": steps, "G": blk.shape[2],
           **bound_fields(work, ms, device)}
    row["us_per_step"] = ms / steps * 1e3
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    steps = int(rest[0]) if rest else S
    variants = rest[1].split(",") if len(rest) > 1 else list(VARIANTS)
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; one of {VARIANTS}")
    args = tuple(t.to(device) for t in inputs(steps))
    rows = []
    for v in variants:
        row = bench(v, args, device)
        print(describe(row, f"{v:8s}: {row['us_per_step']:8.3f} us/step"), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
