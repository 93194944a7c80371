"""Microbench: the block-covering SpMM inner loop on Hopper.

The counterpart of tools/microbench_blockfma.py. Per nonzero slot the
loop reads a block of tier rows from a table that sits in the cache and
adds it, weighted, into the step's 8 output rows:

  A. an unaligned 8-row block at the slot's start s, each row weighted by
     its own w (out[8r + j] += w[8r + j, k] tier[s + j]);
  B. the one row c the slot names, weighted by its value v, into output
     row c % 8 of the step.

Both run as the hand-written kernels of ops/cuda/microbench_blockfma.py on
the same seeded inputs as the TPU tool (numpy default_rng(0), the same
calls in the same order), and report Mblocks/s (block slots per second)
beside the card's bound for the same work (utils/roofline.blockfma_work).

    python -m of_spmm_tpu_torch.tools.microbench_blockfma [A] [B] [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_blockfma as kernels
from of_spmm_tpu_torch.tools.common import bound_fields, describe, split_device, time_ms
from of_spmm_tpu_torch.utils.roofline import blockfma_work

D = 128
C, T, K = 8192, 1024 * 1024, 256  # tier rows, block slots, slots per step (the TPU tool's)
ITERS = 20


def inputs(variant: str, C: int = C, T: int = T, K: int = K,
           seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, w or vals, tier) as the TPU tool makes them for ``variant``
    ("A" or "B"): R = T / K steps of 8 rows."""
    rng = np.random.default_rng(seed)
    R = T // K
    if variant == "A":
        starts = rng.integers(0, C - 9, (R * 8, K // 8)).astype(np.int32)
        w = rng.random((R * 8, K), np.float32)
    elif variant == "B":
        starts = rng.integers(0, C - 2, (R * 8, K // 8)).astype(np.int32)
        w = rng.random((R * 8, K // 8), np.float32)
    else:
        raise ValueError(f"variant must be 'A' or 'B', got {variant!r}")
    tier = rng.random((C, D), np.float32)
    return starts, w, tier


def run(variant: str, starts: torch.Tensor, w: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """The variant's output (float32 (8R, 128)) through its wrapper."""
    fn = kernels.blockfma_a if variant == "A" else kernels.blockfma_b
    return fn(starts, w, tier)


def bench(variant: str, device: torch.device, C: int = C, T: int = T, K: int = K,
          iters: int = ITERS) -> Dict[str, object]:
    """Time one variant at these sizes; its row (Mblocks/s, bound)."""
    starts, w, tier = (torch.from_numpy(a).to(device) for a in inputs(variant, C, T, K))
    ms = time_ms(lambda: run(variant, starts, w, tier), device, iters)
    row = {"tool": "microbench_blockfma", "variant": variant, "C": C, "K": K, "slots": T,
           **bound_fields(blockfma_work(variant, starts, w, tier), ms, device)}
    row["mblocks_per_s"] = T / ms / 1e3
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    which = rest or ["A", "B"]
    rows = []
    for variant in ("A", "B"):
        if variant in which:
            row = bench(variant, device, C, T, K)
            print(describe(row, f"[blockfma {variant}] C={C} K={K}: "
                                f"{row['mblocks_per_s']:8.0f} Mblocks/s"), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
