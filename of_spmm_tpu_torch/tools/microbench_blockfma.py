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


# B's edges (seeded, beside the tool's inputs): every slot of a step in one
# output row, rows that no slot names, K = 8 and 512, and an odd R (257
# steps: a last wave of blocks that does not fill the card)
B_EDGES = {"one_row": dict(R=64, K=256), "empty_rows": dict(R=64, K=256), "K8": dict(R=300, K=8),
           "K512": dict(R=64, K=512), "R_odd": dict(R=257, K=256)}


def b_edge_inputs(case: str, C: int = C,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, vals, tier) of the B edge ``case`` (a key of B_EDGES): the
    tool's inputs at its R and K, with one_row's slots of step r all in
    output row r % 8 and empty_rows' only in rows 0-2 of each step."""
    R, K = B_EDGES[case]["R"], B_EDGES[case]["K"]
    starts, vals, tier = inputs("B", C, R * K, K, seed)
    if case in ("one_row", "empty_rows"):
        rng = np.random.default_rng(seed + 1)
        block = 8 * rng.integers(0, C // 8, starts.shape)
        if case == "one_row":
            row = np.broadcast_to((np.arange(R * 8) // 8 % 8)[:, None], starts.shape)
        else:
            row = rng.integers(0, 3, starts.shape)
        starts = (block + row).astype(np.int32)
    return starts, vals, tier


# A's edges (seeded, beside the tool's inputs): C on each side of both
# switches of ops/cuda/microbench_blockfma.a_plan at the H100's 232,448
# bytes (2,303: the L2 kernel; 2,304: the sliced kernel, 5 stages; 9,336: a
# 4-column slice and 2 stages; 9,337: the L2 kernel), an odd R (257 steps:
# a last stage of one step), K 40 (a last stage of 8 slots, starts rows of
# 5 columns padded for the copy) and a start at C - 8 (the last its
# assertion allows)
A_EDGES = {"C2303": dict(C=2303, R=64, K=256), "C2304": dict(C=2304, R=64, K=256),
           "C9336": dict(C=9336, R=64, K=256), "C9337": dict(C=9337, R=64, K=256),
           "R257": dict(C=8192, R=257, K=256), "K40": dict(C=5000, R=100, K=40),
           "last_start": dict(C=8192, R=64, K=256)}


def a_edge_inputs(case: str, seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, w, tier) of the A edge ``case`` (a key of A_EDGES): the
    tool's inputs at its C, R and K; last_start's every seventh step starts
    its last column's slots at C - 8."""
    e = A_EDGES[case]
    starts, w, tier = inputs("A", e["C"], e["R"] * e["K"], e["K"], seed)
    if case == "last_start":
        starts[::7, -1] = e["C"] - 8
    return starts, w, tier


def named_rows(starts: torch.Tensor) -> torch.Tensor:
    """(8R,) bool: the output rows of B that some slot names (row 8r + c % 8
    for each c in rows 8r to 8r + 7 of starts)."""
    step = torch.arange(starts.shape[0], device=starts.device) // 8
    rows = (step[:, None] * 8 + starts.long() % 8).reshape(-1)
    return torch.bincount(rows, minlength=starts.shape[0]) > 0


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
