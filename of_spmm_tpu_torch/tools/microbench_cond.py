"""Microbench: what does skipping empty groups save on Hopper?

The counterpart of tools/microbench_cond.py. Per step, G = 32 groups each
decode a 4 x 128 word bitmask into a 128 x 128 0/1 matrix and multiply
its transpose into a 128 x 256 bf16 window (the panel kernel's compute
block); the step's tile is the sum over the groups run, its two halves
added. Modes:

  nocond     every group (baseline)
  cond_all   sub-blocks of 4 groups behind a branch on g_cnt = 32 (its cost)
  cond_half  the same with g_cnt = 16 (what skipping half saves)
  when_all, when_half  the same, each taken sub-block added into the
             tile in memory (the TPU's pl.when form)

The modes run as the hand-written kernel of ops/cuda/microbench_cond.py on
the same seeded inputs as the TPU tool. Every step's tile is kept (the
TPU's result is the last one). It reports ms, ns/slot and us/step beside
the card's bound for the same work (utils/roofline.cond_work).

    python -m of_spmm_tpu_torch.tools.microbench_cond [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_cond as kernels
from of_spmm_tpu_torch.tools.common import bound_fields, describe, split_device, time_ms
from of_spmm_tpu_torch.utils.roofline import cond_work

_L = 128
G = 32
SUB = kernels.SUB
STEPS = 2048
RUNS = (("nocond", 1.0), ("cond_all", 1.0), ("cond_half", 0.5), ("when_all", 1.0),
        ("when_half", 0.5))  # the TPU tool's main()
ITERS = 10


def inputs(frac: float, steps: Optional[int] = None,
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gcnt, masks, win) as the TPU tool's run() makes them, on the CPU;
    win is rounded from float32 to bfloat16 to nearest even."""
    steps = STEPS if steps is None else steps
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2**31, (steps * G, 4, _L)).astype(np.int32)
    win = rng.standard_normal((_L, 2 * _L)).astype(np.float32)
    gcnt = np.full(steps, int(G * frac), np.int32)
    return (torch.from_numpy(gcnt), torch.from_numpy(masks),
            torch.from_numpy(win).to(torch.bfloat16))


def bench(mode: str, frac: float, device: torch.device, masks: torch.Tensor, win: torch.Tensor,
          iters: int = ITERS) -> Dict[str, object]:
    """Time one mode on placed masks and window; its row."""
    steps = masks.shape[0] // G
    gcnt = torch.full((steps,), int(G * frac), dtype=torch.int32, device=device)
    ms = time_ms(lambda: kernels.cond_steps(mode, gcnt, masks, win), device, iters)
    groups = int(kernels.group_runs(mode, gcnt, G).sum())
    row = {"tool": "microbench_cond", "variant": mode, "frac": frac, "steps": steps,
           "groups_run": groups, **bound_fields(cond_work(groups, steps), ms, device)}
    row["ns_per_slot"] = ms / steps / G * 1e6
    row["us_per_step"] = ms / steps * 1e3
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    if rest:
        raise SystemExit(f"microbench_cond takes no arguments besides --device, got {rest}")
    _, masks, win = inputs(1.0)  # the same arrays for every mode; only gcnt differs
    masks, win = masks.to(device), win.to(device)
    rows = []
    for mode, frac in RUNS:
        row = bench(mode, frac, device, masks, win)
        print(describe(row, f"[{mode} frac={frac}] {row['ns_per_slot']:7.2f} ns/slot  "
                            f"{row['us_per_step']:7.2f} us/step"), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
