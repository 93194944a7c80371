"""Probe dynamic gathers from an on-chip table, and the usable shared
memory, on Hopper.

The counterpart of tools/microbench_dyngather.py, with its names, sizes and
seeded inputs (numpy default_rng(0), the same calls in the same order). A
table (C, 128) float32 in L2, T gathered rows:

  tala_eq    take_along_axis on axis 0 with T == C
  tala_ne    the same with T != C
  tala_bcast one index per row (T, 1), broadcast across the 128 lanes
  perlane    per-lane independent indices (T, 128): the tala_ne call at C = 2048
  vmem_cap   the largest dynamic shared-memory buffer a block can take: sizes
             around the card's opt-in limit, largest first, until one works

take_along runs the TPU grid's 256 passes in one launch (ops/cuda/
microbench_dyngather.py). The passes are the work: the TPU tool's rate
counts every pass's gather out of VMEM, and the kernel runs them out of
shared memory, a slice of the table's lanes staged in each block (out of
L2 where C is too tall for one lane a slice). Each prints the time of a
launch and Mrows/s of 512-byte rows over all passes (T x 256 / t), beside
the card's bound: the larger of one pass's bytes from device memory and
the passes' words through shared memory (utils/roofline.take_along_work).
Its row also carries the time of one pass (per_pass_ms), the yardstick for
a one-pass library call. vmem_cap prints OK or FAILED for each size, with
the limit the card reports.

    python -m of_spmm_tpu_torch.tools.microbench_dyngather [names] [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_dyngather as kernels
from of_spmm_tpu_torch.tools.common import bound_fields, describe, split_device, time_ms
from of_spmm_tpu_torch.utils.roofline import smem_cap_work, take_along_work

D = 128
STEPS = 256
ITERS = 10
NAMES = ("tala_eq", "tala_ne", "tala_bcast", "perlane", "vmem_cap")
# (name, C, T, index shape): the TPU tool's main()
RUNS = (("tala_eq", 2048, 2048, "eq"), ("tala_ne", 2048, 1024, "ne"),
        ("tala_ne", 8192, 1024, "ne"),
        *(("tala_bcast", C, 1024, "bcast") for C in (512, 2048, 8192, 32768)),
        ("perlane", 2048, 1024, "ne"))
H100_OPTIN = 232448  # bytes; the size list's centre where no card reports one


def inputs(C: int, T: int, idx_shape: str, seed: int = 0):
    """(idx (Tn, 128) int32, table (C, 128) float32) as _run makes them
    (Tn = C for "eq")."""
    rng = np.random.default_rng(seed)
    table = rng.random((C, D), np.float32)
    if idx_shape == "eq":
        idx = rng.integers(0, C, (C, D)).astype(np.int32)
    elif idx_shape == "ne":
        idx = rng.integers(0, C, (T, D)).astype(np.int32)
    elif idx_shape == "bcast":
        idx = np.broadcast_to(rng.integers(0, C, (T, 1)).astype(np.int32), (T, D)).copy()
    else:
        raise ValueError(f"idx_shape must be eq, ne or bcast, got {idx_shape!r}")
    return torch.from_numpy(idx), torch.from_numpy(table)


def bench_take_along(device: torch.device, name: str, C: int, T: int, idx_shape: str,
                     steps: int) -> Dict[str, object]:
    idx, table = (a.to(device) for a in inputs(C, T, idx_shape))
    Tn = idx.shape[0]
    ms = time_ms(lambda: kernels.take_along(idx, table, steps), device, ITERS)
    row = {"tool": "microbench_dyngather", "kernel": "dyngather_take_along",
           "variant": f"{name} C={C} T={Tn}", "C": C, "T": Tn, "shape": idx_shape,
           "steps": steps,
           **bound_fields(take_along_work(idx, table, steps), ms, device)}
    row["mrows_per_s"] = Tn * steps / ms / 1e3
    row["per_pass_ms"] = ms / steps
    print(describe(row, f"[{name}] C={C} T={Tn}: {ms * 1e3:8.1f} us -> "
                        f"{row['mrows_per_s']:7.0f} Mrows/s "
                        f"({row['mrows_per_s'] * 512 / 1e3:6.1f} GB/s L2-side)"), flush=True)
    return row


def cap_sizes(limit: int) -> List[int]:
    """Sizes to probe around ``limit`` bytes, largest first: above it, at it
    and below it."""
    return [limit + 16384, limit + 1024, limit + 16, limit, limit - 16384]


def vmem_cap(device: torch.device) -> Dict[str, object]:
    """Probe sizes around the opt-in limit until one works; time that one.
    A refused size is the wrapper's RuntimeError, printed as FAILED."""
    limit = kernels.smem_optin(device)
    x = torch.ones((8, D), dtype=torch.float32, device=device)
    tried = []
    for nbytes in cap_sizes(limit or H100_OPTIN):
        try:
            out = kernels.smem_cap(x, nbytes)
            ok = bool(torch.equal(out, x))
        except RuntimeError as e:
            print(f"[vmem_cap] {nbytes:,} B dynamic shared memory: FAILED {str(e)[:120]} "
                  f"(opt-in limit {limit})", flush=True)
            tried.append((nbytes, False))
            continue
        if not ok:
            raise AssertionError(f"smem_cap at {nbytes} B returned other values than its input")
        tried.append((nbytes, True))
        print(f"[vmem_cap] {nbytes:,} B dynamic shared memory: OK (opt-in limit {limit})",
              flush=True)
        ms = time_ms(lambda: kernels.smem_cap(x, nbytes), device, ITERS)
        row = {"tool": "microbench_dyngather", "kernel": "dyngather_smem_cap",
               "variant": "largest that works", "nbytes": nbytes, "optin_limit": limit,
               "tried": tried,
               **bound_fields(smem_cap_work(x), ms, device)}
        print(describe(row, f"[vmem_cap] {nbytes:,} B copy"), flush=True)
        return row
    raise RuntimeError(f"no size of {cap_sizes(limit or H100_OPTIN)} worked")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, names = split_device(sys.argv[1:] if argv is None else argv)
    unknown = sorted(set(names) - set(NAMES))
    if unknown:
        raise SystemExit(f"unknown names {unknown}; known: {' '.join(NAMES)}")
    rows = []
    for name, C, T, shape in RUNS:
        if not names or name in names:
            rows.append(bench_take_along(device, name, C, T, shape, STEPS))
    if not names or "vmem_cap" in names:
        rows.append(vmem_cap(device))
    print("done", flush=True)
    return rows


if __name__ == "__main__":
    main()
