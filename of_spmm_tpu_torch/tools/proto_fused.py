"""Prototype and rate measurement of the fused SpMM engine on Hopper.

The counterpart of tools/proto_fused.py. Per output tile of R rows, a
window of S rows of X is staged (SPT chunks of S / SPT rows named by
scols), each value split into a bf16 hi/lo pair; then each of the tile's
SPT compute steps of T lanes adds staged row 128 blk + lidx into tile row
lrow (the TPU tool's numpy oracle ``reference``). Modes:

  fused    each lane reaches its X row through both index levels, so
           nothing is staged
  dma      staging alone: every tile's window written to a buffer
  compute  the lane work alone, on the window dma staged before it

The modes run as the hand-written kernels of ops/cuda/proto_fused.py on
the same seeded inputs as the TPU tool, and report ms, us/step, lanes M/s
and staged rows M/s beside the card's bound for the same work
(utils/roofline.proto_fused_work) and the distinct rows it reads
(``distinct_rows``, utils/roofline.proto_fused_rows). fused against
max(compute, dma) says whether staging and compute overlap. --check holds
fused against the plain version; --kernels adds each CUDA kernel's device
ms per call on the card (``kernel_ms``, torch.profiler: fused and compute
launch a sort and a rows kernel).

    python -m of_spmm_tpu_torch.tools.proto_fused [R T S TILES] [--check] [--kernels] \
        [--modes=...] [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.cuda import proto_fused as kernels
from of_spmm_tpu_torch.tools.common import (
    bound_fields, describe, kernel_ms, split_device, time_ms)
from of_spmm_tpu_torch.utils.roofline import proto_fused_rows, proto_fused_work

_L = 128
N = 2449024  # rows of X (the TPU tool's: ogbn-products)
R, T, S, TILES, SPT = 512, 1024, 16000, 128, 25
MODES = ("compute", "dma", "fused")  # the TPU tool's order
ITERS = 8
CHECK_REL_TOL = 1e-5  # max-relative, fused against the plain version


def inputs(N: int, R: int, T: int, S: int, TILES: int, SPT: int,
           seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """(scols, lidx, lrow, blk, xp) as the TPU tool's build() makes them, on
    the CPU: (TILES + 1) SPT steps, G = T / 128 groups a step."""
    rng = np.random.default_rng(seed)
    G = T // _L
    steps = (TILES + 1) * SPT
    DELTA = S // SPT
    if S % SPT != 0 or DELTA % 8 != 0:
        raise ValueError(f"S / SPT must be a whole multiple of 8, got S={S} SPT={SPT}")
    xp = rng.random((N, _L), np.float32)
    scols = rng.integers(0, N, (steps, 8, DELTA // 8)).astype(np.int32)
    lidx = rng.integers(0, _L, (steps * G, _L)).astype(np.int32)
    lrow = rng.integers(0, R, (steps * G, _L)).astype(np.int32)
    blk = rng.integers(0, S // _L, (steps, 1, G)).astype(np.int32)
    return tuple(torch.from_numpy(a) for a in (scols, lidx, lrow, blk, xp))


def bench(mode: str, args, device: torch.device, R: int, S: int, TILES: int, SPT: int,
          staged: Optional[torch.Tensor], iters: int = ITERS) -> Dict[str, object]:
    """Time one mode on placed inputs (compute reads ``staged``, which dma
    wrote before); its row."""
    scols, lidx, lrow, blk, xp = args
    G = blk.shape[-1]
    ms = time_ms(lambda: kernels.proto_fused(mode, *args, R=R, S=S, SPT=SPT, TILES=TILES,
                                             staged=staged), device, iters)
    steps = TILES * SPT
    row = {"tool": "proto_fused", "variant": mode, "R": R, "T": G * _L, "S": S, "TILES": TILES,
           "distinct_rows": proto_fused_rows(mode, scols, lidx, blk, S, SPT, TILES),
           **bound_fields(proto_fused_work(mode, scols, lidx, lrow, blk, R, S, SPT, TILES), ms,
                          device)}
    row["us_per_step"] = ms / steps * 1e3
    row["lanes_m_per_s"] = G * _L * steps / ms / 1e3
    row["staged_rows_m_per_s"] = (S // SPT) * steps / ms / 1e3
    return row


def check_fused(args, R: int, S: int, TILES: int, SPT: int) -> float:
    """max |kernel - plain| / max |plain| of fused; raises above
    CHECK_REL_TOL."""
    got = kernels.proto_fused("fused", *args, R=R, S=S, SPT=SPT, TILES=TILES)
    want = kernels.proto_fused_torch("fused", *args, R=R, S=S, SPT=SPT, TILES=TILES)
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    if not err <= CHECK_REL_TOL:
        raise AssertionError(f"proto_fused fused: rel err {err} against the plain version")
    return err


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    pos = [a for a in rest if not a.startswith("--")]
    r = int(pos[0]) if len(pos) > 0 else R
    t = int(pos[1]) if len(pos) > 1 else T
    s = int(pos[2]) if len(pos) > 2 else S
    tiles = int(pos[3]) if len(pos) > 3 else TILES
    check, per_kernel = "--check" in rest, "--kernels" in rest
    s = (s // (SPT * 64)) * SPT * 64  # as the TPU tool rounds it
    picked = [a.split("=", 1)[1] for a in rest if a.startswith("--modes=")]
    modes = picked[0].split(",") if picked else list(MODES)
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m!r}; one of {MODES}")
    args = tuple(a.to(device) for a in inputs(N, r, t, s, tiles, SPT))
    staged = None
    if "compute" in modes or "dma" in modes:
        staged = torch.empty(kernels.staged_shape(s, tiles), dtype=torch.float32, device=device)
        kernels.proto_fused("dma", *args, R=r, S=s, SPT=SPT, TILES=tiles, staged=staged)
    rows = []
    for mode in modes:
        row = bench(mode, args, device, r, s, tiles, SPT, staged)
        if per_kernel and device.type == "cuda":
            row["kernel_ms"] = kernel_ms(lambda: kernels.proto_fused(
                mode, *args, R=r, S=s, SPT=SPT, TILES=tiles, staged=staged), ITERS)
            print("  kernels: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row["kernel_ms"].items()),
                  flush=True)
        if check and mode == "fused":
            row["rel_err_vs_plain"] = check_fused(args, r, s, tiles, SPT)
            print(f"  fused rel err: {row['rel_err_vs_plain']:.2e}", flush=True)
        print(describe(row, f"[{mode}] R={r} T={t} S={s}: {row['us_per_step']:7.2f} us/step, "
                            f"lanes {row['lanes_m_per_s']:7.0f} M/s, staged rows "
                            f"{row['staged_rows_m_per_s']:6.0f} M/s, "
                            f"{row['distinct_rows']:,} distinct rows read"), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
