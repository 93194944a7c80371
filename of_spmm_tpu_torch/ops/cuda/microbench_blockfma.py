"""The block gather-FMA microbenchmark's CUDA kernels, their plain versions
and their launchers (tools/microbench_blockfma.py).

``blockfma_a(starts, w, tier)`` and ``blockfma_b(starts, vals, tier)``
compute the functions of the TPU kernels in tools/microbench_blockfma.py
(``bench_A``, ``bench_B``) with the kernels in
``csrc/microbench_blockfma.cu``; design notes are there. On the CPU they
run the plain versions; on the card they launch the kernel or raise, and
never fall back. Each launch adds one to ``LAUNCHES["microbench_blockfma_a"]``
or ``["microbench_blockfma_b"]`` (ops/cuda/build.py). A runs out of a column
slice of the tier held in each block's shared memory where ``a_plan``
takes it, else out of L2.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_blockfma.cu"
D = 128     # tier and output width
ROWS = 8    # output rows per step
CHUNK_STEPS = 256  # steps per chunk of the plain versions (A: 268 MB at K = 256)
# A's sliced kernel (csrc/microbench_blockfma.cu blockfma_a_sliced_kernel)
SLICE_COLS = 4     # tier columns a block holds
SMEM_FIXED = 1024 + 128  # alignment slack and the stages' mbarriers
STAGE_STEPS = 32   # steps a stage holds: 256 rows of w, one consumer thread each
STAGE_BYTES = STAGE_STEPS * ROWS * (32 * 4 + 16)  # 32 slots of w, then 4 start columns
MIN_STAGES, MAX_STAGES = 2, 8
TILES = 2 * STAGE_STEPS * ROWS * 16  # two output tiles of 256 rows, 16 bytes each
# the least C at which the sliced kernel takes the path: below it the L2
# kernel ran faster on an H100 (its tier of 1 MB or less stays in L1 and
# L2; the crossover lay between C 2,048 and 2,560, PERF.md)
A_SLICED_MIN_C = 2304


def a_stages(C: int, optin: int) -> int:
    """Stages of A's sliced kernel that fit ``optin`` bytes beside a
    4-column slice of the C-row tier and the output tiles, at most
    MAX_STAGES; 0 where fewer than MIN_STAGES fit."""
    room = optin - SMEM_FIXED - TILES - C * SLICE_COLS * 4
    n = min(MAX_STAGES, room // STAGE_BYTES)
    return n if n >= MIN_STAGES else 0


def a_plan(C: int, optin: int) -> int:
    """Stages of A's path for a C-row tier at the card's ``optin`` bytes:
    the sliced kernel's (a_stages) from A_SLICED_MIN_C rows to as many as
    fit, 0 (the L2 kernel) elsewhere. A function of C and the card alone,
    never of a failure."""
    return a_stages(C, optin) if C >= A_SLICED_MIN_C else 0


def smem_optin(device: torch.device) -> int:
    """The card's opt-in shared memory per block in bytes."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def staged_rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, its row length) as a 2-D TMA copy takes a 2-D array of 4-byte
    elements: rows a multiple of 16 bytes and a 16-byte aligned base; else
    a zero-padded copy."""
    if t.shape[1] % 4 == 0 and t.data_ptr() % 16 == 0:
        return t, t.shape[1]
    ld = -(-t.shape[1] // 4) * 4
    return F.pad(t, (0, ld - t.shape[1])), ld


def build() -> Dict[str, object]:
    """Compile csrc/microbench_blockfma.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_blockfma.argtypes = [i32, p, p, p, p, i64, i32, i64, i32, i32, i32, p]
    lib.ofs_blockfma.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check(starts: torch.Tensor, w: torch.Tensor, tier: torch.Tensor, a: bool) -> int:
    """The slot count K after checking types and shapes."""
    require(starts, "starts", torch.int32, 2)
    require(w, "w" if a else "vals", torch.float32, 2)
    require(tier, "tier", torch.float32, 2)
    same_device(starts, w, tier)
    R8, KK = starts.shape
    if R8 % ROWS != 0 or tier.shape[1] != D:
        raise ValueError(f"starts must have 8R rows and tier {D} columns, got {tuple(starts.shape)}"
                         f" and {tuple(tier.shape)}")
    K = KK * ROWS
    want = (R8, K) if a else (R8, KK)
    if tuple(w.shape) != want:
        raise ValueError(f"{'w' if a else 'vals'} must be {want}, got {tuple(w.shape)}")
    return K


def _slots(starts: torch.Tensor, K: int) -> torch.Tensor:
    """(R, K) int64: slot k of step r reads starts[8r + k % 8, k // 8]."""
    R = starts.shape[0] // ROWS
    return starts.view(R, ROWS, K // ROWS).permute(0, 2, 1).reshape(R, K).long()


def blockfma_a_torch(starts: torch.Tensor, w: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version: out[8r + j] = sum_k w[8r + j, k] * tier[s_k + j], with
    s_k = starts[8r + k % 8, k // 8] (float32 (8R, 128))."""
    K = _check(starts, w, tier, True)
    R = starts.shape[0] // ROWS
    s = _slots(starts, K)
    j = torch.arange(ROWS, device=tier.device)
    out = torch.empty((R * ROWS, D), dtype=torch.float32, device=tier.device)
    w3 = w.view(R, ROWS, K)
    for r0 in range(0, R, CHUNK_STEPS):
        r1 = min(r0 + CHUNK_STEPS, R)
        rows = tier[s[r0:r1, None, :] + j[None, :, None]]  # (r, 8, K, D)
        out[r0 * ROWS:r1 * ROWS] = torch.einsum("rjk,rjkd->rjd", w3[r0:r1], rows).reshape(-1, D)
    return out


def blockfma_b_torch(starts: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version: out[8r + c % 8] += v * tier[c] over the slots of step
    r, with c and v at [8r + k % 8, k // 8] of starts and vals (float32
    (8R, 128); rows no slot names are 0)."""
    K = _check(starts, vals, tier, False)
    R = starts.shape[0] // ROWS
    c = _slots(starts, K)
    v = vals.view(R, ROWS, K // ROWS).permute(0, 2, 1).reshape(R, K)
    out = torch.zeros((R * ROWS, D), dtype=torch.float32, device=tier.device)
    for r0 in range(0, R, CHUNK_STEPS):
        r1 = min(r0 + CHUNK_STEPS, R)
        cc = c[r0:r1]
        rows = (torch.arange(r0, r1, device=tier.device)[:, None] * ROWS + cc % ROWS).reshape(-1)
        out.index_add_(0, rows, (v[r0:r1, :, None] * tier[cc]).reshape(-1, D))
    return out


def _launch(variant: int, name: str, starts: torch.Tensor, w: torch.Tensor,
            tier: torch.Tensor, sliced: Optional[bool] = None) -> torch.Tensor:
    """Launch variant 0 (A) or 1 (B), counted as ``name``; A on the path of
    ``a_plan``, or, where a caller compares the paths, the one ``sliced``
    names."""
    K = _check(starts, w, tier, variant == 0)
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    R, C = starts.shape[0] // ROWS, tier.shape[0]
    ld, stages = K // ROWS, 0
    if variant == 0 and sliced is not False:
        optin = smem_optin(dev)
        stages = a_stages(C, optin) if sliced else a_plan(C, optin)
        if sliced and not stages:
            raise ValueError(f"no 4-column slice of {C} rows fits {optin} bytes of shared memory")
    # the output first: a padded copy must not take the block freed before the call
    out = torch.empty((starts.shape[0], D), dtype=torch.float32, device=dev)
    if stages:
        starts, ld = staged_rows(starts)
        w, _ = staged_rows(w)
    rc = lib.ofs_blockfma(variant, starts.data_ptr(), w.data_ptr(), tier.data_ptr(),
                          out.data_ptr(), R, K, C, ld, stages, dev.index or 0, stream(dev))
    raise_if(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def blockfma_a(starts: torch.Tensor, w: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_A's function (float32 (8R, 128)): the kernel on the card, the
    plain version on the CPU. A start with s + 8 > C stops the kernel with a
    device-side assertion."""
    if starts.device.type == "cpu":
        return blockfma_a_torch(starts, w, tier)
    return _launch(0, "microbench_blockfma_a", starts, w, tier)


def blockfma_b(starts: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_B's function (float32 (8R, 128)): the kernel on the card, the
    plain version on the CPU. A row c >= C stops the kernel with a
    device-side assertion."""
    if starts.device.type == "cpu":
        return blockfma_b_torch(starts, vals, tier)
    return _launch(1, "microbench_blockfma_b", starts, vals, tier)
