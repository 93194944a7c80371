"""The block gather-FMA microbenchmark's CUDA kernels, their plain versions
and their launchers (tools/microbench_blockfma.py).

``blockfma_a(starts, w, tier)`` and ``blockfma_b(starts, vals, tier)``
compute the functions of the TPU kernels in tools/microbench_blockfma.py
(``bench_A``, ``bench_B``) with the kernels in
``csrc/microbench_blockfma.cu``; design notes are there. On the CPU they
run the plain versions; on the card they launch the kernel or raise, and
never fall back. Each launch adds one to ``LAUNCHES["microbench_blockfma_a"]``
or ``["microbench_blockfma_b"]`` (ops/cuda/build.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_blockfma.cu"
D = 128     # tier and output width
ROWS = 8    # output rows per step
CHUNK_STEPS = 256  # steps per chunk of the plain versions (A: 268 MB at K = 256)


def build() -> Dict[str, object]:
    """Compile csrc/microbench_blockfma.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_blockfma.argtypes = [i32, p, p, p, p, i64, i32, i64, i32, p]
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
            tier: torch.Tensor) -> torch.Tensor:
    K = _check(starts, w, tier, variant == 0)
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    out = torch.empty((starts.shape[0], D), dtype=torch.float32, device=dev)
    rc = lib.ofs_blockfma(variant, starts.data_ptr(), w.data_ptr(), tier.data_ptr(),
                          out.data_ptr(), starts.shape[0] // ROWS, K, tier.shape[0],
                          dev.index or 0, stream(dev))
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
