"""The fused-step microbenchmark's CUDA kernel, its plain version and its
launcher (tools/microbench_mxu.py).

``mxu_step(variant, blk, lidx, lrow, win)`` computes the function of the
TPU kernel in tools/microbench_mxu.py::run for one of its six variants with
the kernel in ``csrc/microbench_mxu.cu`` (one template instance per
variant; the functions are written out there). On the CPU it runs the
plain version; on the card it launches the kernel or raises, and never
falls back. Each launch adds one to ``LAUNCHES["microbench_mxu"]``
(ops/cuda/build.py). Both sum in float32 in another order than the TPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_mxu.cu"
VARIANTS = ("noop", "winread", "winstat", "rawdyn", "rawstat", "chain2")
_L = 128
CHUNK_STEPS = 250  # steps per chunk of the plain version (131 MB of rows at G = 8)
# step chunks of the kernel per SM: a 128-row half tile (32 KB of shared
# memory) leaves room for 2 chunks x 2 halves an SM, a 512-row one (128 KB)
# for one block
CHUNKS_PER_SM = {128: 2, 512: 1}


def build() -> Dict[str, object]:
    """Compile csrc/microbench_mxu.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_mxu_step.argtypes = [i32, p, p, p, p, p, i64, i32, i64, i32, i32, i32, p]
    lib.ofs_mxu_step.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def tile_rows(variant: str, R: int) -> int:
    """Rows of the output tile: R for chain2, 128 for the others."""
    return R if variant == "chain2" else _L


def _check(variant: str, blk, lidx, lrow, win, R: int):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    require(blk, "blk", torch.int32, 3)
    require(lidx, "lidx", torch.int32, 2)
    require(lrow, "lrow", torch.int32, 2)
    require(win, "win", torch.bfloat16, 2)
    same_device(blk, lidx, lrow, win)
    S, one, G = blk.shape
    if one != 1 or tuple(lidx.shape) != (S * G, _L) or tuple(lrow.shape) != (S * G, _L):
        raise ValueError(f"blk must be (S, 1, G) and lidx, lrow (S G, {_L}); got "
                         f"{tuple(blk.shape)}, {tuple(lidx.shape)}, {tuple(lrow.shape)}")
    if win.shape[1] != 2 * _L or win.shape[0] % _L != 0:
        raise ValueError(f"win must be (128 n, 256), got {tuple(win.shape)}")
    if not 0 < R <= 512:
        raise ValueError(f"R must be in 1..512, got {R}")
    return S, G


def mxu_step_torch(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
                   win: torch.Tensor, R: int = 512) -> torch.Tensor:
    """Plain version: the tile (float32 (rows, 128)) that ``variant`` sums
    over all S steps and G groups (the list in csrc/microbench_mxu.cu),
    with each lane's window row taken as its two 128-column halves added."""
    S, G = _check(variant, blk, lidx, lrow, win, R)
    dev = win.device
    out = torch.zeros((tile_rows(variant, R), _L), dtype=torch.float32, device=dev)
    if variant == "noop":
        out[0] = lidx.view(S, G, _L)[:, 0].to(torch.float32).sum(0)
        return out
    winf = win.to(torch.float32)
    halves = winf[:, :_L] + winf[:, _L:]  # (rows, 128): the lane's row, halves added
    lane = torch.arange(_L, device=dev)
    for i0 in range(0, S, CHUNK_STEPS):
        i1 = min(i0 + CHUNK_STEPS, S)
        if variant in ("winstat", "rawstat"):
            b = torch.arange(G, device=dev).expand(i1 - i0, G)
        else:
            b = blk[i0:i1, 0].long()
        if variant in ("winread", "winstat"):
            u = lane.expand(i1 - i0, G, _L)
        else:
            u = lidx[i0 * G:i1 * G].view(i1 - i0, G, _L).long()
        src = (b[..., None] * _L + u).reshape(-1)
        if variant == "chain2":
            dst = lrow[i0 * G:i1 * G].reshape(-1).long()
        else:
            dst = lane.repeat((i1 - i0) * G)
        out.index_add_(0, dst, halves[src])
    return out


def mxu_step(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
             win: torch.Tensor, R: int = 512) -> torch.Tensor:
    """The tile ``variant`` of tools/microbench_mxu.py::run computes (float32
    (R, 128) for chain2, (128, 128) otherwise): the kernel on the card, the
    plain version on the CPU. An index outside the window or the tile stops
    the kernel with a device-side assertion."""
    S, G = _check(variant, blk, lidx, lrow, win, R)
    dev = win.device
    if dev.type == "cpu":
        return mxu_step_torch(variant, blk, lidx, lrow, win, R)
    if dev.type != "cuda":
        raise ValueError(f"mxu_step runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    rows = tile_rows(variant, R)
    out = torch.zeros((rows, _L), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nchunk = max(1, min(S, sms * CHUNKS_PER_SM[512 if rows > _L else _L]))
    rc = lib.ofs_mxu_step(VARIANTS.index(variant), blk.data_ptr(), lidx.data_ptr(),
                          lrow.data_ptr(), win.data_ptr(), out.data_ptr(), S, G, win.shape[0],
                          rows, nchunk, dev.index or 0, stream(dev))
    raise_if(lib, rc, "microbench_mxu")
    LAUNCHES["microbench_mxu"] += 1
    return out
