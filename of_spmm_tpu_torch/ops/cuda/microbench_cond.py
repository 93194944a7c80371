"""The predication microbenchmark's CUDA kernel, its plain version and its
launcher (tools/microbench_cond.py).

``cond_steps(mode, gcnt, masks, win)`` computes every step's tile of the
TPU kernel in tools/microbench_cond.py::make (float32 (steps, 128, 128))
with the kernel in ``csrc/microbench_cond.cu``; the TPU function's result
is the last step's tile (``[-1]``), since every TPU step overwrites it.
On the CPU it runs the plain version; on the card it launches the kernel
or raises, and never falls back. Each launch adds one to
``LAUNCHES["microbench_cond"]`` (ops/cuda/build.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_cond.cu"
MODES = ("nocond", "cond_all", "cond_half", "when_all", "when_half")
SUB = 4     # groups per predicated sub-block
_L = 128
CHUNK_STEPS = 32  # steps per chunk of the plain version (256 MB of products at G = 32)


def build() -> Dict[str, object]:
    """Compile csrc/microbench_cond.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_cond_steps.argtypes = [i32, p, p, p, p, i64, i32, i32, p]
    lib.ofs_cond_steps.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _kind(mode: str) -> int:
    """0 nocond, 1 cond (registers), 2 when (adds into the tile)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return ("nocond", "cond", "when").index(mode.split("_")[0])


def _check(mode: str, gcnt, masks, win) -> int:
    _kind(mode)
    require(gcnt, "gcnt", torch.int32, 1)
    require(masks, "masks", torch.int32, 3)
    require(win, "win", torch.bfloat16, 2)
    same_device(gcnt, masks, win)
    steps = gcnt.shape[0]
    if (steps == 0 or masks.shape[0] % steps != 0 or tuple(masks.shape[1:]) != (4, _L)
            or tuple(win.shape) != (_L, 2 * _L)):
        raise ValueError(f"masks must be (steps G, 4, 128) and win (128, 256); got "
                         f"{tuple(masks.shape)}, {tuple(win.shape)} for {steps} steps")
    return masks.shape[0] // steps


def group_runs(mode: str, gcnt: torch.Tensor, G: int) -> torch.Tensor:
    """(steps, G) bool: which groups each step runs. nocond runs all; the
    others run the sub-blocks of 4 groups whose first group s0 has
    gcnt > s0."""
    first = (torch.arange(G, device=gcnt.device) // SUB) * SUB
    if _kind(mode) == 0:
        return torch.ones((gcnt.shape[0], G), dtype=torch.bool, device=gcnt.device)
    return gcnt[:, None] > first[None, :]


def cond_steps_torch(mode: str, gcnt: torch.Tensor, masks: torch.Tensor,
                     win: torch.Tensor) -> torch.Tensor:
    """Plain version, as the TPU computes a step: each group's product
    bits^T @ win (float32, 256 columns), with bit k of column c =
    (masks[g, k // 32, c] >> k % 32) & 1, summed over the groups the step
    runs, then the two 128-column halves added."""
    G = _check(mode, gcnt, masks, win)
    steps, dev = gcnt.shape[0], win.device
    runs = group_runs(mode, gcnt, G).to(torch.float32)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    winf = win.to(torch.float32)
    out = torch.empty((steps, _L, _L), dtype=torch.float32, device=dev)
    for s0 in range(0, steps, CHUNK_STEPS):
        s1 = min(s0 + CHUNK_STEPS, steps)
        m = masks[s0 * G:s1 * G]
        bits = ((m[:, :, None, :] >> shifts[None, None, :, None]) & 1).reshape(-1, _L, _L)
        prod = torch.matmul(bits.to(torch.float32).transpose(1, 2), winf)  # (g, c, 256)
        acc = torch.einsum("sg,sgcn->scn", runs[s0:s1], prod.view(s1 - s0, G, _L, 2 * _L))
        out[s0:s1] = acc[..., :_L] + acc[..., _L:]
    return out


def cond_steps(mode: str, gcnt: torch.Tensor, masks: torch.Tensor,
               win: torch.Tensor) -> torch.Tensor:
    """Every step's tile of ``mode`` (float32 (steps, 128, 128)): the kernel
    on the card, the plain version on the CPU."""
    G = _check(mode, gcnt, masks, win)
    dev = win.device
    if dev.type == "cpu":
        return cond_steps_torch(mode, gcnt, masks, win)
    if dev.type != "cuda":
        raise ValueError(f"cond_steps runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    out = torch.empty((gcnt.shape[0], _L, _L), dtype=torch.float32, device=dev)
    rc = lib.ofs_cond_steps(_kind(mode), gcnt.data_ptr(), masks.data_ptr(), win.data_ptr(),
                            out.data_ptr(), gcnt.shape[0], G, dev.index or 0, stream(dev))
    raise_if(lib, rc, "microbench_cond")
    LAUNCHES["microbench_cond"] += 1
    return out
