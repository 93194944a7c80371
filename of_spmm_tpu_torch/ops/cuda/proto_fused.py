"""The fused-engine prototype's CUDA kernels, their plain versions and
their launcher (tools/proto_fused.py).

``proto_fused(mode, scols, lidx, lrow, blk, xp, R=, S=, SPT=, TILES=)``
computes the function of the numpy oracle of tools/proto_fused.py
(``reference``) with the kernels in ``csrc/proto_fused.cu``, in one of
three modes: ``fused`` (no staged window), ``dma`` (stage every tile's
window into ``staged`` and return zeros) and ``compute`` (the lane work on
a window ``dma`` staged). On the CPU it runs the plain version; on the
card it launches the kernels or raises, and never falls back: ``dma`` one
staging kernel, ``fused`` and ``compute`` a sort of each tile's lanes by
output row, then a kernel that sums each row where it is computed. Each
call adds one to ``LAUNCHES["proto_fused"]`` (ops/cuda/build.py).

Each staged value v counts as bf16(v) + bf16(v - bf16(v)), rounded to
nearest even, as the oracle's hi/lo pair; the sums are float32, in another
order than the oracle's (on the card, one that varies from run to run: the
kernel sorts each tile's lanes by output row with shared-memory atomics).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "proto_fused.cu"
MODES = ("fused", "compute", "dma")
_L = 128
CHUNK_STEPS = 250  # compute steps per chunk of the plain version (131 MB at G = 8)


def build() -> Dict[str, object]:
    """Compile csrc/proto_fused.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_proto_fused.argtypes = [i32] + [p] * 9 + [i64] + [i32] * 6 + [p]
    lib.ofs_proto_fused.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def hilo(x: torch.Tensor) -> torch.Tensor:
    """float32 x as bf16(x) + bf16(x - bf16(x)), each rounded to nearest even."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).to(torch.float32)


def staged_shape(S: int, TILES: int) -> tuple:
    return (TILES, S, _L)


def _check(mode, scols, lidx, lrow, blk, xp, R, S, SPT, TILES, staged) -> int:
    """G = T / 128 after checking types and shapes."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    for t, name, ndim in ((scols, "scols", 3), (lidx, "lidx", 2), (lrow, "lrow", 2),
                          (blk, "blk", 3)):
        require(t, name, torch.int32, ndim)
    require(xp, "xp", torch.float32, 2)
    same_device(scols, lidx, lrow, blk, xp)
    if min(R, S, SPT, TILES) <= 0 or S % SPT != 0:
        raise ValueError(f"need R, S, SPT, TILES > 0 and S a multiple of SPT; "
                         f"got R={R} S={S} SPT={SPT} TILES={TILES}")
    steps, G = (TILES + 1) * SPT, blk.shape[-1]
    if (blk.numel() != steps * G or scols.numel() != steps * (S // SPT)
            or tuple(lidx.shape) != (steps * G, _L) or tuple(lrow.shape) != (steps * G, _L)
            or xp.shape[1] != _L):
        raise ValueError(f"shapes do not match {steps} steps of {G} groups: scols "
                         f"{tuple(scols.shape)}, lidx {tuple(lidx.shape)}, lrow "
                         f"{tuple(lrow.shape)}, blk {tuple(blk.shape)}, xp {tuple(xp.shape)}")
    if mode != "fused":
        if staged is None:
            raise ValueError(f"mode {mode!r} needs the staging buffer `staged`")
        require(staged, "staged", torch.float32, 3)
        same_device(xp, staged)
        if tuple(staged.shape) != staged_shape(S, TILES):
            raise ValueError(f"staged must be {staged_shape(S, TILES)}, got {tuple(staged.shape)}")
    return G


def lane_sources(scols, lidx, blk, S: int, SPT: int, TILES: int, i0: int, i1: int,
                 staged: bool):
    """For the lanes of compute steps SPT + i0 .. SPT + i1 - 1 (of tiles
    i0 // SPT ...): (the tile of each lane, the row each reads: X row
    through both levels of the index, or with ``staged`` the row
    t S + u of the staging buffer). Flat int64, lane order."""
    G, DELTA = blk.shape[-1], S // SPT
    dev = lidx.device
    i = torch.arange(SPT + i0, SPT + i1, device=dev)
    t = (i // SPT - 1)[:, None, None]
    b = blk.view(-1, G)[SPT + i0:SPT + i1].long()[..., None]
    u = b * _L + lidx[(SPT + i0) * G:(SPT + i1) * G].view(-1, G, _L).long()
    if staged:
        return t.expand_as(u).reshape(-1), (t * S + u).reshape(-1)
    flat = scols.reshape(-1, DELTA)
    src = flat[t * SPT + u // DELTA, u % DELTA]
    return t.expand_as(u).reshape(-1), src.reshape(-1).long()


def proto_fused_torch(mode: str, scols: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
                      blk: torch.Tensor, xp: torch.Tensor, *, R: int, S: int, SPT: int, TILES: int,
                      staged: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version (float32 (TILES R, 128)): the oracle's staging and
    hi/lo split, then each lane's row added into row lrow of its tile."""
    _check(mode, scols, lidx, lrow, blk, xp, R, S, SPT, TILES, staged)
    out = torch.zeros((TILES * R, _L), dtype=torch.float32, device=xp.device)
    if mode == "dma":
        DELTA = S // SPT
        chunks = staged.view(TILES * SPT, DELTA, _L)
        flat = scols.reshape(-1, DELTA)
        for c0 in range(0, TILES * SPT, CHUNK_STEPS):
            c1 = min(c0 + CHUNK_STEPS, TILES * SPT)
            chunks[c0:c1] = xp[flat[c0:c1].long()]
        return out
    G = blk.shape[-1]
    table = staged.view(-1, _L) if mode == "compute" else xp
    for i0 in range(0, TILES * SPT, CHUNK_STEPS):
        i1 = min(i0 + CHUNK_STEPS, TILES * SPT)
        t, src = lane_sources(scols, lidx, blk, S, SPT, TILES, i0, i1, mode == "compute")
        dst = t * R + lrow[(SPT + i0) * G:(SPT + i1) * G].reshape(-1).long()
        out.index_add_(0, dst, hilo(table[src]))
    return out


def proto_fused(mode: str, scols: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
                blk: torch.Tensor, xp: torch.Tensor, *, R: int, S: int, SPT: int, TILES: int,
                staged: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prototype's output in ``mode`` (float32 (TILES R, 128)): the
    kernel on the card, the plain version on the CPU. ``dma`` writes
    ``staged`` ((TILES, S, 128) float32) and returns zeros; ``compute``
    reads it. An index outside its array stops the kernel with a
    device-side assertion."""
    G = _check(mode, scols, lidx, lrow, blk, xp, R, S, SPT, TILES, staged)
    dev = xp.device
    if dev.type == "cpu":
        return proto_fused_torch(mode, scols, lidx, lrow, blk, xp, R=R, S=S, SPT=SPT,
                                 TILES=TILES, staged=staged)
    if dev.type != "cuda":
        raise ValueError(f"proto_fused runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    order = offsets = None
    if mode == "dma":
        out = torch.zeros((TILES * R, _L), dtype=torch.float32, device=dev)
    else:  # the kernel writes every row (zeros where no lane selects it)
        out = torch.empty((TILES * R, _L), dtype=torch.float32, device=dev)
        # scratch: each tile's lane sources sorted by row, and the rows' offsets
        order = torch.empty((TILES, SPT * G * _L), dtype=torch.int32, device=dev)
        offsets = torch.empty((TILES, R + 1), dtype=torch.int32, device=dev)
    rc = lib.ofs_proto_fused(MODES.index(mode), scols.data_ptr(), lidx.data_ptr(),
                             lrow.data_ptr(), blk.data_ptr(), xp.data_ptr(),
                             None if staged is None else staged.data_ptr(), out.data_ptr(),
                             None if order is None else order.data_ptr(),
                             None if offsets is None else offsets.data_ptr(),
                             xp.shape[0], R, S, SPT, TILES, G, dev.index or 0, stream(dev))
    raise_if(lib, rc, "proto_fused")
    LAUNCHES["proto_fused"] += 1
    return out
