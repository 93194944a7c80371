"""The fused-step microbenchmark's CUDA kernel, its plain version and its
launcher (tools/microbench_mxu.py).

``mxu_step(variant, blk, lidx, lrow, win)`` computes the function of the
TPU kernel in tools/microbench_mxu.py::run for one of its six variants with
the kernels in ``csrc/microbench_mxu.cu`` (the functions are written out
there). Every variant but noop is one product, out = Cnt @ win[:, :128] +
Cnt @ win[:, 128:], with Cnt[r, w] the lanes that send window row w to
tile row r (``count_matrix``): one block per window block (in
``count_plan``'s parts and tiles) counts that block's lanes in shared
memory and multiplies its counts with the block's window rows on the
tensor cores, each count cut into exact base-256 bf16 digits. On
the CPU the wrapper runs the plain version; on the card it launches the
kernels or raises, and never falls back. Each call on the card adds one to
``LAUNCHES["microbench_mxu"]`` (ops/cuda/build.py). The kernels sum in
float32 in another order than the TPU, the plain version in float64.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_mxu.cu"
VARIANTS = ("noop", "winread", "winstat", "rawdyn", "rawstat", "chain2")
_L = 128
CHUNK_STEPS = 125  # steps per chunk of the plain version (131 MB of float64 rows at G = 8)
MAX_WIN_ROWS = 65535 * _L  # window blocks the kernel's grid holds
COUNT_ROWS = 256  # tile rows a block holds at most (136 KB of uint32 counts)
_SMS: Dict[int, int] = {}  # the cards' SM counts, by device index


def build() -> Dict[str, object]:
    """Compile csrc/microbench_mxu.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_mxu_step.argtypes = [i32, p, p, p, p, p, i64, i32, i64, i32, i32, i32, i32, i32, p]
    lib.ofs_mxu_step.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def tile_rows(variant: str, R: int) -> int:
    """Rows of the output tile: R for chain2, 128 for the others."""
    return R if variant == "chain2" else _L


def count_plan(variant: str, S: int, G: int, win_rows: int, rows: int,
               sms: int) -> Tuple[int, int, int]:
    """(nb, parts, rows_t) of the kernel's grid: nb window blocks the lanes
    read (G for winstat and rawstat, every block of the window otherwise),
    their items cut into ``parts`` so that nb x parts x row tiles fill the
    SMs (one part where a block's count is its item count), and tile rows
    of rows_t (256 where they divide the rows rounded up to 128, else
    128)."""
    static = variant in ("winstat", "rawstat")
    nb = G if static else win_rows // _L
    rows_pad = -(-rows // _L) * _L
    rows_t = COUNT_ROWS if rows_pad % COUNT_ROWS == 0 else _L
    if variant in ("winread", "winstat"):  # a block's count is its item count: one part
        return nb, 1, rows_t
    parts = max(1, min(sms // (nb * (rows_pad // rows_t)), S if static else S * G, 65535))
    return nb, parts, rows_t


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
    if win.shape[1] != 2 * _L or win.shape[0] % _L != 0 or not 0 < win.shape[0] <= MAX_WIN_ROWS:
        raise ValueError(f"win must be (128 n, 256) with 0 < 128 n <= {MAX_WIN_ROWS}, got "
                         f"{tuple(win.shape)}")
    if win.data_ptr() % 16 != 0:
        raise ValueError("win must be 16-byte aligned")
    if not 0 < R <= 512:
        raise ValueError(f"R must be in 1..512, got {R}")
    if S * G * _L >= 1 << 32:
        raise ValueError(f"S G 128 lanes must stay below 2^32 (the counts are uint32), got "
                         f"{S * G * _L}")
    return S, G


def _lanes(variant: str, blk, lidx, lrow, i0: int, i1: int):
    """(dst, src) of the lanes of steps [i0, i1): the tile row and the
    window row of each, flat int64."""
    G, dev = blk.shape[2], blk.device
    lane = torch.arange(_L, device=dev)
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
    return dst, src


def count_matrix(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
                 win_rows: int, R: int = 512) -> torch.Tensor:
    """Cnt (int64 (rows, win_rows)): the lanes of ``variant`` (not noop)
    that send window row w to tile row r, out = Cnt @ (win[:, :128] +
    win[:, 128:]). Raises IndexError where a lane names a row outside the
    window or the tile."""
    S, G = blk.shape[0], blk.shape[2]
    if variant not in VARIANTS[1:]:
        raise ValueError(f"variant must be one of {VARIANTS[1:]}, got {variant!r}")
    rows = tile_rows(variant, R)
    dst, src = _lanes(variant, blk, lidx, lrow, 0, S)
    if dst.numel() and (int(src.min()) < 0 or int(src.max()) >= win_rows
                        or int(dst.min()) < 0 or int(dst.max()) >= rows):
        raise IndexError(f"{variant}: a lane names a row outside the window or the tile")
    return torch.bincount(dst * win_rows + src, minlength=rows * win_rows).view(rows, win_rows)


def count_csr(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
              win_rows: int, R: int = 512) -> torch.Tensor:
    """``count_matrix`` as a float32 sparse CSR tensor: torch.sparse.mm of
    it and the window's halves added in float32 is the one PyTorch call
    that computes ``variant``'s tile (the library yardstick of chip_smoke.py)."""
    return count_matrix(variant, blk, lidx, lrow, win_rows, R).to(torch.float32).to_sparse_csr()


def mxu_step_torch(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
                   win: torch.Tensor, R: int = 512) -> torch.Tensor:
    """Plain version: the tile (float32 (rows, 128)) that ``variant`` sums
    over all S steps and G groups (the list in csrc/microbench_mxu.cu),
    with each lane's window row taken as its two 128-column halves added
    in float32. The lanes add in float64: up to S G 128 of them add into
    one tile row (2,048,000 at the tool's defaults), and a float32 sum of
    that many is off by about 1e-2 of its value, past the kernels' bar."""
    S, G = _check(variant, blk, lidx, lrow, win, R)
    dev = win.device
    out = torch.zeros((tile_rows(variant, R), _L), dtype=torch.float32, device=dev)
    if variant == "noop":
        out[0] = lidx.view(S, G, _L)[:, 0].to(torch.float32).sum(0)
        return out
    winf = win.to(torch.float32)
    halves = (winf[:, :_L] + winf[:, _L:]).double()  # the lane's row, halves added
    acc = out.double()
    for i0 in range(0, S, CHUNK_STEPS):
        dst, src = _lanes(variant, blk, lidx, lrow, i0, min(i0 + CHUNK_STEPS, S))
        acc.index_add_(0, dst, halves[src])
    return acc.to(torch.float32)


def mxu_step(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
             win: torch.Tensor, R: int = 512) -> torch.Tensor:
    """The tile ``variant`` of tools/microbench_mxu.py::run computes (float32
    (R, 128) for chain2, (128, 128) otherwise): on the card a memset of
    the tile and one kernel (noop its own), on the CPU the plain version.
    An index outside the window or the tile stops the kernel with a
    device-side assertion."""
    S, G = _check(variant, blk, lidx, lrow, win, R)
    dev = win.device
    if dev.type == "cpu":
        return mxu_step_torch(variant, blk, lidx, lrow, win, R)
    if dev.type != "cuda":
        raise ValueError(f"mxu_step runs on cuda or cpu tensors, got {dev}")
    lib = _lib()
    rows = tile_rows(variant, R)
    index = dev.index or 0
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(dev).multi_processor_count
    nb, parts, rows_t = count_plan(variant, S, G, win.shape[0], rows, _SMS[index])
    out = torch.empty((rows, _L), dtype=torch.float32, device=dev)  # zeroed by the call
    rc = lib.ofs_mxu_step(VARIANTS.index(variant), blk.data_ptr(), lidx.data_ptr(),
                          lrow.data_ptr(), win.data_ptr(), out.data_ptr(), S, G, win.shape[0],
                          rows, nb, parts, rows_t, index, stream(dev))
    raise_if(lib, rc, "microbench_mxu")
    LAUNCHES["microbench_mxu"] += 1
    return out
