"""The gather microbenchmark's CUDA kernels, their plain versions and their
launchers (tools/microbench_gather.py).

One wrapper per TPU kernel of tools/microbench_gather.py, each computing
its function with the kernels in ``csrc/microbench_gather.cu`` (helpers
shared with microbench_gather2 in ``csrc/gather.cuh``; design notes
there):

- ``vmem_loop(cols, vals, tier)``: out[o] = sum_k vals[o, k] tier[cols[o, k]];
- ``vmem_take(cols, tier)``: out[t] = tier[cols.flat[t]];
- ``onehot(cols, tier)``: out[t] = float32(tier[cols.flat[t]]), the
  function of the TPU's one-hot product over the tier's C rows (float32
  or bfloat16), an index outside [0, C) giving a zero row; on the card
  the row gather of vmem_take with that zero fill;
- ``block_slice(starts, tier)``: out[8i + j] = sum over the 8 K starts s of
  step i of tier[s + j]; on the card the counts of 16 steps' starts times
  the shifted tier on the tensor cores, or, where ``block_slice_plan``'s
  time models make it the faster, the rows read out of L2;
- ``row_dma(cols, table, W)``: out[o] = sum_{m < 16} table[cols.flat[16 o + m]],
  W rows in flight per warp.

On the CPU they run the plain versions; on the card they launch the kernel
or raise, and never fall back. Each launch adds one to its
``LAUNCHES["gather_<name>"]`` (ops/cuda/build.py). An index outside the
table stops every kernel but onehot with a device-side assertion; the
plain versions raise IndexError.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda.build import LAUNCHES, raise_if, require, same_device, stream

SOURCE = "microbench_gather.cu"
D = 128           # row width
GROUP = 16        # rows summed per output row of row_dma
ROW_BLOCK = 128   # lanes come as (T / 128, 128) arrays, as the TPU tools make them
CHUNK_ROWS = 2048  # output rows per chunk of the plain ELL version (134 MB at K = 128)
CHUNK_STEPS = 16   # steps per chunk of the plain block_slice (67 MB at K = 128)
BS_STEPS = 16      # steps a block of block_slice's count-matrix kernel (128 output rows)
BS_SUB = 64        # tier rows it stages at a time; its chunks are a multiple
BS_EXACT_RTOL = 3e-6  # the count path against block_slice_float64, elementwise (PERF.md)
MAX_CHUNKS = 65535  # chunks of the tier at most (the grid's second dimension)
# block_slice's two paths, each a model of its milliseconds on an H100
# fitted to the tool's path sweep (tools/microbench_gather.py blockpaths;
# PERF.md): a base, plus work a wave of blocks (one a SM) does
L2_MS = (0.005, 4.5e-4)         # base; per K of a step (a block sums 8 x 8K tier rows)
L2_BYTES_PER_S = 7.0e12         # its tier rows out of L2, at the rate it reaches
COUNT_MS = (0.0105, 3.1e-5, 1.0e-4)  # base; per chunk row a wave; per chunk summed
PARTIAL_BYTES_PER_S = 2.5e12    # the partials' sum, at the rate it reaches


def build() -> Dict[str, object]:
    """Compile csrc/microbench_gather.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_gather_ell_reduce.argtypes = [p, p, p, p, i64, i32, i64, i32, p]
    lib.ofs_gather_vmem_take.argtypes = [p, p, p, i64, i64, i32, p]
    lib.ofs_gather_onehot.argtypes = [i32, p, p, p, i64, i64, i32, p]
    lib.ofs_gather_block_slice.argtypes = [p, p, p, p, i64, i32, i64, i32, i32, p]
    lib.ofs_gather_row_sum.argtypes = [p, p, p, i64, i32, i32, i64, i32, p]
    for fn in (lib.ofs_gather_ell_reduce, lib.ofs_gather_vmem_take, lib.ofs_gather_onehot,
               lib.ofs_gather_block_slice, lib.ofs_gather_row_sum):
        fn.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def check_table(t: torch.Tensor, name: str, *dtypes: torch.dtype) -> None:
    """A contiguous (rows, 128) table of one of ``dtypes``, 16-byte aligned."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    require(t, name, t.dtype, 2)
    if t.shape[1] != D or t.shape[0] == 0:
        raise ValueError(f"{name} must be (rows > 0, {D}), got {tuple(t.shape)}")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_lanes(t: torch.Tensor, name: str, dtype: torch.dtype = torch.int32) -> int:
    """A contiguous (T / 128, 128) array of lanes; returns T."""
    require(t, name, dtype, 2)
    if t.shape[1] != ROW_BLOCK:
        raise ValueError(f"{name} must be (T / {ROW_BLOCK}, {ROW_BLOCK}), got {tuple(t.shape)}")
    return t.numel()


def check_ell(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> None:
    require(cols, "cols", torch.int32, 2)
    require(vals, "vals", torch.float32, 2)
    check_table(tier, "tier", torch.float32)
    same_device(cols, vals, tier)
    if vals.shape != cols.shape:
        raise ValueError(f"vals must be shaped like cols {tuple(cols.shape)}, got "
                         f"{tuple(vals.shape)}")


def card(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")


def ell_torch(cols: torch.Tensor, K: int, table: torch.Tensor,
              vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain ELL gather-reduce: out[o] = sum_k (vals[o, k] *) table[c], c
    the flat cols[K o + k] (float32 (cols.numel() / K, 128))."""
    idx = cols.reshape(-1, K).long()
    w = None if vals is None else vals.reshape(-1, K)
    out = torch.empty((idx.shape[0], D), dtype=torch.float32, device=table.device)
    for a in range(0, idx.shape[0], CHUNK_ROWS):
        rows = table[idx[a:a + CHUNK_ROWS]]
        if w is not None:
            rows = rows * w[a:a + CHUNK_ROWS, :, None]
        out[a:a + CHUNK_ROWS] = rows.sum(1)
    return out


def onehot_rows_torch(idx: torch.Tensor, table: torch.Tensor, window: int,
                      base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32(table[base + idx]) where 0 <= idx < window, else a zero row:
    a one-hot product's result (idx and base flat, one base per index)."""
    idx = idx.reshape(-1).long()
    inside = (idx >= 0) & (idx < window)
    src = idx.clamp(0, window - 1) + (0 if base is None else base)
    rows = table[src].float()
    rows[~inside] = 0.0
    return rows


def vmem_loop_torch(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of vmem_loop (float32 (cols.shape[0], 128))."""
    check_ell(cols, vals, tier)
    return ell_torch(cols, cols.shape[1], tier, vals)


def vmem_take_torch(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of vmem_take (float32 (T, 128))."""
    check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32)
    return tier[cols.reshape(-1).long()]


def onehot_torch(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of onehot (float32 (T, 128))."""
    check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32, torch.bfloat16)
    return onehot_rows_torch(cols, tier, tier.shape[0])


def _check_starts(starts: torch.Tensor, tier: torch.Tensor) -> int:
    """The steps R after checking types and shapes."""
    require(starts, "starts", torch.int32, 2)
    check_table(tier, "tier", torch.float32)
    same_device(starts, tier)
    if starts.shape[0] % 8 != 0 or tier.shape[0] < 8:
        raise ValueError(f"starts must have 8R rows and tier 8 rows or more, got "
                         f"{tuple(starts.shape)} and {tuple(tier.shape)}")
    return starts.shape[0] // 8


def block_slice_torch(starts: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """Plain version of block_slice (float32 (8R, 128))."""
    R = _check_starts(starts, tier)
    s = starts.view(R, 8 * starts.shape[1]).long()
    j = torch.arange(8, device=tier.device)
    out = torch.empty((R * 8, D), dtype=torch.float32, device=tier.device)
    for a in range(0, R, CHUNK_STEPS):
        blocks = tier[s[a:a + CHUNK_STEPS, :, None] + j]  # (r, 8K, 8, D)
        out[a * 8:(a + CHUNK_STEPS) * 8] = blocks.sum(1).reshape(-1, D)
    return out


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The count-matrix kernel's split of float32 x into three bfloat16
    pieces, as float32: hi = x's top 16 bits, mid = the top 16 bits of
    x - hi, lo = x - hi - mid. hi + mid + lo == x, and each piece is a
    bfloat16 value, for finite |x| >= 2^-110 and 0; below, lo keeps the
    bits of x at 2^-133 and above."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    return hi, mid, r - mid


def step_counts(starts: torch.Tensor, C: int) -> torch.Tensor:
    """N (R, C) int64: N[i, s] the number of the 8K starts of step i equal
    to s."""
    R = starts.shape[0] // 8
    s = starts.reshape(R, -1).long()
    return torch.zeros((R, C), dtype=torch.int64, device=s.device).scatter_add_(
        1, s, torch.ones_like(s))


def block_slice_counts_torch(starts: torch.Tensor, tier: torch.Tensor,
                             chunk_rows: int) -> torch.Tensor:
    """The count-matrix kernel's arithmetic in its order, on any device:
    per chunk of ``chunk_rows`` tier rows c, the products of each count's
    base-256 digits (digit x 256^d) shifted by j, N[i, c - j], with the
    three pieces of tier[c] (split_bf16x3), summed in float32; then the
    chunks added in chunk order."""
    R = _check_starts(starts, tier)
    C = tier.shape[0]
    N = step_counts(starts, C)
    pieces = split_bf16x3(tier)
    out = torch.zeros((R, 8, D), dtype=torch.float32, device=tier.device)
    for c0 in range(0, C, chunk_rows):
        c1 = min(C, c0 + chunk_rows)
        part = torch.zeros_like(out)
        for d in range(4):
            digit = ((N >> (8 * d)) & 255).float() * float(256 ** d)
            if not digit.any():
                continue
            for j in range(8):
                a = F.pad(digit, (j, 0))[:, c0:c1]  # a[i, c - c0] = digit[i, c - j]
                for p in pieces:
                    part[:, j] += a @ p[c0:c1]
        out += part
    return out.reshape(8 * R, D)


def block_slice_float64(starts: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """block_slice's function summed in float64 (float64 (8R, 128)), on any
    device: the reference that holds the count path's three exact pieces,
    whose float32 sums stay within BS_EXACT_RTOL of it where dropping the
    lo piece does not."""
    R = _check_starts(starts, tier)
    C = tier.shape[0]
    n, t = step_counts(starts, C).double(), tier.double()
    return torch.stack([n[:, :C - 7] @ t[j:j + C - 7] for j in range(8)], 1).reshape(8 * R, D)


def block_slice_macs(starts: torch.Tensor, C: int, chunk_rows: int) -> int:
    """The bf16 multiply-adds of the count-matrix kernel on chunks of
    ``chunk_rows`` tier rows: per block (16 steps, one chunk) 128 rows (the
    steps' counts at 8 shifts) x chunk_rows x 128 columns, times the 3
    pieces of each tier value, times the base-256 digits its counts have
    (the kernel runs a product per digit some count of the block has). How
    the kernel computes, reported beside a bound, never in it; 0 for the L2
    kernel (chunk_rows 0)."""
    if not chunk_rows:
        return 0
    R = starts.shape[0] // 8
    groups, chunks = -(-R // BS_STEPS), -(-C // chunk_rows)
    n = F.pad(step_counts(starts, C), (0, 0, 0, groups * BS_STEPS - R))
    # a block of chunk q reads the counts of starts [q chunk_rows - 7, + chunk_rows)
    q = torch.arange(chunks, device=n.device)
    lo, hi = (q * chunk_rows - 7).clamp(min=0), ((q + 1) * chunk_rows).clamp(max=C)
    digits = 0
    for d in range(4):
        has = (((n >> (8 * d)) & 255) != 0).view(groups, BS_STEPS, C).any(1).long()
        cum = F.pad(has.cumsum(1), (1, 0))
        digits += int(((cum[:, hi] - cum[:, lo]) > 0).sum())
    return digits * 128 * chunk_rows * D * 3


def block_slice_smem(chunk_rows: int) -> int:
    """Shared memory of a count-matrix block on chunks of ``chunk_rows``
    tier rows, in bytes (csrc/microbench_gather.cu bs_smem): the uint32
    counts of 16 steps, their bf16 digits twice (even and odd offsets), and
    three stages of the three pieces, each 16 groups of 8 columns x 64 k
    bf16 (1,040 bytes a group)."""
    return (4 * BS_STEPS * (chunk_rows + 8) + 2 * (2 * BS_STEPS * (chunk_rows + 16) + 32)
            + 3 * 3 * (D // 8) * (8 * 128 + 16))


def block_slice_chunk_rows(C: int, R: int, optin: int, sms: int) -> int:
    """The tier rows a block of the count-matrix kernel multiplies for a
    C-row tier and R steps: C cut into about sms / groups chunks (one wave
    of blocks), a multiple of BS_SUB, at most what ``optin`` bytes of
    shared memory hold; 0 where no chunk fits or C needs more than
    MAX_CHUNKS."""
    groups = -(-R // BS_STEPS)
    most = (optin - block_slice_smem(0)) // (8 * BS_STEPS) // BS_SUB * BS_SUB
    rows = min(most, -(-C // max(1, round(sms / groups)) // BS_SUB) * BS_SUB)
    return rows if rows >= BS_SUB and -(-C // rows) <= MAX_CHUNKS else 0


def block_slice_ms(C: int, K: int, R: int, optin: int, sms: int) -> Tuple[float, float]:
    """(the count path's, the L2 kernel's) modelled milliseconds for (8R, K)
    starts into a C-row tier (COUNT_MS, L2_MS); the count path's is inf
    where no chunk fits."""
    l2 = L2_MS[0] + max(-(-R // sms) * L2_MS[1] * K,
                        R * 8 * K * 8 * D * 4 / L2_BYTES_PER_S * 1e3)
    rows = block_slice_chunk_rows(C, R, optin, sms)
    if not rows:
        return float("inf"), l2
    groups, chunks = -(-R // BS_STEPS), -(-C // rows)
    partial = chunks * 8 * R * D * 4 if chunks > 1 else 0
    count = (COUNT_MS[0] + -(-(groups * chunks) // sms) * COUNT_MS[1] * rows
             + max(COUNT_MS[2] * chunks, partial / PARTIAL_BYTES_PER_S * 1e3))
    return count, l2


def block_slice_plan(C: int, K: int, R: int, optin: int, sms: int) -> int:
    """block_slice's path for (8R, K) starts into a C-row tier on a card
    with ``sms`` SMs and ``optin`` bytes of shared memory a block: the
    count-matrix kernel's chunk rows (block_slice_chunk_rows) where its
    modelled time is the smaller (block_slice_ms), else 0, the L2 kernel.
    A function of the shapes and the card alone, never of a failure."""
    if R <= 0:
        return 0
    count, l2 = block_slice_ms(C, K, R, optin, sms)
    return block_slice_chunk_rows(C, R, optin, sms) if count < l2 else 0


def check_row_sum(cols: torch.Tensor, table: torch.Tensor, W: int, group: int) -> None:
    """Lanes of ``group`` indices per output row into a float32 table, W
    rows in flight (row_dma, dma_deep)."""
    T = check_lanes(cols, "cols")
    check_table(table, "table", torch.float32)
    same_device(cols, table)
    if T % group != 0 or not 1 <= W <= 256:
        raise ValueError(f"need T a multiple of {group} and 1 <= W <= 256, got T={T} W={W}")


def row_dma_torch(cols: torch.Tensor, table: torch.Tensor, W: int = 16) -> torch.Tensor:
    """Plain version of row_dma (float32 (T / 16, 128)); W changes nothing."""
    check_row_sum(cols, table, W, GROUP)
    return ell_torch(cols, GROUP, table)


def ell_launch(name: str, cols: torch.Tensor, vals: torch.Tensor,
               tier: torch.Tensor) -> torch.Tensor:
    """Launch the weighted ELL gather-reduce (vmem_loop, take_fused),
    counted as ``name``."""
    check_ell(cols, vals, tier)
    card(cols.device, name)
    lib, dev = _lib(), cols.device
    out = torch.empty((cols.shape[0], D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_ell_reduce(cols.data_ptr(), vals.data_ptr(), tier.data_ptr(),
                                   out.data_ptr(), cols.shape[0], cols.shape[1], tier.shape[0],
                                   dev.index or 0, stream(dev))
    raise_if(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def vmem_loop(cols: torch.Tensor, vals: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_vmem_loop's function: the kernel on the card, the plain version
    on the CPU."""
    if cols.device.type == "cpu":
        return vmem_loop_torch(cols, vals, tier)
    return ell_launch("gather_vmem_loop", cols, vals, tier)


def vmem_take(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_vmem_take's function: the kernel on the card, the plain version
    on the CPU."""
    if cols.device.type == "cpu":
        return vmem_take_torch(cols, tier)
    T = check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32)
    same_device(cols, tier)
    card(cols.device, "vmem_take")
    lib, dev = _lib(), cols.device
    out = torch.empty((T, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_vmem_take(cols.data_ptr(), tier.data_ptr(), out.data_ptr(), T,
                                  tier.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_vmem_take")
    LAUNCHES["gather_vmem_take"] += 1
    return out


def onehot(cols: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_onehot_mxu's function (float32 (T, 128)): the kernel on the
    card (a row gather, zero rows outside [0, C)), the plain version on the
    CPU."""
    if cols.device.type == "cpu":
        return onehot_torch(cols, tier)
    T = check_lanes(cols, "cols")
    check_table(tier, "tier", torch.float32, torch.bfloat16)
    same_device(cols, tier)
    card(cols.device, "onehot")
    lib, dev = _lib(), cols.device
    out = torch.empty((T, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_onehot(int(tier.dtype == torch.bfloat16), cols.data_ptr(),
                               tier.data_ptr(), out.data_ptr(), T, tier.shape[0],
                               dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_onehot")
    LAUNCHES["gather_onehot"] += 1
    return out


def card_shape(dev: torch.device) -> Tuple[int, int]:
    """(opt-in shared memory per block in bytes, SMs) of the card: what
    block_slice_plan reads of it."""
    props = torch.cuda.get_device_properties(dev)
    return props.shared_memory_per_block_optin, props.multi_processor_count


def plan_on(starts: torch.Tensor, tier: torch.Tensor) -> int:
    """block_slice_plan for these tensors on their card."""
    return block_slice_plan(tier.shape[0], starts.shape[1], starts.shape[0] // 8,
                            *card_shape(starts.device))


def block_slice_launch(starts: torch.Tensor, tier: torch.Tensor,
                       chunk_rows: Optional[int] = None) -> torch.Tensor:
    """Launch block_slice on the path of block_slice_plan, or, where a
    caller compares the paths, on the one ``chunk_rows`` names (0: the L2
    kernel; else the count-matrix kernel on chunks of that many tier rows,
    a multiple of BS_SUB)."""
    R = _check_starts(starts, tier)
    card(starts.device, "block_slice")
    lib, dev = _lib(), starts.device
    rows = plan_on(starts, tier) if chunk_rows is None else chunk_rows
    if rows < 0 or rows % BS_SUB != 0:
        raise ValueError(f"chunk_rows must be 0 or a multiple of {BS_SUB}, got {rows}")
    if rows and starts.data_ptr() % 16 != 0:
        raise ValueError("starts must be 16-byte aligned for the count-matrix kernel")
    out = torch.empty((R * 8, D), dtype=torch.float32, device=dev)
    C = tier.shape[0]
    partial = (torch.empty((-(-C // rows), R * 8, D), dtype=torch.float32, device=dev)
               if rows and C > rows else None)
    rc = lib.ofs_gather_block_slice(starts.data_ptr(), tier.data_ptr(), out.data_ptr(),
                                    None if partial is None else partial.data_ptr(), R,
                                    starts.shape[1], C, rows, dev.index or 0, stream(dev))
    raise_if(lib, rc, "gather_block_slice")
    LAUNCHES["gather_block_slice"] += 1
    return out


def block_slice(starts: torch.Tensor, tier: torch.Tensor) -> torch.Tensor:
    """bench_block_slice's function (float32 (8R, 128)): on the card the
    kernel block_slice_plan picks (the count-matrix kernel or the L2
    kernel), the plain version on the CPU. A start outside [0, C - 8] stops
    either path with a device-side assertion."""
    if starts.device.type == "cpu":
        return block_slice_torch(starts, tier)
    return block_slice_launch(starts, tier)


def row_sum_launch(name: str, cols: torch.Tensor, table: torch.Tensor, W: int,
                   group: int) -> torch.Tensor:
    """Launch the ELL row sum of ``group`` rows per output row with W rows
    in flight per warp (row_dma, dma_deep), counted as ``name``."""
    check_row_sum(cols, table, W, group)
    card(cols.device, name)
    lib, dev = _lib(), cols.device
    n_out = cols.numel() // group
    out = torch.empty((n_out, D), dtype=torch.float32, device=dev)
    rc = lib.ofs_gather_row_sum(cols.data_ptr(), table.data_ptr(), out.data_ptr(), n_out, group,
                                W, table.shape[0], dev.index or 0, stream(dev))
    raise_if(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def row_dma(cols: torch.Tensor, table: torch.Tensor, W: int = 16) -> torch.Tensor:
    """bench_row_dma's function (float32 (T / 16, 128)): the kernel on the
    card with W rows in flight per warp, the plain version on the CPU."""
    if cols.device.type == "cpu":
        return row_dma_torch(cols, table, W)
    return row_sum_launch("gather_row_dma", cols, table, W, GROUP)
