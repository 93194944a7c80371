"""Roofline model and CUDA-event timing for the sparse kernels.

SpMM moves far more bytes than it computes on, so its speed of light is
bytes over the card's HBM bandwidth. Two traffic models bound one
Y = A @ X:

- ``total_bytes`` (per-nnz gather model): every nonzero reads its X row
  from memory, plus structure and output. This is the model the JAX
  package reports against.
- ``compulsory_bytes``: X is read once, plus structure and output. On a
  card whose L2 holds much of X (50 MB on the H100), repeated row reads
  hit the cache, so this is the tighter bound.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

# Peak HBM bandwidth (bytes/s), keyed by a substring of the name that
# torch.cuda.get_device_name() reports. NVIDIA H100 data sheet: SXM5 80 GB
# HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s, NVL 94 GB HBM3 3.9 TB/s.
PEAK_HBM_BYTES_PER_S: Dict[str, float] = {
    "H100 80GB HBM3": 3.35e12,
    "H100 SXM": 3.35e12,
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}

# Peak float32 rate outside the tensor cores (FLOP/s), same data sheet.
PEAK_FP32_FLOPS: Dict[str, float] = {
    "H100 80GB HBM3": 67e12,
    "H100 SXM": 67e12,
    "H100 PCIe": 51e12,
    "H100 NVL": 60e12,
}

# Peak dense bfloat16 / float16 tensor-core rate (FLOP/s), same data
# sheet (half the rate it lists with sparsity).
PEAK_TENSOR16_FLOPS: Dict[str, float] = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
}

# Peak dense TF32 tensor-core rate (FLOP/s), same data sheet: SXM 495
# TFLOP/s; PCIe and NVL half their bfloat16 / float16 entry.
PEAK_TF32_FLOPS: Dict[str, float] = {
    "H100 80GB HBM3": 495e12,
    "H100 SXM": 495e12,
    "H100 PCIe": 378e12,
    "H100 NVL": 417.5e12,
}

# Peak shared-memory rate (4-byte words/s): 32 banks of 4 bytes a clock on
# every SM, times the SMs, times the card's max SM clock. H100 80GB HBM3 /
# SXM: 132 SMs at 1,980 MHz (`nvidia-smi --query-gpu=clocks.max.sm` on the
# card); PCIe 114 SMs at 1,755 MHz and NVL 132 at 1,785 MHz (NVIDIA's data
# sheets' boost clocks).
PEAK_SMEM_WORDS_PER_S: Dict[str, float] = {
    "H100 80GB HBM3": 132 * 32 * 1.98e9,
    "H100 SXM": 132 * 32 * 1.98e9,
    "H100 PCIe": 114 * 32 * 1.755e9,
    "H100 NVL": 132 * 32 * 1.785e9,
}

# untimed calls before each measurement (build, caches, allocator)
WARMUP_CALLS = 3


def _lookup(table: Dict[str, float], device_name: str) -> float:
    for key, value in table.items():
        if key in device_name:
            return value
    raise KeyError(f"no published peak for device {device_name!r}; known: {sorted(table)}")


def _card_name(device_name: Optional[str]) -> str:
    if device_name is not None:
        return device_name
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a roofline needs the card")
    return torch.cuda.get_device_name(0)


def detect_peak_bw(device_name: Optional[str] = None) -> float:
    """HBM bytes/s of the named card (default: the current one). Raises
    when there is no card or its name is not in the table: a CPU has no
    device roofline."""
    return _lookup(PEAK_HBM_BYTES_PER_S, _card_name(device_name))


def detect_peak_fp32(device_name: Optional[str] = None) -> float:
    """float32 FLOP/s outside the tensor cores of the named card."""
    return _lookup(PEAK_FP32_FLOPS, _card_name(device_name))


def detect_peak_tensor16(device_name: Optional[str] = None) -> float:
    """Dense bfloat16 / float16 tensor-core FLOP/s of the named card."""
    return _lookup(PEAK_TENSOR16_FLOPS, _card_name(device_name))


def detect_peak_smem(device_name: Optional[str] = None) -> float:
    """Shared-memory words/s of the current (or named) card."""
    return _lookup(PEAK_SMEM_WORDS_PER_S, _card_name(device_name))


def detect_peak_tf32(device_name: Optional[str] = None) -> float:
    """Dense TF32 tensor-core FLOP/s of the named card."""
    return _lookup(PEAK_TF32_FLOPS, _card_name(device_name))


@dataclasses.dataclass(frozen=True)
class AttentionTraffic:
    """Least work of one attention forward over BH heads: q, k, v read
    once and o written once (``bytes``), and 4 d operations (two
    multiply-adds) per (query, key) pair the mask keeps (``flops``; with
    ``causal``, top-left: query i sees keys 0..i)."""

    bh: int
    tq: int
    tk: int
    d: int
    elem_bytes: int
    causal: bool

    @property
    def pairs(self) -> int:
        if not self.causal:
            return self.tq * self.tk
        full = min(self.tq, self.tk)  # queries 0..full-1 see i + 1 keys
        return full * (full + 1) // 2 + (self.tq - full) * self.tk

    @property
    def bytes(self) -> int:
        return self.elem_bytes * self.bh * self.d * 2 * (self.tq + self.tk)

    @property
    def flops(self) -> int:
        return 4 * self.bh * self.pairs * self.d

    def bound(self, peak_bw: float, peak_flops: float, peak_tf32: Optional[float] = None):
        """(least ms, the term that bounds it) at these peaks: "bytes", or
        "operations" at ``peak_flops``. Float32 work passes ``peak_tf32``:
        its operations may then also run on the tensor cores as three TF32
        products each (3xTF32 keeps float32's accuracy), term "tf32x3", and
        the faster of the two counts."""
        t_bytes = self.bytes / peak_bw * 1e3
        t_ops, by = self.flops / peak_flops * 1e3, "operations"
        if peak_tf32 is not None and 3 * self.flops / peak_tf32 * 1e3 < t_ops:
            t_ops, by = 3 * self.flops / peak_tf32 * 1e3, "tf32x3"
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, by)


@dataclasses.dataclass(frozen=True)
class SpmmTraffic:
    """Minimum HBM traffic of one Y = A @ X (bytes)."""

    nnz: int
    n_rows: int
    n_cols: int
    d: int
    bytes_val: int = 4
    bytes_idx: int = 4

    @property
    def gather_bytes(self) -> int:
        return self.nnz * self.d * self.bytes_val  # one X row per nonzero

    @property
    def structure_bytes(self) -> int:
        return self.nnz * (self.bytes_val + self.bytes_idx)  # vals + cols

    @property
    def output_bytes(self) -> int:
        return self.n_rows * self.d * self.bytes_val

    @property
    def total_bytes(self) -> int:
        return self.gather_bytes + self.structure_bytes + self.output_bytes

    @property
    def compulsory_bytes(self) -> int:
        x_once = self.n_cols * self.d * self.bytes_val
        return x_once + self.structure_bytes + self.output_bytes

    @property
    def flops(self) -> int:
        return 2 * self.nnz * self.d


def spmm_report(ms: float, traffic: SpmmTraffic, peak_bw: float) -> Dict[str, float]:
    """Rates and roofline fractions of one measured SpMM (``ms`` on the card)."""
    s = ms * 1e-3
    return {
        "ms": ms,
        "gflops": traffic.flops / s / 1e9,
        "nnz_per_s": traffic.nnz / s,
        "roofline_fraction_gather": (traffic.total_bytes / s) / peak_bw,
        "roofline_fraction_compulsory": (traffic.compulsory_bytes / s) / peak_bw,
        "bound_ms_gather": traffic.total_bytes / peak_bw * 1e3,
        "bound_ms_compulsory": traffic.compulsory_bytes / peak_bw * 1e3,
        "peak_bw_gb_s": peak_bw / 1e9,
    }


def time_cuda(fn: Callable[[], object], iters: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card, each call between two
    CUDA events on the current stream.

    The stream first spins (``torch.cuda._sleep``) long enough for the
    host to enqueue every timed call, so the events measure the device's
    time for the work and not the host's time to issue it; ``wall_ms``
    measures what a caller that launches and waits sees. The enqueue time
    is the slowest of the warm-up calls after the first: the first may
    build a kernel library or fill caches, which the timed calls do not.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda measures the card; no CUDA device")
    enqueue_s = 0.0
    for n in range(WARMUP_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if n:
            enqueue_s = max(enqueue_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    # spin for twice the host's enqueue time of all calls, at <= 2 GHz
    torch.cuda._sleep(int(2e9 * (2 * enqueue_s * iters + 0.01)))
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def wall_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Median host milliseconds of ``fn()`` followed by a synchronize: the
    latency a caller sees, host overhead included."""
    for _ in range(WARMUP_CALLS):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@dataclasses.dataclass(frozen=True)
class PanelTraffic:
    """Least HBM traffic of one panel SpMM (every segment of a PanelPlan)
    at width ``d``: each array the kernel must read, once, and the output
    once. ``from_plan`` counts it from a plan with its window provenance
    attached (sparse/panels.py); ``x_rows`` is the number of distinct X
    rows the matrix references (its distinct columns)."""

    real_slots: int     # group slots with at least one edge: 2 KB of mask each
    control_words: int  # ctrl (24 per step) + blk (G per step)
    index_words: int    # provenance + hot_ids + stage_take (+ stage_scale) + scales
    x_rows: int
    n_rows: int
    nnz: int
    d: int

    @classmethod
    def from_plan(cls, plan, d: int, x_rows: int, nnz: int) -> "PanelTraffic":
        G = plan.T // 128
        real = control = index = 0
        for seg in plan.segments:
            ctrl = _np(seg.ctrl)[:, 0, :].astype(np.int64)
            g1 = ctrl[:, 1]  # real groups + 1 (0: every slot)
            real += int(np.where(g1 == 0, G, np.maximum(g1 - 1, 0))[ctrl[:, 0] >= 0].sum())
            control += ctrl.shape[0] * (24 + G)
            win = seg.windows
            index += sum(int(_np(a).size) for a in (win.tile_steps, win.step_win,
                                                      win.range_rows, win.direct_rows))
            index += int(_np(seg.stage_take).size) * (1 if seg.stage_scale is None else 2)
        index += plan.n_hot + plan.shape[0] + plan.shape[1]  # hot_ids, row/col scales
        return cls(real, control, index, int(x_rows), plan.shape[0], int(nnz), int(d))

    @property
    def bytes(self) -> int:
        return (self.real_slots * 4 * 128 * 4 + 4 * (self.control_words + self.index_words)
                + self.x_rows * self.d * 4 + self.n_rows * self.d * 4)

    @property
    def flops(self) -> int:
        return 2 * self.nnz * self.d


def _np(a):
    """A plan array as numpy, wherever it lives."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


@dataclasses.dataclass(frozen=True)
class StagedTraffic:
    """Least HBM traffic of one fused or ranges SpMM (every segment of a
    FusedPlan or RangesPlan) at width ``d``: each array the kernel must
    read, once, and the output once. ``from_plan`` counts it from a plan
    with its window provenance attached (sparse/staged_windows.py);
    ``x_rows`` is the number of distinct X rows the matrix references."""

    real_slots: int     # group slots with at least one real lane
    slot_words: int     # words per real slot: lrow, lidx (masks) and values
    control_words: int  # ctrl (16 per step) + blk (G per step)
    index_words: int    # provenance + hot_ids + scales
    x_rows: int
    n_rows: int
    nnz: int
    d: int

    @classmethod
    def from_plan(cls, plan, d: int, x_rows: int, nnz: int) -> "StagedTraffic":
        from of_spmm_tpu_torch.sparse.staged_windows import geometry

        G = plan.T // 128
        sent = geometry(plan)[4]
        real = control = index = 0
        for seg in plan.segments:
            real += int((_np(seg.lrow) < sent).any(axis=1).sum())
            control += seg.n_steps * (16 + G)
            win = seg.windows
            index += sum(int(_np(a).size) for a in (win.step_win, win.range_rows,
                                                      win.staged_rows))
        index += plan.n_hot
        if plan.row_scale is not None:
            index += plan.shape[0] + plan.shape[1]
        words = 128 * (1 + (4 if plan.multihot else 1)
                       + (0 if plan.row_scale is not None else 2))
        return cls(real, words, control, index, int(x_rows), plan.shape[0], int(nnz), int(d))

    @property
    def bytes(self) -> int:
        return (4 * (self.real_slots * self.slot_words + self.control_words + self.index_words)
                + self.x_rows * self.d * 4 + self.n_rows * self.d * 4)

    @property
    def flops(self) -> int:
        return 2 * self.nnz * self.d


@dataclasses.dataclass(frozen=True)
class ExpansionTraffic:
    """Least HBM traffic of one SpMM through an ExpansionPlan or
    Expansion2Plan (every group) at width ``d``: each array the kernel
    reads, once (lane indices, rows and values, the step tables, the
    provenance ``stage_row`` placement derives and the scales), the X rows
    the real lanes reference, once, and Y, once. The kernel adds into a
    zeroed Y; the zeroing (``zero_bytes``) is not compulsory and is left
    out of ``bytes``. ``from_plan`` counts it from a placed plan."""

    plan_bytes: int     # the arrays the kernel reads
    x_rows: int         # distinct X rows the real lanes reference
    real_lanes: int     # lanes that add a row
    n_rows: int
    d: int

    @classmethod
    def from_plan(cls, plan, d: int) -> "ExpansionTraffic":
        from of_spmm_tpu_torch.sparse import expansion, expansion2

        v2 = isinstance(plan, expansion2.Expansion2Plan)
        nbytes = real_lanes = 0
        referenced = []
        for g in plan.groups:
            g = _np_group(g)
            arrays = (g.lidx, g.blk_of, g.stage_scale) if v2 else (g.win_lidx, g.base_blk)
            for a in arrays + (g.lrow, g.val_hi, g.val_lo, g.tile_of, g.stage_row):
                nbytes += 0 if a is None else int(a.nbytes)
            u, real = (expansion2.lane_stage_pos(g, plan.R) if v2
                       else expansion.lane_stage_pos(g, plan.CW))
            real_lanes += int(real.sum())
            referenced.append(g.stage_row[u[real]])
        if getattr(plan, "row_scale", None) is not None:
            nbytes += plan.n_rows * 4
        rows = np.unique(np.concatenate(referenced)) if referenced else np.zeros(0)
        return cls(nbytes, int(rows.shape[0]), real_lanes, plan.n_rows, int(d))

    @property
    def bytes(self) -> int:
        return self.plan_bytes + self.x_rows * self.d * 4 + self.n_rows * self.d * 4

    @property
    def zero_bytes(self) -> int:
        return self.n_rows * self.d * 4

    @property
    def flops(self) -> int:
        return 2 * self.real_lanes * self.d


def _np_group(g):
    """A plan group with its arrays as numpy, wherever they live."""
    return dataclasses.replace(g, **{f.name: _np(getattr(g, f.name))
                                     for f in dataclasses.fields(g)})


@dataclasses.dataclass(frozen=True)
class KernelWork:
    """Least work of one call of a microbenchmark kernel
    (of_spmm_tpu_torch/tools/): ``bytes`` that it must move (each input
    it needs read once, each output written once) and ``flops`` that it
    must do, on the bf16 tensor cores when ``tensor_cores`` (else float32
    on the CUDA cores), and ``smem_words``, 4-byte words it must move
    through shared memory (an on-chip gather the function is made of).
    Where the work depends on the data, the count is what these inputs need
    (the distinct rows they reference, the groups a step runs)."""

    bytes: int
    flops: int
    tensor_cores: bool = False
    smem_words: int = 0

    def bound(self, peak_bw: float, peak_fp32: float, peak_t16: float,
              peak_smem: Optional[float] = None):
        """(least ms, "bytes" or "operations") at these peaks: the largest
        of the device-memory bytes, the shared-memory words (bytes on the
        chip; needs ``peak_smem`` where there are any) and the operations."""
        peak = peak_t16 if self.tensor_cores else peak_fp32
        t_bytes, t_ops = self.bytes / peak_bw * 1e3, self.flops / peak * 1e3
        if self.smem_words:
            if peak_smem is None:
                raise ValueError("shared-memory words need the card's shared-memory rate")
            t_bytes = max(t_bytes, self.smem_words / peak_smem * 1e3)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _distinct(t: torch.Tensor) -> int:
    return int(torch.unique(t.reshape(-1)).numel())


def blockfma_work(variant: str, starts: torch.Tensor, w: torch.Tensor,
                  tier: torch.Tensor) -> KernelWork:
    """tools/microbench_blockfma.py: A reads starts, w, the tier rows of
    every 8-row block [s, s + 8) and writes out; 2 flops per (slot, row,
    column); and per (slot, row, column) one tier word out of the tier the
    TPU holds in VMEM, Hopper's shared memory (``smem_words``). B reads
    starts, vals, the tier rows c and writes out; 2 flops per (slot,
    column): one row per slot (the TPU's 7 zero rows per slot are not
    work)."""
    rows_out, d = starts.shape[0], tier.shape[1]
    K = starts.shape[1] * 8
    slots = (rows_out // 8) * K
    if variant == "A":
        rows = _distinct(starts.long()[..., None] + torch.arange(8, device=starts.device))
        flops = 2 * slots * 8 * d
    elif variant == "B":
        rows = _distinct(starts)
        flops = 2 * slots * d
    else:
        raise ValueError(f"variant must be 'A' or 'B', got {variant!r}")
    nbytes = starts.nbytes + w.nbytes + rows * d * 4 + rows_out * d * 4
    return KernelWork(nbytes, flops, smem_words=slots * 8 * d if variant == "A" else 0)


def mxu_work(variant: str, blk: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
             rows_out: int) -> KernelWork:
    """tools/microbench_mxu.py, in its product form out = Cnt @ win[:, :128]
    + Cnt @ win[:, 128:] (Cnt[r, w]: the lanes that send window row w to
    tile row r). Bytes: the window rows the variant's lanes read (512 bytes
    each; whole blocks for winread / winstat), the index arrays it reads
    (blk for the dynamic variants, lidx for the gathers, lrow for chain2;
    noop reads row 0 of each step's lidx) and the tile. Operations: one
    bf16 product on the tensor cores over those window rows, 2 x rows_out x
    rows x 256 flops (noop: one add a lane of row 0). The lane form, 2
    adds per (lane, column) on the CUDA cores (2 S G 128 x 128 flops:
    0.0078 ms at the defaults), is how the TPU's steps add, not work the
    function needs."""
    S, _, G = blk.shape
    L, d = 128, 128
    out_bytes = rows_out * d * 4
    if variant == "noop":
        return KernelWork(S * L * 4 + out_bytes, S * L)
    dyn = variant in ("winread", "rawdyn", "chain2")
    b = blk.view(S, G).long() if dyn else torch.arange(G, device=blk.device).expand(S, G)
    if variant in ("winread", "winstat"):
        rows = _distinct(b) * L
    else:
        rows = _distinct(b[..., None] * L + lidx.view(S, G, L).long())
    nbytes = rows * 2 * d * 2 + out_bytes + (blk.nbytes if dyn else 0)
    nbytes += 0 if variant in ("winread", "winstat") else lidx.nbytes
    nbytes += lrow.nbytes if variant == "chain2" else 0
    return KernelWork(nbytes, 2 * rows_out * rows * 2 * d, tensor_cores=True)


def cond_work(groups_run: int, steps: int, steps_run: int) -> KernelWork:
    """tools/microbench_cond.py: the 4 x 128 mask words of each group run,
    the window once, gcnt, and every step's 128 x 128 float32 tile
    written; per step that runs a group, one bf16 product on the tensor
    cores, the count matrix (sum of the groups' bits)^T @ win, 2 x 128 x
    128 x 256 flops. The TPU's product per group is its form, not work the
    function needs: the window is the same for every group."""
    L = 128
    nbytes = groups_run * 4 * L * 4 + L * 2 * L * 2 + steps * 4 + steps * L * L * 4
    return KernelWork(nbytes, steps_run * 2 * L * L * 2 * L, tensor_cores=True)


def proto_fused_rows(mode: str, scols: torch.Tensor, lidx: torch.Tensor, blk: torch.Tensor,
                     S: int, SPT: int, TILES: int) -> int:
    """tools/proto_fused.py: the distinct rows a mode reads, once each: the
    X rows the lanes reference through both index levels (fused), the
    staged rows they reference (compute), the X rows the staging steps'
    scols name (dma)."""
    from of_spmm_tpu_torch.ops.cuda.proto_fused import lane_sources

    if mode == "dma":
        return _distinct(scols.reshape(-1, S // SPT)[:TILES * SPT])
    _, src = lane_sources(scols, lidx, blk, S, SPT, TILES, 0, TILES * SPT, mode == "compute")
    return _distinct(src)


def proto_fused_work(mode: str, scols: torch.Tensor, lidx: torch.Tensor, lrow: torch.Tensor,
                     blk: torch.Tensor, R: int, S: int, SPT: int, TILES: int) -> KernelWork:
    """tools/proto_fused.py: fused reads the X rows its lanes reference
    (through both index levels), the staging steps' scols, the compute
    steps' lidx, lrow and blk, and writes the output; compute reads the
    staged rows its lanes reference instead of X rows and scols; dma reads
    the staging steps' scols and the X rows they name, and writes the
    staging buffer (TILES, S, 128) and the zero output
    (proto_fused_rows counts the rows). 2 flops per (lane, column): the
    hi + lo add and the accumulation."""
    L = 128
    G, DELTA = blk.shape[-1], S // SPT
    out_bytes = TILES * R * L * 4
    stage_idx = TILES * SPT * DELTA * 4
    rows = proto_fused_rows(mode, scols, lidx, blk, S, SPT, TILES)
    if mode == "dma":
        return KernelWork(stage_idx + rows * L * 4 + TILES * S * L * 4 + out_bytes, 0)
    lanes = TILES * SPT * G * L
    nbytes = rows * L * 4 + 2 * lanes * 4 + TILES * SPT * G * 4 + out_bytes
    nbytes += stage_idx if mode == "fused" else 0
    return KernelWork(nbytes, 2 * lanes * L)


def row_gather_work(cols: torch.Tensor, table: torch.Tensor) -> KernelWork:
    """tools/microbench_gather.py bench_vmem_take: the distinct table rows
    cols names, cols, and one output row per index; no operations."""
    row = table.shape[1] * table.element_size()
    return KernelWork(_distinct(cols) * row + cols.nbytes + cols.numel() * 4 * table.shape[1], 0)


def ell_work(cols: torch.Tensor, K: int, table: torch.Tensor,
             vals: Optional[torch.Tensor] = None, resident: bool = False) -> KernelWork:
    """An ELL gather-reduce, out[o] = sum over k < K of (vals[o, k] *)
    table[flat cols[K o + k]]: bench_vmem_loop and bench_take_fused
    (weighted), bench_row_dma and bench_dma_deep (unweighted). The
    distinct rows cols names, cols, vals and the output; per index and
    column 2 flops weighted (the multiply-add), 1 unweighted (the add).
    ``resident``: the table is one the TPU holds in VMEM (vmem_loop,
    take_fused), so each index's row is also read out of Hopper's shared
    memory, cols.numel() x 128 words (``smem_words``); row_dma's and
    dma_deep's table lies in device memory."""
    d = table.shape[1]
    n_out = cols.numel() // K
    nbytes = _distinct(cols) * d * table.element_size() + cols.nbytes + n_out * d * 4
    nbytes += 0 if vals is None else vals.nbytes
    return KernelWork(nbytes, (1 if vals is None else 2) * cols.numel() * d,
                      smem_words=cols.numel() * d if resident else 0)


def _window_rows(idx: torch.Tensor, window: int, bases: Optional[torch.Tensor],
                 tile: int) -> int:
    """Distinct table rows a one-hot gather reads: base + index for each
    index in [0, window) (an index outside it selects no row)."""
    flat = idx.reshape(-1).long()
    keep = (flat >= 0) & (flat < window)
    if bases is not None:
        flat = flat + bases.reshape(-1).long().repeat_interleave(tile)
    return _distinct(flat[keep])


def onehot_work(cols: torch.Tensor, tables: Sequence[torch.Tensor], window: int,
                bases: Optional[torch.Tensor] = None) -> KernelWork:
    """A one-hot product gather, out[t] = sum over tables of
    f32(table[base + cols[t]]), or a zero row where cols[t] lies outside
    the ``window`` rows: bench_onehot_mxu (one table, the window its C
    rows), bench_onehot_pair (hi and lo), bench_window_pair (hi and lo,
    ``window`` CW rows at a base per step of T / len(bases) lanes). The
    function is a row gather. Bytes: the distinct rows the indices select
    in every table, cols, bases and the float32 output. Operations: the
    float32 add of the tables' rows, 1 flop per lane and column for each
    table past the first. The one-hot multiply-adds the TPU kernel
    prescribes are not work the function needs: onehot_macs counts them."""
    T, d = cols.numel(), tables[0].shape[1]
    tile = T // bases.numel() if bases is not None else T
    rows = _window_rows(cols, window, bases, tile)
    nbytes = rows * sum(d * t.element_size() for t in tables) + cols.nbytes + T * d * 4
    nbytes += 0 if bases is None else bases.nbytes
    return KernelWork(nbytes, (len(tables) - 1) * T * d)


def onehot_macs(cols: torch.Tensor, n_tables: int, window: int) -> int:
    """The multiply-adds of a TPU one-hot product gather: window x 128 per
    lane and table (the (T, window) one-hot times each (window, 128)
    table). What tools/microbench_gather.py's onehot rows price on the
    TPU's matrix unit; reported beside a bound, never in it."""
    return cols.numel() * window * 128 * n_tables


def block_slice_work(starts: torch.Tensor, tier: torch.Tensor) -> KernelWork:
    """bench_block_slice: the distinct tier rows of every 8-row block
    [s, s + 8), starts and the output (8 rows per step of 8 x K starts);
    one add per (start, block row, column). The function's own count: the
    TPU's reads of each start's 8 rows x 128 words out of VMEM (0.016 ms as
    Hopper shared-memory words at the tool's defaults) are how that kernel
    works, not work the function needs, and the count-matrix kernel makes
    none of them."""
    d = tier.shape[1]
    rows = _distinct(starts.long()[..., None] + torch.arange(8, device=starts.device))
    return KernelWork(rows * d * 4 + starts.nbytes + starts.shape[0] * d * 4,
                      starts.numel() * 8 * d)


def twosided_work(bases: torch.Tensor, lidx: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, CW: int,
                  R: int) -> KernelWork:
    """tools/microbench_gather2.py bench_twosided: the window pair gather's
    bytes as onehot_work counts them, but the (R, 128) float32 output in
    place of the gathered rows, plus rows and vals read; 2 flops per lane
    and column on the CUDA cores (the value's scale and the add into the
    output; the gather's hi + lo add and the split are not counted). The
    TPU's one-hot products (the window gather and the scatter over R
    rows) are how the TPU gathers and adds, not work the function needs."""
    g = onehot_work(lidx, (hi, lo), CW, bases)
    d = hi.shape[1]
    nbytes = g.bytes - lidx.numel() * d * 4 + rows.nbytes + vals.nbytes + R * d * 4
    return KernelWork(nbytes, 2 * lidx.numel() * d)


def take_along_work(idx: torch.Tensor, table: torch.Tensor, steps: int = 1) -> KernelWork:
    """tools/microbench_dyngather.py _run: ``steps`` passes of
    out[t, l] = table[idx[t, l], l]. Bytes from device memory: one pass's,
    the distinct table elements it reads, idx and the output (inputs read
    once, the output written once). The passes themselves are the work the
    TPU tool measures (its rate counts every pass's gather out of VMEM):
    steps x Tn x 128 words gathered out of shared memory, Hopper's VMEM."""
    d = table.shape[1]
    elems = _distinct(idx.long() * d + torch.arange(d, device=idx.device))
    return KernelWork(elems * 4 + idx.nbytes + idx.numel() * 4, 0, smem_words=steps * idx.numel())


def smem_cap_work(x: torch.Tensor) -> KernelWork:
    """tools/microbench_dyngather.py vmem_cap: x read and written once."""
    return KernelWork(2 * x.nbytes, 0)
