#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (of_spmm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with the card

Builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, then runs the main path:
GCN inference at the width of OGB's published GCN baseline for arxiv
(3 layers, hidden 256) on synthetic ogbn-arxiv, through
load_graph -> normalized_adjacency -> make_operator -> GCN.forward. A
last phase times one SpMM on products-small.

Each phase prints one JSON line. Before the last line come the
``{"kernels": [...]}`` summary and the card's name and power limit as
nvidia-smi reports them; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.data import load_graph, random_features
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator, spmm_internal
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
from of_spmm_tpu_torch.sparse.tiled import TieredEll
from of_spmm_tpu_torch.utils.roofline import (
    SpmmTraffic, detect_peak_bw, detect_peak_fp32, spmm_report, time_cuda, wall_ms)

KERNEL_SOURCE = "of_spmm_tpu_torch/csrc/spmm.cu"
REPLACES = {
    "bucket_spmm": "of_spmm_tpu/ops/pallas/spmm.py:46",
    "gather_rows": "of_spmm_tpu/ops/pallas/spmm.py:146",
}
BUCKET_WIDTHS = (3, 5, 9, 17, 33, 64, 153, 256)
FEATURE_WIDTHS = (128, 256, 60)
GCN_DIMS = (128, 256, 256, 40)  # OGB's GCN baseline for ogbn-arxiv: 3 layers, hidden 256
MAIN_PATH_REL_TOL = 1e-4

# A bucket column one past the end of x: the kernel must stop with a
# device-side assertion. Run in a child process, because the assertion
# leaves that process's CUDA context unusable.
BAD_COLUMN_PROBE = """
import torch
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
x = torch.zeros((16, 8), device="cuda")
cols = torch.zeros((4, 3), dtype=torch.int32, device="cuda")
cols[2, 1] = 16
kernels.bucket_spmm(cols, torch.ones((4, 3), device="cuda"), x)
torch.cuda.synchronize()
print("no error")
"""


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|: the normwise relative error of a against b."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """|k - p| <= 1e-5 + 1e-4 |p| elementwise; returns max |k - p|."""
    err = (got - want).abs()
    bad = err > 1e-5 + 1e-4 * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of tolerance, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_bucket(R, K, n_x, gen, device):
    """A padded-ELL bucket like the planner's: each row a random length,
    trailing slots col 0 / val 0, values positive with row sums <= 1 as
    in a normalized adjacency."""
    cols = torch.randint(0, n_x, (R, K), generator=gen, dtype=torch.int32)
    vals = torch.rand((R, K), generator=gen) / K
    lens = torch.randint(1, K + 1, (R, 1), generator=gen)
    pad = torch.arange(K)[None, :] >= lens
    cols[pad], vals[pad] = 0, 0.0
    return cols.to(device), vals.to(device)


def _bound(nbytes: int, nops: int, peak_bw: float, peak_fp32: float):
    """Least time for the work (ms) and what sets it: bytes over HBM
    bandwidth or float32 operations over the non-tensor-core peak."""
    t_bytes, t_ops = nbytes / peak_bw * 1e3, nops / peak_fp32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_figures(plan, n_cols: int, d: int, gen, peak_bw: float, peak_fp32: float) -> dict:
    """Each kernel over all its launches in one SpMM of a tiered plan at
    width d: its time, its plain version's, the one PyTorch call that
    computes the same function, and the bound of that work.

    The bucket phase's function is X -> the concatenation of every
    bucket's partial rows; its library call is torch.sparse.mm with one
    CSR holding every bucket's entries (tier offsets applied). The
    gather phase's is the finish's row gathers from that concatenation;
    its library call is torch.index_select (indices clamped into range:
    index_select has no zero-fill).
    """
    dev = torch.device("cuda", 0)
    x = torch.randn((n_cols, d), generator=gen).to(dev)
    buckets = [(0 if t.tier < 0 else t.tier * plan.tier_size, b)
               for t in plan.tiers for b in t.buckets]
    cat = torch.empty((plan.n_ell_rows, d), device=dev)

    def run_buckets(fn):
        r0 = 0
        for o, b in buckets:
            fn(b.cols, b.vals, x, o, out=cat[r0:r0 + b.n_ell_rows])
            r0 += b.n_ell_rows

    with torch.inference_mode():
        bucket_ms = time_cuda(lambda: run_buckets(kernels.bucket_spmm), iters=20)
        bucket_plain_ms = time_cuda(lambda: run_buckets(kernels.bucket_spmm_torch), iters=5)
        rows_l, cols_l, vals_l = [], [], []
        r0 = 0
        for o, b in buckets:
            r, k = (b.vals != 0).nonzero(as_tuple=True)
            rows_l.append(r + r0)
            cols_l.append(b.cols[r, k].long() + o)
            vals_l.append(b.vals[r, k])
            r0 += b.n_ell_rows
        cols_all = torch.cat(cols_l)
        ell_csr = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows_l), cols_all]), torch.cat(vals_l),
            (plan.n_ell_rows, n_cols), check_invariants=False).coalesce().to_sparse_csr()
        run_buckets(kernels.bucket_spmm)
        bucket_lib_err = rel_err(torch.sparse.mm(ell_csr, x), cat)
        bucket_lib_ms = time_cuda(lambda: torch.sparse.mm(ell_csr, x), iters=20)
        bucket_bytes = (sum(b.n_ell_rows * b.width * 8 for _, b in buckets)  # cols + vals
                        + int(torch.unique(cols_all).numel()) * d * 4  # X rows read once
                        + plan.n_ell_rows * d * 4)  # partial rows written once
        bucket_ops = 2 * int(cols_all.numel()) * d

        run_buckets(kernels.bucket_spmm)
        fin = plan.finish
        gidx = [fin.pos] + ([fin.extra_idx] if fin.extra_idx.shape[0] else [])
        gather_ms = time_cuda(lambda: [kernels.gather_rows(cat, i) for i in gidx], iters=20)
        gather_plain_ms = time_cuda(lambda: [kernels.gather_rows_torch(cat, i) for i in gidx],
                                    iters=20)
        clamped = [i.clamp(0, plan.n_ell_rows - 1) for i in gidx]
        gather_lib_ms = time_cuda(lambda: [torch.index_select(cat, 0, i) for i in clamped],
                                  iters=20)
        m_rows = sum(int(i.numel()) for i in gidx)
        in_range = torch.cat([i[(i >= 0) & (i < plan.n_ell_rows)] for i in gidx])
        gather_bytes = (m_rows * 4 + int(torch.unique(in_range).numel()) * d * 4
                        + m_rows * d * 4)
    b_bound, b_by = _bound(bucket_bytes, bucket_ops, peak_bw, peak_fp32)
    g_bound, g_by = _bound(gather_bytes, 0, peak_bw, peak_fp32)
    return {
        "d": d, "scope": "all launches of one SpMM",
        "bucket_spmm": {"launches": len(buckets), "ms": bucket_ms, "plain_ms": bucket_plain_ms,
                        "library": "torch.sparse.mm", "library_ms": bucket_lib_ms,
                        "library_rel_err": bucket_lib_err, "bytes": bucket_bytes,
                        "flops": bucket_ops, "bound_ms": b_bound, "bound_by": b_by},
        "gather_rows": {"launches": len(gidx), "ms": gather_ms, "plain_ms": gather_plain_ms,
                        "library": "torch.index_select", "library_ms": gather_lib_ms,
                        "bytes": gather_bytes, "bound_ms": g_bound, "bound_by": g_by},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    if cap != (9, 0):
        raise RuntimeError(f"{name} has compute capability {cap}; the kernels are built for sm_90a")
    peak_bw, peak_fp32 = detect_peak_bw(name), detect_peak_fp32(name)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         peak_hbm_gb_s=peak_bw / 1e9, peak_fp32_tflops=peak_fp32 / 1e12)

    # -- 2. build (the host planner's g++ build runs beside nvcc) -------------
    t0 = time.perf_counter()
    planner = threading.Thread(target=native.available)
    planner.start()
    built = kernels.build()
    kernels._lib()
    planner.join()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", nvcc_seconds=round(built["seconds"], 2),
         total_seconds=round(time.perf_counter() - t0, 2), library=built["path"],
         native_planner=native.available(), ptxas=ptxas)

    max_err = {"bucket_spmm": 0.0, "gather_rows": 0.0}

    # -- 3. kernels against their plain versions -------------------------------
    gen = torch.Generator().manual_seed(0)
    n_x, off, R = 60_000, 1_000, 4_093  # R not a multiple of 8: a ragged last block
    for d in FEATURE_WIDTHS:
        x = torch.randn((n_x, d), generator=gen).to(dev)
        for K in BUCKET_WIDTHS:
            cols, vals = random_bucket(R, K, n_x - off, gen, dev)
            buf = torch.full((R + 16, d), float("nan"), device=dev)
            got = kernels.bucket_spmm(cols, vals, x, off, out=buf[8:8 + R])
            want = kernels.bucket_spmm_torch(cols, vals, x, off)
            torch.cuda.synchronize()
            e = check_close(got, want, f"bucket_spmm K={K} d={d}")
            if not (torch.isnan(buf[:8]).all() and torch.isnan(buf[8 + R:]).all()):
                raise AssertionError(f"bucket_spmm K={K} d={d} wrote outside its rows")
            max_err["bucket_spmm"] = max(max_err["bucket_spmm"], e)
        table = torch.randn((100_000, d), generator=gen).to(dev)
        idx = torch.randint(0, 100_000, (50_000,), generator=gen, dtype=torch.int32)
        sentinels = torch.tensor([100_000, -1, 1 << 30, 100_001], dtype=torch.int32)
        idx = torch.cat([idx, sentinels]).to(dev)
        got = kernels.gather_rows(table, idx)
        want = kernels.gather_rows_torch(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or got[-4:].any():
            raise AssertionError(f"gather_rows d={d}: not bit-exact or sentinel rows not zero")
    probe = subprocess.run([sys.executable, "-c", BAD_COLUMN_PROBE], capture_output=True,
                           text=True, timeout=120,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    if probe.returncode == 0 or "device-side assert" not in probe.stdout + probe.stderr:
        raise AssertionError("bucket_spmm with a column outside x did not stop with a "
                             f"device-side assertion (rc {probe.returncode}):\n"
                             f"{probe.stdout[-2000:]}{probe.stderr[-2000:]}")
    emit("kernels", bucket_spmm={"widths": BUCKET_WIDTHS, "d": FEATURE_WIDTHS,
                                 "row_offset": off, "rows": R,
                                 "max_abs_err": max_err["bucket_spmm"],
                                 "tolerance": "|k-p| <= 1e-5 + 1e-4|p|"},
         gather_rows={"d": FEATURE_WIDTHS, "rows": 50_004, "sentinels": 4,
                      "bit_exact": True},
         bad_column="bucket_spmm stopped with a device-side assertion")

    # -- 4. main path: GCN inference on synthetic ogbn-arxiv --------------------
    t0 = time.perf_counter()
    csr, cfg = load_graph("ogbn-arxiv", symmetrize=True)
    a_hat = normalized_adjacency(csr)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = make_operator(a_hat)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    plan = op.binned
    if not isinstance(plan, TieredEll) or not op.transpose_aliased:
        raise AssertionError("ogbn-arxiv should plan as an aliased tiered operator")
    x_np, _ = random_features(cfg)
    x = torch.from_numpy(x_np).to(dev)
    model = GCN(GCN_DIMS, generator=torch.Generator().manual_seed(0))

    n_buckets = sum(len(t.buckets) for t in plan.tiers)
    n_extra = int(plan.finish.extra_rids.shape[0])
    with torch.inference_mode():
        kernels.reset_launch_counts()
        logits = model(op, x)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        expected = {"bucket_spmm": 3 * n_buckets, "gather_rows": 3 * (1 + (n_extra > 0))}
        if launches != expected:
            raise AssertionError(f"main path launches {launches}, expected {expected}")
        want = model(op, x, impl="torch")
        torch.cuda.synchronize()
    if logits.shape != (cfg.n_nodes, GCN_DIMS[-1]) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or wrong shape")
    gcn_err = rel_err(logits, want)
    if gcn_err > MAIN_PATH_REL_TOL:
        raise AssertionError(f"GCN logits vs impl=torch: rel err {gcn_err}")

    # every kernel at the shapes the main path gives it, against its plain version
    with torch.inference_mode():
        for d in sorted(set(GCN_DIMS[:-1])):
            xd = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            parts = []
            for t in plan.tiers:
                o = 0 if t.tier < 0 else t.tier * plan.tier_size
                for b in t.buckets:
                    got = kernels.bucket_spmm(b.cols, b.vals, xd, o)
                    e = check_close(got, kernels.bucket_spmm_torch(b.cols, b.vals, xd, o),
                                    f"arxiv bucket K={b.width} tier={t.tier} d={d}")
                    max_err["bucket_spmm"] = max(max_err["bucket_spmm"], e)
                    parts.append(got)
            cat = torch.cat(parts)
            for idx in (plan.finish.pos, plan.finish.extra_idx):
                if not torch.equal(kernels.gather_rows(cat, idx),
                                   kernels.gather_rows_torch(cat, idx)):
                    raise AssertionError(f"arxiv finish gather d={d} not bit-exact")
        torch.cuda.synchronize()

    # times: forward, each layer's SpMM, and each kernel over one SpMM at d=128
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: model(op, x), iters=20)
        fwd_wall_ms = wall_ms(lambda: model(op, x), iters=20)
        fwd_plain_ms = time_cuda(lambda: model(op, x, impl="torch"), iters=5)
        spmm_rows = []
        for layer, d in enumerate(GCN_DIMS[:-1]):
            h = torch.randn((cfg.n_nodes, d), generator=gen).to(dev)
            ms = time_cuda(lambda: spmm_internal(op, h), iters=20)
            rep = spmm_report(ms, SpmmTraffic(a_hat.nnz, cfg.n_nodes, cfg.n_nodes, d),
                              peak_bw)
            spmm_rows.append({"layer": layer, "d": d, **{k: round(v, 4) for k, v in rep.items()}})
    emit("main_path", graph="ogbn-arxiv (synthetic, symmetrized, self-loops)",
         n_nodes=cfg.n_nodes, nnz=a_hat.nnz, dims=GCN_DIMS, layout="tiered",
         buckets=n_buckets,
         cold_buckets=sum(len(t.buckets) for t in plan.tiers if t.tier < 0),
         ell_rows=plan.n_ell_rows, finish_extras=n_extra,
         graph_seconds=round(t_graph, 2), plan_seconds=round(t_plan, 2),
         launches_per_forward=launches,
         logits_rel_err_vs_torch=gcn_err, forward_ms=round(fwd_ms, 4),
         forward_wall_ms=round(fwd_wall_ms, 4), forward_plain_ms=round(fwd_plain_ms, 4),
         spmm=spmm_rows)

    # the small-input reference: cora (binned, relabeled) against a dense
    # float64 forward on the host
    ccsr, ccfg = load_graph("cora", symmetrize=True)
    ca = normalized_adjacency(ccsr)
    cop = make_operator(ca)
    cx_np, _ = random_features(ccfg)
    cmodel = GCN((ccfg.feature_dim, 64, ccfg.n_classes),
                 generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        kernels.reset_launch_counts()
        clog = cmodel(cop, torch.from_numpy(cx_np).to(dev)).cpu().double()
        cora_launches = dict(kernels.LAUNCHES)
    dense = ca.to_dense().astype(np.float64)
    h = cx_np.astype(np.float64)
    for i, layer in enumerate(cmodel.layers):
        w, bias = (p.detach().cpu().double().numpy() for p in (layer.w, layer.b))
        h = dense @ h @ w + bias
        if i < len(cmodel.layers) - 1:
            h = np.maximum(h, 0.0)
    cora_err = rel_err(clog, torch.from_numpy(h))
    if cora_err > MAIN_PATH_REL_TOL or cora_launches["bucket_spmm"] == 0:
        raise AssertionError(f"cora GCN vs dense float64: rel err {cora_err}, {cora_launches}")
    emit("reference", graph="cora", layout="binned (relabeled)", dims=cmodel.feature_dims,
         rel_err_vs_dense_float64=cora_err, launches=cora_launches)

    a_fig = kernel_figures(plan, cfg.n_nodes, 128, gen, peak_bw, peak_fp32)
    emit("kernel_times", graph="ogbn-arxiv", **a_fig)

    # -- 5. scale: one SpMM on products-small ---------------------------------
    t0 = time.perf_counter()
    pcsr, pcfg = load_graph("products-small", symmetrize=True)
    pa = normalized_adjacency(pcsr)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    pop = make_operator(pa)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    if not isinstance(pop.binned, TieredEll):
        raise AssertionError("products-small should plan as tiered")
    px = torch.randn((pcfg.n_nodes, 128), generator=gen).to(dev)
    with torch.inference_mode():
        py = spmm_internal(pop, px)
        py_plain = spmm_internal(pop, px, impl="torch")
        torch.cuda.synchronize()
        p_err = rel_err(py, py_plain)
        if p_err > MAIN_PATH_REL_TOL or not torch.isfinite(py).all():
            raise AssertionError(f"products-small SpMM vs impl=torch: rel err {p_err}")
        p_ms = time_cuda(lambda: spmm_internal(pop, px), iters=20)
        p_plain_ms = time_cuda(lambda: spmm_internal(pop, px, impl="torch"), iters=3)
    pcoo = pa.to_coo()
    p_sparse = torch.sparse_csr_tensor(torch.from_numpy(pa.indptr.astype(np.int64)),
                                       torch.from_numpy(pa.cols.astype(np.int64)),
                                       torch.from_numpy(pa.vals), pa.shape,
                                       check_invariants=False).to(dev)
    p_lib_err = rel_err(torch.sparse.mm(p_sparse, px), py_plain)
    p_lib_ms = time_cuda(lambda: torch.sparse.mm(p_sparse, px), iters=20)
    rep = spmm_report(p_ms, SpmmTraffic(pcoo.nnz, pcfg.n_nodes, pcfg.n_nodes, 128), peak_bw)
    emit("scale", graph="products-small (synthetic, symmetrized, self-loops)",
         n_nodes=pcfg.n_nodes, nnz=pa.nnz, d=128, layout="tiered",
         buckets=sum(len(t.buckets) for t in pop.binned.tiers),
         graph_seconds=round(t_graph, 2), plan_seconds=round(t_plan, 2),
         rel_err_vs_torch=p_err, spmm_ms=p_ms, plain_ms=p_plain_ms,
         torch_sparse_mm_ms=p_lib_ms, torch_sparse_mm_rel_err=p_lib_err,
         **{k: round(v, 4) for k, v in rep.items() if k != "ms"})
    emit("kernel_times", graph="products-small",
         **kernel_figures(pop.binned, pcfg.n_nodes, 128, gen, peak_bw, peak_fp32))

    # -- 6. the kernels, 7. the card, 8. the result --------------------------
    # launches: one GCN forward (three SpMMs); the times and the bound: all
    # launches of one SpMM at d=128, launches_per_spmm of them
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "launches_scope": "one GCN forward on ogbn-arxiv",
         "max_abs_err": max_err[k],
         **{f: a_fig[k][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "launches_per_spmm": a_fig[k]["launches"],
         "times_scope": f"one SpMM on ogbn-arxiv at d={a_fig['d']}"}
        for k in ("bucket_spmm", "gather_rows")]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
