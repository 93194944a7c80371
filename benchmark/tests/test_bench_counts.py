"""The yardstick's counters against hand counts on a 3-node path graph,
and the per-layer readers' arithmetic on a made-up trace."""

import numpy as np
import pytest

from benchmark import counts, readers
from benchmark.harness import RunRecord
from benchmark.reference import gcn, sage
from benchmark.trace import DeviceOp, HostOp, TraceSummary

# the path 0 - 1 - 2, both directions
INDPTR = np.array([0, 1, 3, 4])
COLS = np.array([1, 0, 2, 1], np.int32)
DIMS = (2, 3, 1)
H100 = "NVIDIA H100 80GB HBM3"


def test_operator_nonzeros():
    assert gcn.operator_nnz(INDPTR, COLS) == 7  # 4 edges and 3 self-loops
    assert sage.operator_nnz(INDPTR, COLS) == 4


def test_gcn_flops_by_hand():
    # forward: SpMM d 2 (2*7*2), 2x3 product (2*3*2*3), SpMM d 3 (2*7*3), 3x1 (2*3*3*1)
    fwd = 28 + 36 + 42 + 18
    assert gcn.flops(3, 7, DIMS, train=False) == fwd
    # backward: dW1 36, dW2 18, the second layer's input gradient 18, its SpMM on A^T 42
    assert gcn.flops(3, 7, DIMS, train=True) == fwd + 36 + 18 + 18 + 42
    assert gcn.spmm_widths(DIMS, False) == [2, 3]
    assert gcn.spmm_widths(DIMS, True) == [2, 3, 3]


def test_sage_flops_by_hand():
    # forward: SpMM d 2 (16), two 2x3 products (72), SpMM d 3 (24), two 3x1 (36)
    fwd = 16 + 72 + 24 + 36
    assert sage.flops(3, 4, DIMS, train=False) == fwd
    # backward: both weight grads of each layer (72 + 36), the second layer's two
    # input gradients (36) and its SpMM on A^T (24)
    assert sage.flops(3, 4, DIMS, train=True) == fwd + 72 + 36 + 36 + 24


def test_spmm_traffic_by_hand():
    t = counts.SpmmTraffic(nnz=7, n_rows=3, n_cols=3, d=2)
    # X once (3*2*4), values and columns (7*8), Y once (3*2*4)
    assert t.compulsory_bytes == 24 + 56 + 24
    assert t.flops == 28


def test_peaks_by_card_name():
    assert counts.peak_fp32_flops(H100) == 67e12
    assert counts.peak_hbm_bytes_per_s(H100) == 3.35e12
    assert counts.peak_fp32_flops("cpu") is None


def _trace():
    spmm = HostOp("ofs::bucket_spmm", 100, 150, thread=1)
    finish = HostOp("aten::index_add_", 151, 154, thread=1)
    mm = HostOp("aten::mm", 160, 170, thread=2)
    ops = [DeviceOp("bucket_spmm_kernel", 200, 400, spmm),
           DeviceOp("indexFuncLargeIndex", 400, 450, finish),
           DeviceOp("gemm", 350, 600, mm),  # overlaps the first two
           DeviceOp("copy", 800, 900, None)]
    return TraceSummary(window=(0, 1000), device_ops=ops,
                        host_ops=[HostOp("bench.window", 0, 1000, 1),
                                  HostOp("_SpmmFunction", 90, 155, 1),
                                  HostOp("bench.backward", 155, 180, 1),
                                  HostOp("aten::item", 600, 800, 1), spmm, finish, mm],
                        spans={"bench.window": [(0, 1000)], "bench.backward": [(155, 180)]},
                        main_thread=1)


def _run(trace, loop="train"):
    return RunRecord(cell="x", loop=loop, setup_s=1.0, plan_s=0.5, wall_s=1e-6,
                     units=2, latencies_s=[], flops_per_unit=1000, spmm_bytes_per_unit=4000,
                     device_name=H100, trace=trace)


def test_trace_union_and_gaps():
    s = _trace()
    assert s.busy_intervals() == [(200, 600), (800, 900)]
    assert s.busy_s() == pytest.approx(500e-9)
    gaps = dict(s.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(200e-9)  # 600-800
    assert sum(gaps.values()) == pytest.approx(500e-9)
    assert s.device_seconds(s.launched_in("bench.backward")) == pytest.approx(250e-9)


def test_readers_arithmetic():
    run = _run(_trace())
    assert readers.device_idle(run, "train") == pytest.approx(50.0)
    # 2 steps x 1000 FLOP over 67 TFLOP/s for a 1 us window
    assert readers.mfu(run, "train") == pytest.approx(100 * 2000 / (67e12 * 1e-6))
    # 2 x 4000 bytes over 3.35 TB/s, over the 250 ns of the ops launched
    # inside the SpMM's span: the ofs kernel and the finish's index_add_
    assert readers.spmm_roofline(run, "train") == pytest.approx(100 * 8000 / 3.35e12 / 250e-9)
    assert readers.mfu(run, "serve") is None
    assert readers.mfu(_run(None), "train") is None
    cpu = _run(_trace())
    cpu.device_name = "cpu"
    assert readers.spmm_roofline(cpu, "train") is None
