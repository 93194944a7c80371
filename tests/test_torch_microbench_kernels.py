"""The microbenchmark kernels' wrappers (ops/cuda/{microbench_blockfma,
microbench_mxu,microbench_cond,proto_fused}.py), their tools'
command lines (of_spmm_tpu_torch/tools/) and their work counts
(utils/roofline.py), without JAX, so that the file also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_microbench_kernels.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU the wrappers' checks, their dispatch to the plain
versions, the proto_fused modes (against a float64 sum of the lanes at
the redesign's edges: R = 1000 and mostly empty rows), the tools'
command lines and the counts run; the ``cuda``-marked tests skip. On the
card the same edges run on NaN-poisoned output memory.
"""

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda import microbench_blockfma as kblockfma
from of_spmm_tpu_torch.ops.cuda import microbench_cond as kcond
from of_spmm_tpu_torch.ops.cuda import microbench_mxu as kmxu
from of_spmm_tpu_torch.ops.cuda import proto_fused as kproto
from of_spmm_tpu_torch.tools import microbench_blockfma as tblockfma
from of_spmm_tpu_torch.tools import microbench_cond as tcond
from of_spmm_tpu_torch.tools import microbench_mxu as tmxu
from of_spmm_tpu_torch.tools import proto_fused as tproto
from of_spmm_tpu_torch.utils.roofline import (
    blockfma_work, cond_work, mxu_work, proto_fused_work)

PROTO_SMALL = dict(N=4096, R=128, T=256, S=1600, TILES=2, SPT=25)
# the redesign's edges: an R that no power-of-two slice divides, with a
# few empty rows (3,200 lanes a tile), and mostly empty rows
PROTO_EDGES = {"R1000": dict(R=1000, T=128, TILES=3), "R8192": dict(R=8192, T=128, TILES=2)}
# on the card also the sort's fallbacks: a tile's lanes past a block's
# shared memory (102,400 at T = 4096), and a tile's scols past what is left
# of it (64,000 at S = 64,000)
PROTO_CARD_EDGES = {"T4096": dict(R=1000, T=4096, TILES=1), "S64000": dict(S=64000, TILES=1)}
# the kernels against their plain versions: elementwise where every term
# is positive (blockfma, proto_fused); normwise where long sums of both
# signs are taken in another order (mxu, cond)
ELEMENTWISE = (1e-4, 1e-5)
NORMWISE = 1e-4


def _proto_args(**size):
    size = {**PROTO_SMALL, **size}
    args = tproto.inputs(size["N"], size["R"], size["T"], size["S"], size["TILES"], size["SPT"])
    return args, {k: size[k] for k in ("R", "S", "SPT", "TILES")}


@pytest.mark.parametrize("bad", ["starts_dtype", "w_shape", "tier_width", "noncontig"])
def test_blockfma_rejects_what_the_kernel_does_not_take(bad):
    starts, w, tier = (torch.from_numpy(a) for a in tblockfma.inputs("A", 64, 256, 32))
    if bad == "starts_dtype":
        starts = starts.long()
    elif bad == "w_shape":
        w = w[:, :16].contiguous()
    elif bad == "tier_width":
        tier = tier[:, :64].contiguous()
    else:
        w = w.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        kblockfma.blockfma_a(starts, w, tier)


@pytest.mark.parametrize("bad", ["variant", "win_dtype", "blk_shape", "R"])
def test_mxu_rejects_what_the_kernel_does_not_take(bad):
    blk, lidx, lrow, win = tmxu.inputs(2)
    variant, R = "rawdyn", 512
    if bad == "variant":
        variant = "raw"
    elif bad == "win_dtype":
        win = win.float()
    elif bad == "blk_shape":
        blk = blk[:1].contiguous()
    else:
        R = 1024
    with pytest.raises((TypeError, ValueError)):
        kmxu.mxu_step(variant, blk, lidx, lrow, win, R)


@pytest.mark.parametrize("bad", ["mode", "masks_shape", "win_shape"])
def test_cond_rejects_what_the_kernel_does_not_take(bad):
    gcnt, masks, win = tcond.inputs(1.0, 2)
    mode = "nocond"
    if bad == "mode":
        mode = "cond_quarter"
    elif bad == "masks_shape":
        masks = masks[:-1].contiguous()
    else:
        win = win[:, :128].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kcond.cond_steps(mode, gcnt, masks, win)


@pytest.mark.parametrize("bad", ["mode", "no_staged", "staged_shape", "S_not_multiple"])
def test_proto_fused_rejects_what_the_kernel_does_not_take(bad):
    args, size = _proto_args()
    mode, staged = "fused", None
    if bad == "mode":
        mode = "overlap"
    elif bad == "no_staged":
        mode = "compute"
    elif bad == "staged_shape":
        mode, staged = "dma", torch.empty((size["TILES"], size["S"] - 64, 128))
    else:
        size["S"] = 1610
    with pytest.raises((TypeError, ValueError)):
        kproto.proto_fused(mode, *args, **size, staged=staged)


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    before = dict(cuda_build.LAUNCHES)
    for v in ("A", "B"):
        a = [torch.from_numpy(x) for x in tblockfma.inputs(v, 64, 256, 32)]
        plain = kblockfma.blockfma_a_torch if v == "A" else kblockfma.blockfma_b_torch
        assert torch.equal(tblockfma.run(v, *a), plain(*a))
    m = tmxu.inputs(2)
    for v in kmxu.VARIANTS:
        assert torch.equal(kmxu.mxu_step(v, *m), kmxu.mxu_step_torch(v, *m))
    c = tcond.inputs(0.5, 2)
    assert torch.equal(kcond.cond_steps("when_half", *c), kcond.cond_steps_torch("when_half", *c))
    args, size = _proto_args()
    assert torch.equal(kproto.proto_fused("fused", *args, **size),
                       kproto.proto_fused_torch("fused", *args, **size))
    assert cuda_build.LAUNCHES == before


def test_cond_half_skips_the_second_half_of_the_groups():
    """g_cnt = 16 runs sub-blocks 0-3 (groups 0-15): the tile is the
    all-groups tile of masks whose groups 16-31 are zero."""
    gcnt, masks, win = tcond.inputs(0.5, 2)
    zeroed = masks.view(2, 32, 4, 128).clone()
    zeroed[:, 16:] = 0
    want = kcond.cond_steps("nocond", gcnt, zeroed.view(-1, 4, 128), win)
    for mode in ("cond_half", "when_half"):
        torch.testing.assert_close(kcond.cond_steps(mode, gcnt, masks, win), want,
                                   rtol=1e-6, atol=1e-4)
    assert kcond.group_runs("cond_half", gcnt, 32).sum() == 2 * 16


def test_proto_fused_modes():
    """compute on a window that dma staged gives fused's result; dma
    returns zeros and stages X[scols] chunk by chunk."""
    args, size = _proto_args()
    scols, xp = args[0], args[4]
    staged = torch.full(kproto.staged_shape(size["S"], size["TILES"]), float("nan"))
    zeros = kproto.proto_fused("dma", *args, **size, staged=staged)
    assert torch.equal(zeros, torch.zeros_like(zeros))
    delta = size["S"] // size["SPT"]
    want = xp[scols[:size["TILES"] * size["SPT"]].reshape(-1, delta).long()]
    assert torch.equal(staged.view(-1, delta, 128), want)
    fused = kproto.proto_fused("fused", *args, **size)
    compute = kproto.proto_fused("compute", *args, **size, staged=staged)
    torch.testing.assert_close(compute, fused, rtol=0, atol=0)


def _proto_lanes_float64(args, R, S, SPT, TILES):
    """fused's output as a float64 sum of its lanes' hi/lo rows, and each
    output row's lane count."""
    scols, lidx, lrow, blk, xp = args
    G = blk.shape[-1]
    t, src = kproto.lane_sources(scols, lidx, blk, S, SPT, TILES, 0, TILES * SPT, False)
    dst = t * R + lrow[SPT * G:(TILES + 1) * SPT * G].reshape(-1).long()
    want = torch.zeros((TILES * R, 128), dtype=torch.float64)
    want.index_add_(0, dst, kproto.hilo(xp[src]).double())
    return want, torch.bincount(dst, minlength=TILES * R)


@pytest.mark.parametrize("mode", ["fused", "compute"])
@pytest.mark.parametrize("edge", sorted(PROTO_EDGES))
def test_proto_fused_sums_each_rows_lanes_and_zeros_empty_rows(mode, edge):
    args, size = _proto_args(**PROTO_EDGES[edge])
    staged = None
    if mode == "compute":
        staged = torch.empty(kproto.staged_shape(size["S"], size["TILES"]))
        kproto.proto_fused("dma", *args, **size, staged=staged)
    got = kproto.proto_fused(mode, *args, **size, staged=staged)
    want, count = _proto_lanes_float64(args, **size)
    assert int((count == 0).sum()) > 0
    torch.testing.assert_close(got.double(), want, rtol=ELEMENTWISE[0], atol=ELEMENTWISE[1])
    assert torch.equal(got[count == 0], torch.zeros_like(got[count == 0]))


def test_hilo_rounds_to_nearest_even_and_keeps_17_bits():
    # two ties (to the even neighbour), one above half an ulp, one tie at 3
    x = torch.tensor([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, 1.0 + 3 * 2.0**-9, 3.0 + 2.0**-7])
    hi = x.to(torch.bfloat16).float()
    assert torch.equal(hi, torch.tensor([1.0, 1.0 + 2.0**-6, 1.0 + 2.0**-7, 3.0]))
    v = torch.from_numpy(np.random.default_rng(3).random(10_000, np.float32))
    assert float(((kproto.hilo(v) - v).abs() / v).max()) <= 2.0**-17


def test_tool_inputs_follow_the_tpu_tools_generator():
    """The seeded generator's first draws decide the inputs: the same
    seed and calls give the same arrays, another seed others."""
    a = tblockfma.inputs("B", 64, 256, 32)
    assert a[0].dtype == np.int32 and a[0].shape == (64, 4) and int(a[0].max()) < 62
    assert np.array_equal(a[2], tblockfma.inputs("B", 64, 256, 32)[2])
    assert not np.array_equal(a[2], tblockfma.inputs("B", 64, 256, 32, seed=1)[2])
    blk, lidx, lrow, win = tmxu.inputs(4)
    assert (blk.shape, lidx.shape, win.dtype) == ((4, 1, 8), (32, 128), torch.bfloat16)
    assert int(lrow.max()) < 512 and int(blk.max()) < 64
    gcnt, masks, _ = tcond.inputs(0.5, 3)
    assert gcnt.tolist() == [16] * 3 and int(masks.min()) >= 0


@pytest.mark.parametrize("tool,argv", [
    ("microbench_blockfma", ["A", "B"]),
    ("microbench_mxu", ["3", "noop,rawdyn,chain2"]),
    ("microbench_cond", []),
    ("proto_fused", ["128", "256", "1600", "2", "--check", "--kernels",
                     "--modes=compute,dma,fused"]),
])
def test_tools_run_on_the_cpu_when_asked(tool, argv, monkeypatch, capsys):
    mod = {"microbench_blockfma": tblockfma, "microbench_mxu": tmxu,
           "microbench_cond": tcond, "proto_fused": tproto}[tool]
    if tool == "microbench_blockfma":
        monkeypatch.setattr(mod, "C", 64)
        monkeypatch.setattr(mod, "T", 256)
        monkeypatch.setattr(mod, "K", 32)
    elif tool == "microbench_cond":
        monkeypatch.setattr(mod, "STEPS", 2)
    elif tool == "proto_fused":
        monkeypatch.setattr(mod, "N", 4096)
    rows = mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rows and all(r["device"] == "cpu" and r["ms"] > 0 for r in rows)
    assert "bound" not in out.replace("no device bound", "")
    assert len(out.strip().splitlines()) >= len(rows)


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    for mod in (tblockfma, tmxu, tcond, tproto):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_work_counts_at_the_tools_defaults():
    """The bounds of the kernels' notes: bytes and operations from the
    tools' default inputs, over 3.35 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s."""
    peaks = (3.35e12, 67e12, 989e12)
    a = blockfma_work("A", *(torch.from_numpy(x) for x in tblockfma.inputs("A")))
    assert a.flops == 2 * 4096 * 256 * 8 * 128 and abs(a.bytes / 1e6 - 58.7) < 0.1
    assert a.bound(*peaks)[1] == "operations" and abs(a.bound(*peaks)[0] - 0.0321) < 1e-4
    b = blockfma_work("B", *(torch.from_numpy(x) for x in tblockfma.inputs("B")))
    assert abs(b.bytes / 1e6 - 29.4) < 0.1 and b.bound(*peaks)[1] == "bytes"
    args = tmxu.inputs()
    chain2 = mxu_work("chain2", *args[:3], 512)
    # every window row, lidx, lrow, blk and the 512-row tile
    assert chain2.bytes == 8192 * 512 + 2 * 16000 * 128 * 4 + 2000 * 8 * 4 + 512 * 128 * 4
    assert chain2.flops == 2000 * 8 * 128 * 256
    assert mxu_work("winstat", *args[:3], 128).bytes == 8 * 128 * 512 + 128 * 128 * 4
    full = cond_work(2048 * 32, 2048)
    assert full.flops == 65536 * 2 * 128 * 128 * 256
    assert full.bound(*peaks) == (pytest.approx(0.5558, abs=1e-4), "operations")
    assert cond_work(2048 * 16, 2048).flops * 2 == full.flops


def test_proto_fused_work_counts_what_the_lanes_reference():
    args, size = _proto_args()
    scols, lidx, lrow, blk, _ = args
    R, S, SPT, TILES = size["R"], size["S"], size["SPT"], size["TILES"]
    G, delta = 2, S // SPT
    lanes = TILES * SPT * G * 128
    fused = proto_fused_work("fused", scols, lidx, lrow, blk, **size)
    _, src = kproto.lane_sources(scols, lidx, blk, S, SPT, TILES, 0, TILES * SPT, False)
    rows = int(torch.unique(src).numel())
    assert rows < lanes
    assert fused.bytes == (rows * 512 + 2 * lanes * 4 + TILES * SPT * G * 4
                           + TILES * SPT * delta * 4 + TILES * R * 512)
    assert fused.flops == 2 * lanes * 128
    dma = proto_fused_work("dma", scols, lidx, lrow, blk, **size)
    assert dma.flops == 0 and dma.bytes > TILES * S * 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _poison(n_rows: int, dev) -> int:
    """Leave a freed block of (n_rows, 128) float32 holding NaN, and return
    its address: the caching allocator hands it to the next output of that
    size, so a row a kernel leaves unwritten shows."""
    return torch.full((n_rows, 128), float("nan"), device=dev).data_ptr()


def _normwise(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
def test_microbench_kernels_match_plain_versions_on_the_card():
    dev = _card()
    n0 = dict(cuda_build.LAUNCHES)
    for v in ("A", "B"):
        for C, T, K in ((64, 256, 32), (8192, 1 << 16, 256)):
            a = [torch.from_numpy(x).to(dev) for x in tblockfma.inputs(v, C, T, K)]
            plain = kblockfma.blockfma_a_torch if v == "A" else kblockfma.blockfma_b_torch
            torch.testing.assert_close(tblockfma.run(v, *a), plain(*a), rtol=ELEMENTWISE[0],
                                       atol=ELEMENTWISE[1])
    m = [t.to(dev) for t in tmxu.inputs(50)]
    for v in kmxu.VARIANTS:
        assert _normwise(kmxu.mxu_step(v, *m), kmxu.mxu_step_torch(v, *m)) <= NORMWISE
    for mode, frac in tcond.RUNS:
        c = [t.to(dev) for t in tcond.inputs(frac, 40)]
        assert _normwise(kcond.cond_steps(mode, *c), kcond.cond_steps_torch(mode, *c)) <= NORMWISE
    edges = {**PROTO_EDGES, **PROTO_CARD_EDGES}
    for edge in (None, *sorted(edges)):
        args, size = _proto_args(**edges.get(edge, {}))
        count = _proto_lanes_float64(args, **size)[1].to(dev)
        args = [t.to(dev) for t in args]
        staged = torch.empty(kproto.staged_shape(size["S"], size["TILES"]), device=dev)
        for mode in ("dma", "compute", "fused"):
            at = _poison(size["TILES"] * size["R"], dev)
            got = kproto.proto_fused(mode, *args, **size, staged=staged)
            assert got.data_ptr() == at
            want = kproto.proto_fused_torch(mode, *args, **size, staged=staged)
            torch.testing.assert_close(got, want, rtol=ELEMENTWISE[0], atol=ELEMENTWISE[1])
            if mode != "dma":
                assert not got[count == 0].any(), (edge, mode)
    torch.cuda.synchronize()
    launched = {k: cuda_build.LAUNCHES[k] - n0[k] for k in n0}
    assert launched["microbench_blockfma_a"] == 2 and launched["microbench_blockfma_b"] == 2
    assert launched["microbench_mxu"] == 6 and launched["microbench_cond"] == 5
    assert launched["proto_fused"] == 15
