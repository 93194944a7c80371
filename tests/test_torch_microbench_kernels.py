"""The microbenchmark kernels' wrappers (ops/cuda/{microbench_blockfma,
microbench_mxu,microbench_cond,proto_fused}.py), their tools'
command lines (of_spmm_tpu_torch/tools/), their work counts
(utils/roofline.py) and mxu_step's count form (the count matrix, its
sparse yardstick, its exact base-256 digits, the count plan), without
JAX, so that the file also runs on the card:

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
from of_spmm_tpu_torch.tools.microbench_dyngather import H100_OPTIN
from of_spmm_tpu_torch.tools import microbench_mxu as tmxu
from of_spmm_tpu_torch.tools import proto_fused as tproto
from of_spmm_tpu_torch.utils.roofline import (
    blockfma_work, cond_work, mxu_work, proto_fused_work)

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

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


@pytest.mark.parametrize("case", sorted(tcond.EDGES))
def test_count_form_matches_the_plain_version(case):
    """The kernel's form: per step the count matrix Cnt[k, c] of the groups
    run (bits taken from the words as unsigned), Cnt^T @ win, the halves
    added; against the plain version's product per group, normwise."""
    for mode, frac in tcond.RUNS:
        gcnt, masks, win = tcond.edge_inputs(case, frac, steps=3)
        steps, G = gcnt.shape[0], masks.shape[0] // gcnt.shape[0]
        words = masks.long() & 0xFFFFFFFF
        bits = (words[:, :, None, :] >> torch.arange(32)[None, None, :, None]) & 1
        runs = kcond.group_runs(mode, gcnt, G).long()
        cnt = (bits.view(steps, G, 128, 128) * runs[:, :, None, None]).sum(1)
        assert int(cnt.max()) == int(runs.sum(1).max())  # mask columns 0-7 are all ones
        prod = cnt.to(torch.float32).transpose(1, 2) @ win.to(torch.float32)
        want = kcond.cond_steps_torch(mode, gcnt, masks, win)
        assert _normwise(prod[..., :128] + prod[..., 128:], want) <= NORMWISE, (case, mode)


@pytest.mark.parametrize("case", sorted(tblockfma.B_EDGES))
def test_blockfma_b_edges_hold_what_they_name(case):
    """The B edges' shapes and rows, and the plain version's 0 on every row
    no slot names."""
    starts, vals, tier = (torch.from_numpy(a) for a in tblockfma.b_edge_inputs(case, C=256))
    R, K = tblockfma.B_EDGES[case]["R"], tblockfma.B_EDGES[case]["K"]
    assert tuple(starts.shape) == (8 * R, K // 8) and tuple(vals.shape) == tuple(starts.shape)
    named = tblockfma.named_rows(starts)
    per_step = {"one_row": 1, "empty_rows": 3}.get(case)
    assert per_step is None or named.view(R, 8).sum(1).eq(per_step).all()
    out = kblockfma.blockfma_b(starts, vals, tier)
    assert not out[~named].any() and bool((out[named] > 0).all())


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
    smem = 132 * 32 * 1.98e9  # shared-memory words/s: 32 a clock on 132 SMs at 1,980 MHz
    a = blockfma_work("A", *(torch.from_numpy(x) for x in tblockfma.inputs("A")))
    assert a.flops == 2 * 4096 * 256 * 8 * 128 and abs(a.bytes / 1e6 - 58.7) < 0.1
    # each (slot, row, column) reads one word of the tier the TPU holds in
    # VMEM, Hopper's shared memory: 1.07 G words, 0.128 ms, above the
    # operations' 0.0321 ms
    assert a.smem_words == 4096 * 256 * 8 * 128
    assert a.bound(*peaks, smem) == (pytest.approx(0.1284, abs=1e-4), "bytes")
    assert a.flops / peaks[1] * 1e3 == pytest.approx(0.0321, abs=1e-4)
    b = blockfma_work("B", *(torch.from_numpy(x) for x in tblockfma.inputs("B")))
    assert b.smem_words == 0
    assert abs(b.bytes / 1e6 - 29.4) < 0.1 and b.bound(*peaks)[1] == "bytes"
    args = tmxu.inputs()
    chain2 = mxu_work("chain2", *args[:3], 512)
    # every window row, lidx, lrow, blk and the 512-row tile; one bf16
    # product of the 512 x 8,192 counts and the window on the tensor cores
    assert chain2.bytes == 8192 * 512 + 2 * 16000 * 128 * 4 + 2000 * 8 * 4 + 512 * 128 * 4
    assert chain2.flops == 2 * 512 * 8192 * 256 and chain2.tensor_cores
    assert chain2.bound(*peaks) == (pytest.approx(0.0062, abs=1e-4), "bytes")
    assert mxu_work("winstat", *args[:3], 128).bytes == 8 * 128 * 512 + 128 * 128 * 4
    # one product a step of the count matrix, not one a group: the bytes bound
    full = cond_work(2048 * 32, 2048, 2048)
    assert full.flops == 2048 * 2 * 128 * 128 * 256
    assert full.bytes == 2048 * 32 * 2048 + 128 * 512 + 2048 * 4 + 2048 * 128 * 128 * 4
    assert full.bound(*peaks) == (pytest.approx(0.0802, abs=1e-4), "bytes")
    half = cond_work(2048 * 16, 2048, 2048)
    assert half.flops == full.flops
    assert half.bound(*peaks) == (pytest.approx(0.0601, abs=1e-4), "bytes")
    assert cond_work(0, 2048, 0).flops == 0


def test_mxu_work_counts_the_product_form_by_hand():
    """Two steps of one group on a window of two blocks, every lane on
    window row 3 of its step's block: the lanes read rows 3 and 131."""
    blk = torch.tensor([[[0]], [[1]]], dtype=torch.int32)
    lidx = torch.full((2, 128), 3, dtype=torch.int32)
    lrow = torch.zeros((2, 128), dtype=torch.int32)
    chain2 = mxu_work("chain2", blk, lidx, lrow, 200)
    assert chain2.bytes == 2 * 512 + 1024 + 1024 + 8 + 200 * 512  # rows, lidx, lrow, blk, tile
    assert chain2.flops == 2 * 200 * 2 * 256 and chain2.tensor_cores
    rawstat = mxu_work("rawstat", blk, lidx, lrow, 128)  # block g = 0 only: row 3
    assert rawstat.bytes == 512 + 1024 + 128 * 512 and rawstat.flops == 2 * 128 * 256
    winread = mxu_work("winread", blk, lidx, lrow, 128)  # both blocks whole, blk read
    assert winread.bytes == 256 * 512 + 8 + 128 * 512 and winread.flops == 2 * 128 * 256 * 256
    noop = mxu_work("noop", blk, lidx, lrow, 128)
    assert (noop.bytes, noop.flops, noop.tensor_cores) == (2 * 512 + 128 * 512, 256, False)
    # the counts at 3.35 TB/s and 989 TFLOP/s: chain2's bytes bound it
    assert chain2.bound(3.35e12, 67e12, 989e12)[1] == "bytes"


@pytest.mark.parametrize("variant", kmxu.VARIANTS[1:])
def test_sparse_yardstick_matches_the_plain_version(variant):
    """torch.sparse.mm of the count matrix's CSR times the window's halves
    added (chip_smoke.py's library call) is the variant's tile."""
    blk, lidx, lrow, win = tmxu.inputs(6, seed=3)
    sp = kmxu.count_csr(variant, blk, lidx, lrow, win.shape[0])
    cnt = kmxu.count_matrix(variant, blk, lidx, lrow, win.shape[0])
    assert sp.layout == torch.sparse_csr and int(cnt.sum()) == 6 * 8 * 128
    halves = win[:, :128].float() + win[:, 128:].float()
    want = kmxu.mxu_step_torch(variant, blk, lidx, lrow, win)
    assert _normwise(torch.sparse.mm(sp, halves), want) <= NORMWISE


@pytest.mark.parametrize("case", sorted(tmxu.EDGES))
def test_mxu_edges_hold_what_they_name(case):
    blk, lidx, lrow, win, R = tmxu.edge_inputs(case, S=3 if case == "ceiling" else None)
    S, _, G = blk.shape
    chain2 = kmxu.count_matrix("chain2", blk, lidx, lrow, win.shape[0], R)
    assert int(chain2.sum()) == S * G * 128 and chain2.shape == (R, win.shape[0])
    if case == "ceiling":  # one cell holds every lane
        assert int(chain2[0, 0]) == S * G * 128
    elif case in ("R500", "R300"):
        assert R == int(case[1:]) and int(lrow.max()) < R
    elif case == "one_block":
        assert win.shape[0] == 128 and G == 1 and int(blk.max()) == 0
    else:
        assert S == 1


def _digit_form(variant, blk, lidx, lrow, win, R):
    """The kernels' arithmetic: each count cut into base-256 digits, digit d
    as the bf16 value digit x 256^d, every digit's product with each window
    half summed in float32."""
    cnt = kmxu.count_matrix(variant, blk, lidx, lrow, win.shape[0], R)
    digits = [(cnt >> (8 * d)) & 255 for d in range(4)]
    assert torch.equal(sum(dg << (8 * d) for d, dg in enumerate(digits)), cnt)
    out = torch.zeros((cnt.shape[0], 128))
    wf = win.float()
    for d, dg in enumerate(digits):
        a = (dg.double() * 256.0**d).to(torch.bfloat16)
        assert torch.equal(a.double(), dg.double() * 256.0**d)  # exact in bf16
        out += a.float() @ wf[:, :128] + a.float() @ wf[:, 128:]
    return out


@pytest.mark.parametrize("case", sorted(tmxu.EDGES))
def test_digit_form_matches_the_plain_version(case):
    """Counts of 1 to 3 digits (the ceiling's 3,072 here, 2,048,000 at the
    tool's size) give the plain version's tile within the kernels' bar."""
    *m, R = tmxu.edge_inputs(case, S=3 if case == "ceiling" else None)
    for variant in kmxu.VARIANTS[1:]:
        want = kmxu.mxu_step_torch(variant, *m, R)
        assert _normwise(_digit_form(variant, *m, R), want) <= NORMWISE, variant


def test_plain_version_sums_the_ceiling_exactly():
    """Every lane into one cell: the plain version's float64 sum gives
    S G 128 times the window row (a float32 sum of 2,048,000 terms would be
    off by about 1e-2)."""
    blk, lidx, lrow, win, R = tmxu.edge_inputs("ceiling", S=40)
    got = kmxu.mxu_step_torch("chain2", blk, lidx, lrow, win, R)
    row = win[0, :128].float() + win[0, 128:].float()
    torch.testing.assert_close(got[0], (row.double() * 40 * 8 * 128).float(), rtol=0, atol=0)
    assert not got[1:].any()


@pytest.mark.parametrize("variant,R,plan", [
    ("chain2", 512, (64, 1, 256)), ("chain2", 500, (64, 1, 256)), ("chain2", 200, (64, 2, 256)),
    ("chain2", 300, (64, 1, 128)),
    ("rawdyn", 512, (64, 2, 128)), ("rawstat", 512, (8, 16, 128)),
    ("winread", 512, (64, 1, 128)), ("winstat", 512, (8, 1, 128)),
])
def test_count_plan_fills_the_sms(variant, R, plan):
    """The count blocks of the tool's default size on 132 SMs: window blocks
    x parts x tile rows; one part where a block's count is its item count."""
    got = kmxu.count_plan(variant, tmxu.S, tmxu.G, 64 * 128, kmxu.tile_rows(variant, R), 132)
    assert got == plan
    nb, parts, rows_t = got
    rows_pad = -(-kmxu.tile_rows(variant, R) // 128) * 128
    tiles = rows_pad // rows_t
    assert rows_pad % rows_t == 0 and nb * parts * tiles <= max(132, nb * tiles)
    assert kmxu.count_plan("rawstat", 1, 8, 8192, 128, 132)[1] == 1  # no more parts than steps


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


@pytest.mark.parametrize("C,stages,plan", [(64, 6, 0), (1000, 5, 0), (2303, 5, 0), (2304, 5, 5),
                                           (5000, 3, 3), (8192, 2, 2), (9336, 2, 2), (9337, 0, 0),
                                           (65536, 0, 0)])
def test_a_stages_fit_the_opt_in_shared_memory(C, stages, plan):
    """At the H100's 232,448 bytes A's sliced kernel holds a 4-column slice
    of the C-row tier, two output tiles and 2 to 8 stages (32 steps x 32
    slots of w and starts), 0 where 2 do not fit; its path takes it from
    A_SLICED_MIN_C rows on, the L2 kernel elsewhere. The switches fall
    where the tool's A_EDGES put their two sides."""
    assert kblockfma.a_stages(C, H100_OPTIN) == stages
    assert kblockfma.a_plan(C, H100_OPTIN) == plan
    fixed, stage = kblockfma.SMEM_FIXED + kblockfma.TILES + C * 16, kblockfma.STAGE_BYTES
    if stages:
        assert fixed + stages * stage <= H100_OPTIN
        assert stages == kblockfma.MAX_STAGES or fixed + (stages + 1) * stage > H100_OPTIN
    sides = {case: kblockfma.a_plan(e["C"], H100_OPTIN) for case, e in tblockfma.A_EDGES.items()}
    assert sides["C2303"] == 0 < sides["C2304"] and sides["C9336"] > 0 == sides["C9337"]


def test_a_edges_hold_what_they_name():
    for case, e in tblockfma.A_EDGES.items():
        starts, w, tier = tblockfma.a_edge_inputs(case, seed=1)
        assert starts.shape == (8 * e["R"], e["K"] // 8) and tier.shape == (e["C"], 128)
        assert starts.min() >= 0 and starts.max() + 8 <= e["C"]
        if case == "last_start":
            assert (starts == e["C"] - 8).sum() > 0


def _fma32(acc, w, x):
    """fmaf(w, x, acc) in float32: w x is exact in float64 (24 + 24 bits),
    the sum rounded to float64 and then to float32."""
    return (w.double() * x.double() + acc.double()).float()


def _a_parent_order(s, w3, tier):
    """blockfma_a_kernel's sums: a block a step, a warp a row, all 128
    columns, k in order. s (R, K) slot starts, w3 (R, 8, K)."""
    j = torch.arange(8)
    acc = torch.zeros((s.shape[0], 8, 128))
    for k in range(s.shape[1]):
        acc = _fma32(acc, w3[:, :, k:k + 1], tier[s[:, k:k + 1] + j])
    return acc


def _a_sliced_order(s, w3, tier, W=kblockfma.SLICE_COLS):
    """blockfma_a_sliced_kernel's sums: a slice of W columns at a time, its
    steps in stages of 32, each stage's 32 slots in order."""
    R, K = s.shape
    j = torch.arange(8)
    out = torch.full((R, 8, 128), float("nan"))
    for c0 in range(0, 128, W):
        for r0 in range(0, R, kblockfma.STAGE_STEPS):
            st = slice(r0, min(r0 + kblockfma.STAGE_STEPS, R))
            acc = torch.zeros((st.stop - r0, 8, W))
            for k0 in range(0, K, 32):
                for k in range(k0, min(k0 + 32, K)):
                    x = tier[s[st, k:k + 1] + j][..., c0:c0 + W]
                    acc = _fma32(acc, w3[st, :, k:k + 1], x)
            out[st, :, c0:c0 + W] = acc
    return out


def test_a_sliced_order_is_the_l2_kernels_bit_for_bit():
    """A's sliced order of sums, a slice at a time in slot order (40 steps:
    a last stage of 8; K 40: a last stage of 8 slots), equals the L2
    kernel's bit for bit, and both the plain version within
    1e-5 + 1e-4|p|."""
    starts, w, tier = (torch.from_numpy(x) for x in tblockfma.inputs("A", 64, 40 * 40, 40, 3))
    s, w3 = kblockfma._slots(starts, 40), w.view(40, 8, 40)
    parent = _a_parent_order(s, w3, tier)
    assert kblockfma.a_stages(64, H100_OPTIN) and torch.equal(_a_sliced_order(s, w3, tier), parent)
    torch.testing.assert_close(parent.reshape(-1, 128), kblockfma.blockfma_a_torch(starts, w, tier),
                               rtol=ELEMENTWISE[0], atol=ELEMENTWISE[1])


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


@pytest.mark.cuda
def test_mxu_at_its_edges_on_the_card():
    """Every variant at the redesign's edges (a count at its ceiling S G
    128 = 2,048,000, R = 500 and 300, a window of one block, one step) and
    winstat at the default size (every count 2,000), each output on
    NaN-poisoned memory, against the plain version."""
    dev = _card()
    cases = [(case, tmxu.edge_inputs(case)) for case in sorted(tmxu.EDGES)]
    cases.append(("default", (*tmxu.inputs(), tmxu.R)))
    for case, (*m, R) in cases:
        m = [t.to(dev) for t in m]
        for v in kmxu.VARIANTS:
            at = _poison(kmxu.tile_rows(v, R), dev)
            got = kmxu.mxu_step(v, *m, R)
            assert got.data_ptr() == at
            assert _normwise(got, kmxu.mxu_step_torch(v, *m, R)) <= NORMWISE, (case, v)


@pytest.mark.cuda
def test_redesigned_kernels_at_their_edges_on_the_card():
    """blockfma_b at its edges (one row a step, rows no slot names, K = 8
    and 512, an odd R) and cond_steps at its (full-range masks with counts
    at G, gcnt of 0, 1, 5, 31, 32, -1 and 40 in one launch, G = 4 and 36),
    every output on NaN-poisoned memory, against the plain versions."""
    dev = _card()
    for seed in (0, 1):
        for case in sorted(tblockfma.B_EDGES):
            a = [torch.from_numpy(x).to(dev) for x in tblockfma.b_edge_inputs(case, seed=seed)]
            at = _poison(a[0].shape[0], dev)
            got = kblockfma.blockfma_b(*a)
            assert got.data_ptr() == at
            torch.testing.assert_close(got, kblockfma.blockfma_b_torch(*a), rtol=ELEMENTWISE[0],
                                       atol=ELEMENTWISE[1])
            assert not got[~tblockfma.named_rows(a[0])].any(), case
        for case in sorted(tcond.EDGES):
            for mode, frac in tcond.RUNS:
                c = [t.to(dev) for t in tcond.edge_inputs(case, frac, seed=seed)]
                at = _poison(c[0].shape[0] * 128, dev)
                got = kcond.cond_steps(mode, *c)
                assert got.data_ptr() == at
                assert _normwise(got, kcond.cond_steps_torch(mode, *c)) <= NORMWISE, (case, mode)


@pytest.mark.cuda
def test_blockfma_a_paths_at_their_edges_on_the_card():
    """A's L2 kernel and sliced kernel at the tool's A_EDGES (C on each
    side of both switches, R 257, K 40, a start at C - 8), two seeds, each
    output on NaN-poisoned memory: bit-equal to each other and within 1e-5 + 1e-4|p| of the plain
    version; the wrapper's own path gives the same bits."""
    dev = _card()
    optin = kblockfma.smem_optin(dev)
    sliced = set()
    for seed in (1, 2):
        for case in sorted(tblockfma.A_EDGES):
            a = [torch.from_numpy(x).to(dev) for x in tblockfma.a_edge_inputs(case, seed)]
            at = _poison(a[0].shape[0], dev)
            ref = kblockfma._launch(0, "microbench_blockfma_a", *a, sliced=False)
            assert ref.data_ptr() == at, case
            torch.testing.assert_close(ref, kblockfma.blockfma_a_torch(*a), rtol=ELEMENTWISE[0],
                                       atol=ELEMENTWISE[1])
            fits = kblockfma.a_stages(a[2].shape[0], optin) > 0
            sliced.add(fits)
            if fits:
                at = _poison(a[0].shape[0], dev)
                got = kblockfma._launch(0, "microbench_blockfma_a", *a, sliced=True)
                assert got.data_ptr() == at and torch.equal(got, ref), case
            assert torch.equal(kblockfma.blockfma_a(*a), ref), case
    assert sliced == {True, False}
