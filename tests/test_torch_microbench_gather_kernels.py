"""The gather microbenchmark kernels' wrappers (ops/cuda/{microbench_gather,
microbench_gather2,microbench_dyngather}.py), their tools' command lines
(of_spmm_tpu_torch/tools/) and their work counts (utils/roofline.py),
without JAX, so that the file also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_microbench_gather_kernels.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU the wrappers' checks, their dispatch to the plain
versions, the one-hot forms' zero rows, the tools' command lines and the
counts run; the ``cuda``-marked test skips. The card test holds every
kernel against its plain version on two seeds of the small cases and of
the redesigned kernels' edges (onehot's, onehot_pair's and window_pair's
indices outside their window, twosided at R = 1000 and 1024 with lanes
outside their window).
"""

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda import microbench_dyngather as kdyn
from of_spmm_tpu_torch.ops.cuda import microbench_gather as kgather
from of_spmm_tpu_torch.ops.cuda import microbench_gather2 as kgather2
from of_spmm_tpu_torch.tools import microbench_dyngather as tdyn
from of_spmm_tpu_torch.tools import microbench_gather as tgather
from of_spmm_tpu_torch.tools import microbench_gather2 as tgather2
from of_spmm_tpu_torch.utils.roofline import (
    block_slice_work, ell_work, onehot_macs, onehot_work, row_gather_work, smem_cap_work,
    take_along_work, twosided_work)

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

C, T = 64, 2048
ELEMENTWISE = (1e-4, 1e-5)  # sums of positive terms in another order
NORMWISE = 1e-4             # twosided: lanes added with atomics in no fixed order
PEAKS = (3.35e12, 67e12, 989e12)  # H100 SXM: bytes/s, fp32 and bf16 tensor FLOP/s
SMEM = 132 * 32 * 1.98e9            # H100 SXM: shared-memory words/s


def _cases(seed: int = 0, C: int = C, T: int = T):
    """Every wrapper's arguments at a small size: name -> (wrapper, plain, args)."""
    loop = tgather.inputs_vmem_loop(C, T, 16, seed)
    take = tgather.inputs_take(C, T, seed)
    take16 = tgather.inputs_take(C, T, seed, torch.bfloat16)
    block = tgather.inputs_block_slice(C, T, 8, seed)
    dma = tgather.inputs_row_dma(300, T, seed)
    pair = tgather2.inputs_onehot_pair(C, T, seed)
    fused = tgather2.inputs_take_fused(C, T, 8, seed)
    *window, _ = tgather2.inputs_window_pair(1024, 128, T, U=300, seed=seed)
    two = tgather2.inputs_twosided(512, 128, 64, T, seed=seed)
    tala = tdyn.inputs(C, 32, "ne", seed)
    return {
        "vmem_loop": (kgather.vmem_loop, kgather.vmem_loop_torch, loop),
        "vmem_take": (kgather.vmem_take, kgather.vmem_take_torch, take),
        "onehot_f32": (kgather.onehot, kgather.onehot_torch, take),
        "onehot_bf16": (kgather.onehot, kgather.onehot_torch, take16),
        "block_slice": (kgather.block_slice, kgather.block_slice_torch, block),
        "row_dma": (kgather.row_dma, kgather.row_dma_torch, (*dma, 16)),
        "onehot_pair": (kgather2.onehot_pair, kgather2.onehot_pair_torch, pair),
        "take_fused": (kgather2.take_fused, kgather2.take_fused_torch, fused),
        "dma_deep": (kgather2.dma_deep, kgather2.dma_deep_torch, (*dma, 64)),
        "window_pair": (kgather2.window_pair, kgather2.window_pair_torch, (*window, 128)),
        "twosided": (kgather2.twosided, kgather2.twosided_torch, (*two, 128, 64)),
        "take_along": (kdyn.take_along, kdyn.take_along_torch, (*tala, 3)),
        "smem_cap": (kdyn.smem_cap, kdyn.smem_cap_torch,
                     (torch.ones((8, 128)), tdyn.H100_OPTIN)),
    }


def _pair_outside(name: str, seed: int = 0):
    """onehot_pair's or window_pair's (wrapper, plain, args) with indices
    below 0 and at or past the window (with_outside)."""
    if name == "onehot_pair":
        cols, hi, lo = tgather2.inputs_onehot_pair(C, T, seed)
        return (kgather2.onehot_pair, kgather2.onehot_pair_torch,
                (tgather.with_outside(cols, C), hi, lo))
    bases, lidx, hi, lo, _ = tgather2.inputs_window_pair(256, 100, T, U=300, seed=seed)
    return (kgather2.window_pair, kgather2.window_pair_torch,
            (bases, tgather.with_outside(lidx, 100), hi, lo, 100))


def _edges(seed: int = 0):
    """The redesigned kernels' edges: onehot with indices below 0 and at or
    past C in both types, and onehot_pair and window_pair alike; twosided
    with window indices outside [0, CW), at R = 1000 and 1024, whose
    (R, 128) partials exceed a block's shared memory (rows sliced
    unevenly: 334 and 342 a block on an H100), at lane counts that leave
    the last block partial."""
    cols, tier = tgather.inputs_take(C, T, seed)
    cols = tgather.with_outside(cols, C)
    cases = {f"onehot_{n}_outside": (kgather.onehot, kgather.onehot_torch, (cols, tier.to(d)))
             for n, d in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    cases.update({f"{n}_outside": _pair_outside(n, seed) for n in ("onehot_pair", "window_pair")})
    for tile, cw, r, t in ((256, 200, 1000, 256 * 501), (1024, 256, 1024, 1024 * 75)):
        bases, lidx, rows, vals, hi, lo = tgather2.inputs_twosided(tile, cw, r, t, seed=seed)
        args = (bases, tgather.with_outside(lidx, cw), rows, vals, hi, lo, cw, r)
        cases[f"twosided_R{r}"] = (kgather2.twosided, kgather2.twosided_torch, args)
    return cases


BAD = [
    ("vmem_loop", lambda a: (a[0].long(), a[1], a[2])),
    ("vmem_loop", lambda a: (a[0], a[1][:, :8].contiguous(), a[2])),
    ("vmem_take", lambda a: (a[0], a[1][:, :64].contiguous())),
    ("vmem_take", lambda a: (a[0].reshape(-1, 64).contiguous(), a[1])),
    ("onehot_f32", lambda a: (a[0], a[1].double())),
    ("block_slice", lambda a: (a[0][:-1].contiguous(), a[1])),
    ("row_dma", lambda a: (a[0], a[1], 0)),
    ("onehot_pair", lambda a: (a[0], a[1].float(), a[2])),
    ("onehot_pair", lambda a: (a[0], a[1], a[2][:-1].contiguous())),
    ("take_fused", lambda a: (a[0], a[1].t().contiguous().t(), a[2])),
    ("dma_deep", lambda a: (a[0], a[1], 512)),
    ("window_pair", lambda a: (a[0], a[1], a[2], a[3], a[2].shape[0] + 1)),
    ("window_pair", lambda a: (a[0][:2].contiguous(), a[1][:3].contiguous(), *a[2:])),
    ("twosided", lambda a: (*a[:7], 0)),
    ("twosided", lambda a: (a[0], a[1], a[2][:-1].contiguous(), *a[3:])),
    ("take_along", lambda a: (a[0], a[1], 0)),
    ("smem_cap", lambda a: (a[0], 4000)),
    ("smem_cap", lambda a: (a[0][:4].contiguous(), a[1])),
]


@pytest.mark.parametrize("name,bad", BAD, ids=[f"{n}-{i}" for i, (n, _) in enumerate(BAD)])
def test_wrappers_reject_what_the_kernels_do_not_take(name, bad):
    wrapper, _, args = _cases()[name]
    with pytest.raises((TypeError, ValueError)):
        wrapper(*bad(args))


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    before = dict(cuda_build.LAUNCHES)
    for name, (wrapper, plain, args) in _cases().items():
        got = wrapper(*args)
        assert torch.equal(got, plain(*args)), name
        assert torch.isfinite(got).all(), name
    assert cuda_build.LAUNCHES == before


def test_indices_outside_the_table_raise_on_the_cpu():
    cols, vals, tier = tgather.inputs_vmem_loop(C, T, 16)
    cols[3, 5] = C
    with pytest.raises(IndexError):
        kgather.vmem_loop(cols, vals, tier)
    bases, lidx, hi, lo, _ = tgather2.inputs_window_pair(1024, 128, T, U=300)
    bases[1, 0] = hi.shape[0] - 127
    with pytest.raises(IndexError):
        kgather2.window_pair(bases, lidx, hi, lo, 128)


def test_onehot_forms_give_a_zero_row_outside_their_window():
    cols, tier = tgather.inputs_take(C, T, dtype=torch.bfloat16)
    cols[0, :3] = torch.tensor([C, -1, C - 1], dtype=torch.int32)
    out = kgather.onehot(cols, tier)
    assert not out[:2].any() and torch.equal(out[2], tier[C - 1].float())
    cols, hi, lo = tgather2.inputs_onehot_pair(C, T)
    cols[1, 0] = C + 7
    pair = kgather2.onehot_pair(cols, hi, lo)
    assert not pair[128].any() and torch.equal(pair[129], hi[cols[1, 1]].float()
                                               + lo[cols[1, 1]].float())
    bases, lidx, hi, lo, _ = tgather2.inputs_window_pair(1024, 128, T, U=300)
    lidx[0, 0] = 128
    got = kgather2.window_pair(bases, lidx, hi, lo, 128)
    assert not got[0].any()
    b, l1 = int(bases[0, 0]), int(lidx[0, 1])
    assert torch.equal(got[1], hi[b + l1].float() + lo[b + l1].float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_gives_zero_rows_below_zero_and_past_the_tier(dtype):
    cols, tier = tgather.inputs_take(C, T, dtype=dtype)
    cols = tgather.with_outside(cols, C)
    flat = cols.reshape(-1).long()
    out = kgather.onehot(cols, tier)
    outside = (flat < 0) | (flat >= C)
    assert int((flat < 0).sum()) > 0 and int((flat >= C).sum()) > 0
    assert not out[outside].any()
    assert torch.equal(out[~outside], tier[flat[~outside]].float())


@pytest.mark.parametrize("name", ["onehot_pair", "window_pair"])
def test_pair_gathers_give_zero_rows_outside_their_window(name):
    """Every row whose index lies below 0 or at or past the window is zero;
    every other row is f32(hi) + f32(lo) of its table row, bit for bit."""
    wrapper, _, args = _pair_outside(name)
    if name == "window_pair":
        bases, idx, hi, lo, window = args
        base = bases.reshape(-1).long().repeat_interleave(T // bases.numel())
    else:
        (idx, hi, lo), window, base = args, C, 0
    flat = idx.reshape(-1).long()
    outside = (flat < 0) | (flat >= window)
    assert int((flat < 0).sum()) > 0 and int((flat >= window).sum()) > 0
    out = wrapper(*args)
    assert not out[outside].any()
    src = (flat + base)[~outside]
    assert torch.equal(out[~outside], hi[src].float() + lo[src].float())


def test_hilo_pair_rounds_to_nearest_even_and_keeps_the_residual():
    x = np.array([[1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, 1.0 + 2.0**-12]], np.float32)
    hi, lo = tgather2.hilo_pair(x)
    assert hi.float().tolist() == [[1.0, 1.0 + 2.0**-6, 1.0]]
    assert (hi.float() + lo.float()).tolist() == x.tolist()


def test_twosided_adds_each_lanes_hi_and_lo_into_its_row():
    bases, lidx, rows, vals, hi, lo = tgather2.inputs_twosided(512, 128, 64, T)
    g = kgather2.window_pair(bases, lidx, hi, lo, 128).double()
    want = torch.zeros((64, 128), dtype=torch.float64).index_add_(
        0, rows.reshape(-1).long(), g * vals.reshape(-1, 1).double())
    got = kgather2.twosided(bases, lidx, rows, vals, hi, lo, 128, 64)
    assert float((got.double() - want).abs().max() / want.abs().max()) < 2.0**-16


def test_twosided_drops_lanes_outside_their_window_at_r_1000():
    args = _edges()["twosided_R1000"][2]
    bases, lidx, rows, vals, hi, lo, cw, r = args
    li = lidx.reshape(-1).long()
    inside = (li >= 0) & (li < cw)
    assert int((~inside).sum()) > 0
    src = bases.reshape(-1).long().repeat_interleave(256) + li.clamp(0, cw - 1)
    g = (hi[src].double() + lo[src].double()) * inside[:, None]
    want = torch.zeros((r, 128), dtype=torch.float64).index_add_(
        0, rows.reshape(-1).long(), g * vals.reshape(-1, 1).double())
    got = kgather2.twosided(*args)
    assert got.shape == (1000, 128)
    assert float((got.double() - want).abs().max() / want.abs().max()) < 2.0**-16


def test_take_along_repeats_one_pass():
    idx, table = tdyn.inputs(C, 32, "bcast")
    once = kdyn.take_along(idx, table, 1)
    assert torch.equal(kdyn.take_along(idx, table, 4), once)
    assert torch.equal(once, torch.gather(table, 0, idx.long()))
    assert (idx == idx[:, :1]).all()


def test_smem_cap_sizes_straddle_the_limit():
    sizes = tdyn.cap_sizes(232448)
    assert sizes == sorted(sizes, reverse=True) and 232448 in sizes
    assert sum(s > 232448 for s in sizes) == 3 and all(s % 16 == 0 for s in sizes)
    assert kdyn.smem_optin(torch.device("cpu")) is None


SMALL_SIZES = {
    "microbench_gather": dict(T=4096, STREAM_N=4096, XLA_ROWS=(300,), VMEM_C=(64,), VMEM_K=16,
                              TAKE_C=(64,), ONEHOT_C=(64,), BLOCK_C=64, BLOCK_K=8,
                              DMA_ROWS=300, DMA_T=2048),
    "microbench_gather2": dict(T=4096, VTAKE_C=(64,), SMALL_C=(64,), FUSED_C=(64,),
                               DEEP_ROWS=300, DEEP_T=2048, DEEP_W=((16, 1), (128, 16)),
                               XLA_C=(64,), XLA_T=4096, WINDOW=((1024, 128),),
                               TWOSIDED=((512, 128, 64),)),
    "microbench_dyngather": dict(RUNS=(("tala_eq", 64, 64, "eq"), ("tala_bcast", 64, 32, "bcast")),
                                 STEPS=2),
}
TOOLS = {"microbench_gather": (tgather, []),
         "microbench_gather2": (tgather2, list(tgather2.NAMES)),
         "microbench_dyngather": (tdyn, [])}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_run_on_the_cpu_when_asked(tool, monkeypatch, capsys):
    mod, argv = TOOLS[tool]
    for k, v in SMALL_SIZES[tool].items():
        monkeypatch.setattr(mod, k, v)
    rows = mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rows and all(r["device"] == "cpu" and r["ms"] > 0 for r in rows)
    assert "bound" not in out.replace("no device bound", "")
    assert out.strip().endswith("done") and len(out.strip().splitlines()) > len(rows)
    with pytest.raises(SystemExit):
        mod.main(["nosuchname", "--device", "cpu"])


def test_gather2_default_list_leaves_out_window_and_twosided(monkeypatch):
    for k, v in SMALL_SIZES["microbench_gather2"].items():
        monkeypatch.setattr(tgather2, k, v)
    kernels = {r["kernel"] for r in tgather2.main(["--device", "cpu"])}
    assert kernels == {"gather_vmem_take", "gather_onehot", "gather2_onehot_pair",
                       "gather2_take_fused", "gather2_dma_deep", None}


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    for mod in (tgather, tgather2, tdyn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_work_counts_at_the_tools_defaults():
    """Bytes and operations of the tools' default inputs (the 1 GiB table
    of row_dma as an unfilled tensor of its shape; its indices are the
    generator's first draw)."""
    cols, vals, tier = tgather.inputs_vmem_loop(8192, tgather.T)
    loop = ell_work(cols, 128, tier, vals)
    assert loop.flops == 2 * 2**20 * 128 and loop.bytes == 8190 * 512 + 3 * 2**22
    assert loop.bound(*PEAKS)[1] == "bytes" and loop.smem_words == 0
    # the tier the TPU holds in VMEM: each of the 1M indices' 128 words also
    # out of shared memory, 0.016 ms at 132 SMs x 32 words x 1,980 MHz,
    # above the 0.0050 ms of its bytes
    resident = ell_work(cols, 128, tier, vals, resident=True)
    assert resident.bytes == loop.bytes and resident.smem_words == 2**20 * 128
    assert resident.bound(*PEAKS, SMEM) == (pytest.approx(0.0161, abs=1e-4), "bytes")
    assert loop.bound(*PEAKS)[0] == pytest.approx(0.0050, abs=1e-4)
    # take_fused: its 0.0238 ms of bytes stands above its 0.016 of words
    fcols, fvals, ftier = tgather2.inputs_take_fused(8192)
    fused = ell_work(fcols, 8, ftier, fvals, resident=True)
    assert fused.smem_words == 2**20 * 128
    assert fused.bound(*PEAKS, SMEM) == (pytest.approx(0.0238, abs=1e-4), "bytes")
    cols, tier = tgather.inputs_take(2048, tgather.T)
    take = row_gather_work(cols, tier)
    assert take.bytes == 2046 * 512 + 2**22 + 2**29
    # a one-hot gather is the row gather: its bound is bytes, and the
    # prescribed one-hot multiply-adds are counted apart
    oh = onehot_work(cols, (tier,), 2048)
    assert oh.flops == 0 and oh.bytes == take.bytes
    assert oh.bound(*PEAKS) == (pytest.approx(0.1618, abs=1e-4), "bytes")
    assert onehot_macs(cols, 1, 2048) == 2**20 * 2048 * 128
    oh16 = onehot_work(cols, (tier.to(torch.bfloat16),), 2048)
    assert oh16.flops == 0 and oh16.bytes == 2046 * 256 + 2**22 + 2**29
    starts, tier = tgather.inputs_block_slice(8192, tgather.T)
    blk = block_slice_work(starts, tier)
    assert starts.shape == (1024, 128) and blk.flops == 2**17 * 8 * 128
    assert blk.bytes == 8190 * 512 + 2**19 + 1024 * 512  # rows 0 .. C - 3 of 8-row blocks
    # each start's 8 rows x 128 words out of the VMEM-resident tier: 0.016 ms
    # of shared-memory words, above the 0.0020 ms of its adds
    assert blk.smem_words == 2**17 * 8 * 128
    assert blk.bound(*PEAKS, SMEM) == (pytest.approx(0.0161, abs=1e-4), "bytes")

    def first_draw(rows, n):
        return torch.from_numpy(np.random.default_rng(0).integers(0, rows - 2, n)
                                .astype(np.int32).reshape(-1, 128))

    assert torch.equal(first_draw(300, T), tgather.inputs_row_dma(300, T)[0])
    dcols, table = first_draw(2**21, 2**18), torch.empty((2**21, 128))
    rows = int(torch.unique(dcols).numel())
    assert ell_work(dcols, 16, table).bytes == rows * 512 + 2**20 + 2**14 * 512
    assert ell_work(dcols, 128, table).bytes == rows * 512 + 2**20 + 2**11 * 512
    # row_dma's and dma_deep's table lies in device memory: no shared words
    assert ell_work(dcols, 16, table).smem_words == ell_work(dcols, 128, table).smem_words == 0
    cols, hi, lo = tgather2.inputs_onehot_pair(128, tgather2.T)
    pair = onehot_work(cols, (hi, lo), 128)
    assert pair.flops == 2**20 * 128 and pair.bytes == 126 * 512 + 2**22 + 2**29
    assert pair.bound(*PEAKS)[1] == "bytes" and onehot_macs(cols, 2, 128) == 2**20 * 128 * 256
    two = tgather2.inputs_twosided(1024, 256, 256, tgather2.T)
    tw = twosided_work(*two, 256, 256)
    gathered = onehot_work(two[1], two[4:], 256, two[0])
    assert tw.flops == 2 * 2**20 * 128 and not tw.tensor_cores
    assert tw.bytes == gathered.bytes - 2**29 + 2 * 2**22 + 256 * 512
    assert tw.bound(*PEAKS)[1] == "bytes"
    idx, table = tdyn.inputs(2048, 1024, "ne")
    ta = take_along_work(idx, table)
    assert ta.flops == 0 and idx.nbytes * 2 < ta.bytes <= idx.nbytes * 2 + table.nbytes
    assert ta.smem_words == 1024 * 128
    # tala_eq's 256 passes: words through shared memory at 132 SMs x 32 a
    # clock x 1,980 MHz bound it, not one pass's bytes
    eq = take_along_work(*tdyn.inputs(2048, 2048, "eq"), 256)
    assert eq.smem_words == 256 * 2048 * 128
    assert eq.bound(*PEAKS, SMEM) == (pytest.approx(0.0080, abs=1e-4), "bytes")
    assert eq.bound(*PEAKS, SMEM)[0] > eq.bytes / PEAKS[0] * 1e3
    assert smem_cap_work(torch.ones((8, 128))).bytes == 8192


def test_take_along_work_counts_both_terms_by_hand():
    """Two rows of indices into a 4-row table, the two rows alike: 128
    distinct elements a row's lanes read, idx, the output; and the passes'
    words. One pass is bound by its bytes, 10,000 passes by shared memory."""
    table = torch.arange(4 * 128, dtype=torch.float32).view(4, 128)
    idx = torch.tensor([[1] * 128, [1] * 128], dtype=torch.int32)
    one = take_along_work(idx, table)
    assert (one.bytes, one.flops, one.smem_words) == (128 * 4 + 1024 + 1024, 0, 256)
    many = take_along_work(idx, table, 10_000)
    assert many.bytes == one.bytes and many.smem_words == 10_000 * 256
    assert one.bound(*PEAKS, SMEM) == (pytest.approx(one.bytes / PEAKS[0] * 1e3), "bytes")
    assert many.bound(*PEAKS, SMEM) == (pytest.approx(10_000 * 256 / SMEM * 1e3), "bytes")
    with pytest.raises(ValueError, match="shared-memory rate"):
        many.bound(*PEAKS)


@pytest.mark.parametrize("C,lanes", [(512, 16), (2048, 16), (5000, 8), (8192, 4), (15000, 3),
                                     (32768, 1), (58112, 1), (58113, 0), (65536, 0)])
def test_slice_lanes_fit_the_opt_in_shared_memory(C, lanes):
    """At the H100's 232,448 bytes: 16 lanes at most, multiples of 4 from 4
    on, 0 (the direct L2 kernel) where one lane of C rows does not fit."""
    got = kdyn.slice_lanes(C, tdyn.H100_OPTIN)
    assert got == lanes and 4 * C * got <= tdyn.H100_OPTIN


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gather_kernels_match_plain_versions_on_the_card():
    dev = _card()
    n0 = dict(cuda_build.LAUNCHES)
    for seed in (1, 2):
        for name, (wrapper, plain, args) in {**_cases(seed), **_edges(seed)}.items():
            args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
            got, want = wrapper(*args), plain(*args)
            torch.cuda.synchronize()
            if name.startswith("twosided"):
                err = float((got - want).abs().max() / want.abs().max())
                assert err <= NORMWISE, name
            elif name in ("vmem_loop", "block_slice", "row_dma", "take_fused", "dma_deep"):
                torch.testing.assert_close(got, want, rtol=ELEMENTWISE[0], atol=ELEMENTWISE[1])
            else:
                assert torch.equal(got, want), name
    with pytest.raises(RuntimeError, match="dyngather_smem_cap"):
        kdyn.smem_cap(torch.ones((8, 128), device=dev), kdyn.smem_optin(dev) + 16)
    torch.cuda.synchronize()
    launched = {k: cuda_build.LAUNCHES[k] - n0[k] for k in n0}
    assert launched["gather_onehot"] == 8 and launched["gather2_twosided"] == 6
    assert launched["gather2_onehot_pair"] == 4 and launched["gather2_window_pair"] == 4
    assert launched["dyngather_smem_cap"] == 2
    assert all(launched[k] == 2 for k in ("gather_vmem_loop", "gather_vmem_take",
                                          "gather_block_slice", "gather_row_dma",
                                          "gather2_take_fused", "gather2_dma_deep",
                                          "dyngather_take_along"))


@pytest.mark.cuda
def test_take_along_at_its_edges_on_the_card():
    """take_along bit-exact against the plain version on both of the
    kernel's paths: C = 65,536 (the direct L2 kernel), C = 15,000 (3 lanes a
    slice, the last slice of 2) and 5,000 (8), and T = 1,001 rows (not a
    multiple of a block's rows), each output on NaN-poisoned memory."""
    dev = _card()
    optin = kdyn.smem_optin(dev)
    paths = set()
    for seed in (1, 2):
        for C, T, shape, steps in ((65536, 300, "ne", 3), (15000, 1000, "ne", 2),
                                   (5000, 1000, "eq", 4), (2048, 1001, "ne", 5)):
            idx, table = (a.to(dev) for a in tdyn.inputs(C, T, shape, seed))
            at = torch.full(tuple(idx.shape), float("nan"), device=dev).data_ptr()
            got = kdyn.take_along(idx, table, steps)
            assert got.data_ptr() == at
            assert torch.equal(got, kdyn.take_along_torch(idx, table, steps)), (C, T)
            paths.add(kdyn.slice_lanes(C, optin) > 0)
    assert paths == {True, False}

