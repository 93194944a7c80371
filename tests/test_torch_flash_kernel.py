"""The flash-attention kernel wrapper (ops/cuda/flash_attention.py) and
the attention roofline, without JAX, so that the file also runs on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU the wrapper's checks, its dispatch to the plain
version and the roofline counts run; the ``cuda``-marked test skips.
"""

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda import flash_attention as fkernel
from of_spmm_tpu_torch.utils.roofline import (
    AttentionTraffic, detect_peak_bw, detect_peak_fp32, detect_peak_tensor16, detect_peak_tf32)

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


def _qkv(shape_q, shape_kv, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "d_too_wide", "noncontig", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros((2, 8, 16))
    k = v = torch.zeros((2, 12, 16))
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif bad == "d_too_wide":
        q, k, v = torch.zeros((1, 8, 257)), torch.zeros((1, 8, 257)), torch.zeros((1, 8, 257))
    elif bad == "noncontig":
        q = torch.zeros((2, 16, 8)).transpose(1, 2)
    else:
        v = torch.zeros((2, 11, 16))
    with pytest.raises((TypeError, ValueError), match="256" if bad == "d_too_wide" else None):
        fkernel.flash_attention(q, k, v)


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    q, k, v = _qkv((3, 40, 24), (3, 56, 24), seed=6)
    before = dict(cuda_build.LAUNCHES)
    for causal in (False, True):
        got = fkernel.flash_attention(q, k, v, causal)
        assert torch.equal(got, fkernel.flash_attention_torch(q, k, v, causal))
    assert cuda_build.LAUNCHES == before


def test_attention_traffic_at_bert_base_width():
    """B = 8, T = 512, 12 heads of 64: q, k, v, o once; 4 d operations per
    kept pair; causal keeps T (T + 1) / 2 pairs a head."""
    fp32 = AttentionTraffic(96, 512, 512, 64, 4, causal=False)
    assert fp32.bytes == 4 * 96 * 512 * 64 * 4 and fp32.flops == 4 * 96 * 512 * 512 * 64
    t, by = fp32.bound(3.35e12, 67e12)
    assert by == "operations" and abs(t - 0.0962) < 1e-4
    causal = AttentionTraffic(96, 512, 512, 64, 4, causal=True)
    assert causal.pairs == 512 * 513 // 2
    assert abs(causal.bound(3.35e12, 67e12)[0] - 0.0482) < 1e-4
    t, by = AttentionTraffic(96, 512, 512, 64, 2, causal=False).bound(3.35e12, 989e12)
    assert by == "bytes" and abs(t - 0.00751) < 1e-5
    # top-left causal with Tq > Tk: the rows past Tk see every key
    assert AttentionTraffic(1, 6, 4, 1, 4, causal=True).pairs == 1 + 2 + 3 + 4 + 4 + 4


def test_split_tf32_rounds_to_nearest_ties_away_and_keeps_float32():
    """hi = tf32(x) and lo have their 13 low bits clear; hi + lo is x
    within 2^-21 |x|; a tie (the 13 dropped bits exactly half an ulp)
    rounds away from zero, as cvt.rna.tf32.f32 does; inf and NaN stay."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(1024) * 1e-20,
        rng.standard_normal(1024) * 1e20]).astype(np.float32))
    hi, lo = fkernel.split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((x - (hi + lo)).abs() <= 2.0 ** -21 * x.abs()).all()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23])
    hi, lo = fkernel.split_tf32(ties)
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0]
    assert (hi + lo)[:3].tolist() == ties[:3].tolist()  # lo = the tie's half ulp, exact
    hi, _ = fkernel.split_tf32(torch.tensor([float("inf"), float("-inf"), float("nan")]))
    assert hi[:2].tolist() == [float("inf"), float("-inf")] and torch.isnan(hi[2])


def _outside_float32_bar(got, want):
    return int(((got - want).abs() > 1e-5 + 1e-4 * want.abs()).sum())


@pytest.mark.parametrize("d", [8, 64, 256])
@pytest.mark.parametrize("Tq,Tk", [(100, 100), (64, 160), (160, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_emulation_meets_the_float32_bar(d, Tq, Tk, causal):
    """Each product as three TF32 products (the float32 kernel's
    arithmetic) stays within 1e-5 + 1e-4|p| of the float32 plain version;
    one TF32 product each falls outside it, which is why the kernel takes
    three."""
    q, k, v = _qkv((2, Tq, d), (2, Tk, d), seed=d + Tq + Tk)
    want = fkernel.flash_attention_torch(q, k, v, causal)
    got = fkernel.flash_attention_tf32x3_torch(q, k, v, causal)
    assert _outside_float32_bar(got, want) == 0

    def tf32_once(a, b):
        return torch.matmul(fkernel.split_tf32(a.contiguous())[0],
                            fkernel.split_tf32(b.contiguous())[0])

    once = fkernel.flash_attention_torch(q, k, v, causal, matmul=tf32_once)
    assert _outside_float32_bar(once, want) > 0


def test_attention_bound_takes_the_tf32x3_term_for_float32():
    """On H100 SXM peaks the float32 bound at (96, 512, 64) is 3 x the
    operations over 495 TFLOP/s of TF32 (below the CUDA cores' 0.0962 ms);
    bfloat16 stays bound by bytes."""
    bw, fp32, tf32 = detect_peak_bw(H100), detect_peak_fp32(H100), detect_peak_tf32(H100)
    assert tf32 == 495e12
    t, by = AttentionTraffic(96, 512, 512, 64, 4, causal=False).bound(bw, fp32, tf32)
    assert by == "tf32x3" and abs(t - 0.0390) < 1e-4
    t, by = AttentionTraffic(96, 512, 512, 64, 4, causal=True).bound(bw, fp32, tf32)
    assert by == "tf32x3" and abs(t - 0.0196) < 1e-4
    bf16 = AttentionTraffic(96, 512, 512, 64, 2, causal=False)
    t, by = bf16.bound(bw, detect_peak_tensor16(H100))
    assert by == "bytes" and abs(t - 0.0075) < 1e-4
    # a short sequence moves more bytes than it computes on
    assert AttentionTraffic(96, 16, 16, 64, 4, causal=False).bound(bw, fp32, tf32)[1] == "bytes"
    assert detect_peak_tf32("NVIDIA H100 PCIe") == detect_peak_tensor16("NVIDIA H100 PCIe") / 2


@pytest.mark.cuda
def test_flash_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(9)
    launches = cuda_build.LAUNCHES["flash_attention"]
    calls = 0
    for dtype, (atol, rtol) in ((torch.float32, (1e-5, 1e-4)), (torch.bfloat16, (1e-2, 1e-2)),
                                (torch.float16, (1e-2, 1e-2))):
        for Tq, Tk, d in ((100, 100, 64), (128, 256, 32), (256, 128, 8), (64, 64, 256)):
            q = torch.randn((3, Tq, d), generator=gen).to(dev, dtype)
            k, v = (torch.randn((3, Tk, d), generator=gen).to(dev, dtype) for _ in range(2))
            for causal in (False, True):
                got = fkernel.flash_attention(q, k, v, causal)
                want = fkernel.flash_attention_torch(q, k, v, causal)
                torch.cuda.synchronize()
                calls += 1
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert cuda_build.LAUNCHES["flash_attention"] == launches + calls  # never the plain version


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_tensor_core_kernel_matches_plain_version_on_the_card(dtype):
    """bf16 / fp16 run the tensor-core kernel (mma.sync): every padded head
    width it instantiates, d % 8 != 0 (plain loads and stores), Tq != Tk
    both ways, ragged 64-row tiles, causal and not, within 1e-2 + 1e-2|p|;
    no keys give zeros (every warp's output goes through Q-tile rows that
    another warp's Q copy fills)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(11)
    launches = cuda_build.LAUNCHES["flash_attention"]
    calls = 0
    for d in (8, 40, 64, 80, 96, 100, 128, 160, 256, 7):
        for Tq, Tk in ((100, 100), (128, 256), (256, 128), (1, 70), (64, 1)):
            q = torch.randn((3, Tq, d), generator=gen).to(dev, dtype)
            k, v = (torch.randn((3, Tk, d), generator=gen).to(dev, dtype) for _ in range(2))
            for causal in (False, True):
                got = fkernel.flash_attention(q, k, v, causal)
                want = fkernel.flash_attention_torch(q, k, v, causal)
                torch.cuda.synchronize()
                calls += 1
                assert got.dtype == dtype
                torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    # no keys: every row has l = 0 and is zero, at every head width
    for d in (8, 64, 100, 256):
        q = torch.randn((3, 200, d), generator=gen).to(dev, dtype)
        empty = torch.empty((3, 0, d), device=dev, dtype=dtype)
        for causal in (False, True):
            got = fkernel.flash_attention(q, empty, empty, causal)
            torch.cuda.synchronize()
            calls += 1
            assert torch.equal(got, torch.zeros_like(q))
    assert cuda_build.LAUNCHES["flash_attention"] == launches + calls


@pytest.mark.cuda
def test_flash_float32_kernel_matches_plain_version_on_the_card():
    """float32 runs the 3xTF32 tensor-core kernel: every padded head width
    it instantiates, d % 4 != 0 (plain loads and stores), Tq != Tk both
    ways, ragged 64-row tiles, causal and not, within 1e-5 + 1e-4|p|; one
    launch per call; NaN carried as the plain version carries it; no keys
    give zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(12)
    for d in (7, 8, 40, 64, 80, 96, 100, 128, 160, 256):
        for Tq, Tk in ((100, 100), (128, 256), (256, 128), (1, 70), (64, 1)):
            q = torch.randn((3, Tq, d), generator=gen).to(dev)
            k, v = (torch.randn((3, Tk, d), generator=gen).to(dev) for _ in range(2))
            for causal in (False, True):
                launches = cuda_build.LAUNCHES["flash_attention"]
                got = fkernel.flash_attention(q, k, v, causal)
                want = fkernel.flash_attention_torch(q, k, v, causal)
                torch.cuda.synchronize()
                assert cuda_build.LAUNCHES["flash_attention"] == launches + 1
                assert got.dtype == torch.float32
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    # a NaN in K or V reaches every row that sees it, as in the plain version
    q, k, v = (torch.randn((2, 100, 64), generator=gen).to(dev) for _ in range(3))
    k[0, 5, 3] = float("nan")
    v[1, 7, 2] = float("nan")
    for causal in (False, True):
        got = fkernel.flash_attention(q, k, v, causal)
        want = fkernel.flash_attention_torch(q, k, v, causal)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
    # no keys: every row has l = 0 and is zero
    empty = torch.empty((2, 0, 64), device=dev)
    for causal in (False, True):
        got = fkernel.flash_attention(q, empty, empty, causal)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.zeros_like(q))
