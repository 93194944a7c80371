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
from of_spmm_tpu_torch.utils.roofline import AttentionTraffic


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
    both ways, ragged 64-row tiles, causal and not, within 1e-2 + 1e-2|p|."""
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
    assert cuda_build.LAUNCHES["flash_attention"] == launches + calls
