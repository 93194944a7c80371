"""The port's attention path against the JAX package, on the CPU.

- dense ``scaled_dot_product_attention`` vs JAX: causal, a boolean mask
  with a fully masked row (NaN in both), and Tq != Tk;
- ``ops.flash_attention`` (its kernel's plain version on CPU tensors) vs
  JAX ``flash_attention(interpret=True)``, as the JAX package's own tests
  run it: their shapes, T = 100 at the default blocks, Tq != Tk causal,
  d = 8, 32, 64; its q/k/v gradients vs ``jax.grad``; a bf16 case against
  the port's dense oracle;
- ``nn.MultiheadAttention`` (dense and flash) vs JAX with parameters
  carried by ``interop.mha_params_from_numpy``;
- the refusals.

The kernel wrapper's own checks, and the CUDA kernel on the card, are in
tests/test_torch_flash_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.nn.attention import MultiheadAttention as JMultiheadAttention
from of_spmm_tpu.nn.attention import scaled_dot_product_attention as jsdpa
from of_spmm_tpu.ops.pallas.flash_attention import flash_attention as jflash
from of_spmm_tpu_torch.interop import mha_params_from_numpy
from of_spmm_tpu_torch.nn import MultiheadAttention, scaled_dot_product_attention
from of_spmm_tpu_torch.ops.flash_attention import flash_attention
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

FLASH_TOL = 2e-5  # tests/test_flash_attention.py's bar
GRAD_TOL = 2e-4


def _qkv(shape_q, shape_kv, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(dtype),
            rng.standard_normal(shape_kv).astype(dtype),
            rng.standard_normal(shape_kv).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", ["causal", "mask", "cross_causal"])
def test_dense_attention_matches_jax(case):
    Tq, Tk = (24, 40) if case == "cross_causal" else (32, 32)
    q, k, v = _qkv((2, 3, Tq, 16), (2, 3, Tk, 16), seed=1)
    mask = None
    if case == "mask":
        mask = np.random.default_rng(2).random((Tq, Tk)) < 0.7
        mask[5] = False  # a row that sees no key: NaN in both
    kw = dict(is_causal=case != "mask")
    want = np.asarray(jsdpa(*map(jnp.asarray, (q, k, v)),
                            mask=None if mask is None else jnp.asarray(mask), **kw))
    got = scaled_dot_product_attention(*_t(q, k, v),
                                       mask=None if mask is None else torch.from_numpy(mask),
                                       **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "mask":
        assert np.isnan(got[:, :, 5]).all() and np.isnan(want[:, :, 5]).all()
        assert np.isfinite(np.delete(got, 5, axis=2)).all()


# (B, H, Tq, Tk, d, block_q, block_k, causal)
FLASH_CASES = {
    "T128": (2, 3, 128, 128, 128, 128, 128, False),
    "T128_causal": (2, 3, 128, 128, 128, 128, 128, True),
    "T384": (2, 3, 384, 384, 128, 128, 128, False),
    "T384_causal": (2, 3, 384, 384, 128, 128, 128, True),
    "T100_default_blocks": (2, 2, 100, 100, 64, 256, 256, False),
    "T100_default_blocks_causal": (2, 2, 100, 100, 64, 256, 256, True),
    "Tq128_Tk256_causal": (1, 2, 128, 256, 32, 128, 128, True),
    "Tq256_Tk128_causal": (1, 2, 256, 128, 32, 128, 128, True),
    "d8": (2, 4, 64, 64, 8, 256, 256, True),
    "d32": (2, 4, 64, 64, 32, 256, 256, False),
    "d64": (2, 4, 64, 64, 64, 256, 256, True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_matches_jax(case):
    B, H, Tq, Tk, d, bq, bk, causal = FLASH_CASES[case]
    q, k, v = _qkv((B, H, Tq, d), (B, H, Tk, d), seed=3)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), is_causal=causal, block_q=bq,
                             block_k=bk, interpret=True))
    got = flash_attention(*_t(q, k, v), is_causal=causal, block_q=bq, block_k=bk)
    assert got.shape == (B, H, Tq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_low_precision_matches_dense_oracle(dtype):
    """P is rounded to v's type before P v, and the dense oracle rounds
    its softmax weights the same way: the two agree to the type's
    precision."""
    q, k, v = (t.to(dtype) for t in _t(*_qkv((2, 2, 96, 32), (2, 2, 96, 32), seed=4)))
    for causal in (False, True):
        got = flash_attention(q, k, v, is_causal=causal)
        want = scaled_dot_product_attention(q, k, v, is_causal=causal)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_flash_grads_match_jax():
    q, k, v = _qkv((1, 2, 128, 128), (1, 2, 128, 128), seed=5)

    def jloss(q, k, v):
        return jnp.sum(jflash(q, k, v, is_causal=True, block_q=128, block_k=128,
                              interpret=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    (flash_attention(tq, tk, tv, is_causal=True, block_q=128, block_k=128) ** 2).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_refusals():
    q, k, v = _t(*_qkv((1, 1, 100, 16), (1, 1, 100, 16)))
    with pytest.raises(ValueError, match="divisible") as got:
        flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError) as want:
        jflash(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), block_q=64, block_k=64,
               interpret=True)
    assert str(got.value) == str(want.value)
    mha = MultiheadAttention(32, 4, flash=True, device="cpu")
    with pytest.raises(ValueError, match="is_causal"):
        mha(torch.zeros((1, 8, 32)), mask=torch.ones((8, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="divisible"):
        MultiheadAttention(30, 4, device="cpu")
    with pytest.raises(ValueError):
        JMultiheadAttention(30, 4)


def test_head_split_view_reads_the_right_memory():
    """MultiheadAttention hands flash a (B, H, T, hd) transposed view; the
    result equals that of the same values laid out contiguously."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 64, 4, 8))
                         .astype(np.float32))
    view = x.transpose(1, 2)
    assert not view.is_contiguous()
    got = flash_attention(view, view, view, is_causal=True)
    want = flash_attention(*(view.contiguous(),) * 3, is_causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["dense", "dense_mask", "flash", "flash_cross"])
def test_mha_matches_jax(case):
    E, H, B, T = 32, 4, 2, 128
    flash = case.startswith("flash")
    jmha = JMultiheadAttention(E, H, flash=flash)
    params = jmha.init(jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mha = MultiheadAttention(E, H, flash=flash, device="cpu")
    mha.load_state_dict(mha_params_from_numpy(np_params))
    if case == "dense_mask":
        mask = rng.random((T, T)) < 0.8
        np.fill_diagonal(mask, True)
        want = jmha.apply(params, jnp.asarray(x), mask=jnp.asarray(mask))
        got = mha(torch.from_numpy(x), mask=torch.from_numpy(mask))
    elif case == "flash_cross":
        kv = rng.standard_normal((B, 2 * T, E)).astype(np.float32)
        want = jmha.apply(params, jnp.asarray(x), jnp.asarray(kv), is_causal=True)
        got = mha(torch.from_numpy(x), torch.from_numpy(kv), is_causal=True)
    else:
        want = jmha.apply(params, jnp.asarray(x), is_causal=True)
        got = mha(torch.from_numpy(x), is_causal=True)
    with torch.no_grad():
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_mha_flash_matches_dense_with_grads():
    """The flash switch changes the core, not the result or its
    gradients (parameters and input)."""
    torch.manual_seed(0)
    dense = MultiheadAttention(32, 4, device="cpu", generator=torch.Generator().manual_seed(1))
    flash = MultiheadAttention(32, 4, flash=True, device="cpu")
    flash.load_state_dict(dense.state_dict())
    x = torch.randn((2, 64, 32), generator=torch.Generator().manual_seed(2))
    outs, grads = [], []
    for mod in (dense, flash):
        xi = x.clone().requires_grad_(True)
        o = mod(xi, is_causal=True)
        (o ** 2).sum().backward()
        outs.append(o.detach())
        grads.append([xi.grad] + [p.grad for p in mod.parameters()])
    torch.testing.assert_close(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
