"""The port's transformer encoder and its layers against the JAX package,
on the CPU, with weights carried by
``interop.transformer_params_from_numpy``:

- ``Linear``, ``LayerNorm`` (population variance), ``Embedding`` (a zero
  row for an index outside the table), ``gelu`` (the tanh form) and
  ``Dropout`` (identity unless train, which needs a generator);
- ``TransformerEncoder`` at ``bert_tiny`` widths with 2 layers: hidden
  states, CLS logits with ``n_classes``, and token ids >= vocab with
  T > max_len (zero rows from the gather, as in JAX);
- entry points on the card unless asked for the CPU.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu import nn as jnn
from of_spmm_tpu.models.transformer import TransformerEncoder as JTransformerEncoder
from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.interop import transformer_params_from_numpy
from of_spmm_tpu_torch.models import TransformerEncoder, bert_tiny
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

TINY2 = dict(vocab_size=1000, max_len=128, embed_dim=128, num_heads=4, num_layers=2,
             mlp_dim=512)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_linear_layernorm_embedding_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    lin = jnn.Linear(16, 7)
    lp = lin.init(jax.random.key(0))
    tlin = onn.Linear(16, 7, device="cpu")
    tlin.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in lp.items()})
    np.testing.assert_allclose(tlin(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(lin.apply(lp, jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    ln = jnn.LayerNorm((16,))
    p = {"gamma": rng.standard_normal(16).astype(np.float32),
         "beta": rng.standard_normal(16).astype(np.float32)}
    tln = onn.LayerNorm(16, device="cpu")
    tln.load_state_dict({k: torch.from_numpy(a) for k, a in p.items()})
    xs = x * 30 + 5  # a mean and spread far from 0 and 1
    np.testing.assert_allclose(tln(torch.from_numpy(xs)).detach().numpy(),
                               np.asarray(ln.apply(p, jnp.asarray(xs))), rtol=RTOL, atol=ATOL)
    emb = jnn.Embedding(10, 4)
    ep = emb.init(jax.random.key(1))
    temb = onn.Embedding(10, 4, device="cpu")
    temb.load_state_dict({"weight": torch.from_numpy(np.array(ep["weight"]))})
    idx = np.array([[0, 9, 10], [-1, 3, 1 << 20]], dtype=np.int32)
    got = temb(torch.from_numpy(idx)).detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(emb.apply(ep, jnp.asarray(idx))))
    assert not got[0, 2].any() and not got[1, 0].any() and not got[1, 2].any()


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = onn.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnn.gelu(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    erf_form = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf_form).max() > 1e-4  # not torch's default (erf) form


def test_dropout():
    x = torch.ones((64, 64))
    drop = onn.Dropout(0.25)
    assert drop(x) is x
    with pytest.raises(ValueError, match="generator"):
        drop(x, train=True)
    y = drop(x, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.65 < float(kept.float().mean()) < 0.85
    assert torch.equal(y, drop(x, train=True, generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("case", ["hidden", "cls_logits", "out_of_range"])
def test_encoder_matches_jax(case):
    cfg = dict(TINY2)
    B, T = 2, 64
    if case == "cls_logits":
        cfg["n_classes"] = 5
    if case == "out_of_range":
        cfg["max_len"], T = 48, 56  # positions 48..55 give zero rows
    jmodel = JTransformerEncoder(**cfg)
    params = jmodel.init(jax.random.key(3))
    model = TransformerEncoder(**cfg, device="cpu")
    model.load_state_dict(transformer_params_from_numpy(_np_tree(params)))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg["vocab_size"], (B, T)).astype(np.int32)
    if case == "out_of_range":
        tokens[0, 3], tokens[1, 7], tokens[1, 9] = cfg["vocab_size"], cfg["vocab_size"] + 77, -2
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_carried_state_dict_covers_every_parameter():
    cfg = dict(TINY2, n_classes=3)
    params = _np_tree(JTransformerEncoder(**cfg).init(jax.random.key(5)))
    sd = transformer_params_from_numpy(params)
    model = TransformerEncoder(**cfg, device="cpu")
    assert sorted(sd) == sorted(model.state_dict())
    for key, t in model.state_dict().items():
        assert sd[key].shape == t.shape, key
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())
    with pytest.raises(KeyError):
        transformer_params_from_numpy({**params, "block_7": params["block_0"]})


def test_seeded_init_and_configs():
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    a, b = bert_tiny(device="cpu", generator=gen()), bert_tiny(device="cpu", generator=gen())
    for (ka, pa), (kb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(pa, pb)
    assert (a.num_layers, a.embed_dim, a.num_heads, a.mlp_dim) == (4, 128, 4, 512)
    defaults = {k: p.default for k, p in inspect.signature(TransformerEncoder).parameters.items()
                if k not in ("device", "generator")}
    base = JTransformerEncoder()
    assert defaults == {k: getattr(base, k) for k in defaults}
    assert (base.num_layers, base.embed_dim, base.num_heads, base.mlp_dim, base.max_len,
            base.vocab_size) == (12, 768, 12, 3072, 512, 30522)
    bound = 1 / np.sqrt(128)
    w = a.blocks[0].fc1.w.detach()
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound / np.sqrt(3)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert next(bert_tiny().parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bert_tiny()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            onn.MultiheadAttention(8, 2)
