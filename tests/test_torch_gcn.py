"""The port's GCN against the JAX GCN: same graph, same features (numpy,
seeded), same weights carried over by gcn_params_from_numpy; logits must
agree at rtol 1e-4 / atol 1e-5.

Cases: cora through the default operator (binned, relabeled) and a small
power-law graph with a forced small tier_size (tiered, with a cold tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.data.graphs import GraphConfig as JGraphConfig
from of_spmm_tpu.data.graphs import load_graph as jload_graph
from of_spmm_tpu.data.graphs import synthetic_edges as jsynthetic_edges
from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.sparse.formats import COO as JCOO
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch.data.graphs import load_graph, random_features
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.tiled import TieredEll
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _cora():
    csr, cfg = load_graph("cora", symmetrize=True)
    jcsr, _ = jload_graph("cora", symmetrize=True)
    x, _ = random_features(cfg)
    return (normalized_adjacency(csr), jnormalized_adjacency(jcsr), x,
            (cfg.feature_dim, 32, cfg.n_classes), None)


def _powerlaw():
    n = 600
    src, dst = jsynthetic_edges(JGraphConfig("pl", n, 4000, power_law=True), seed=5)
    a = CSR.from_coo(COO.from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]), n))
    b = JCSR.from_coo(JCOO.from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]), n))
    x = np.random.default_rng(6).standard_normal((n, 24)).astype(np.float32)
    return normalized_adjacency(a), jnormalized_adjacency(b), x, (24, 48, 48, 5), 256


@pytest.mark.parametrize("case", ["cora", "powerlaw_tiered"])
def test_gcn_logits_match_jax(case):
    a_hat, ja_hat, x, dims, tier_size = _cora() if case == "cora" else _powerlaw()
    op = make_operator(a_hat, tier_size=tier_size, device="cpu")
    jop = jmake_operator(ja_hat, tier_size=tier_size, place=False)
    if case == "cora":
        assert op.relabeled and not isinstance(op.binned, TieredEll)
    else:
        assert isinstance(op.binned, TieredEll) and op.binned.tiers[0].tier == -1
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    want = np.asarray(jax.jit(lambda p, xx: jmodel.apply(p, jop, xx, impl="xla"))(
        params, jnp.asarray(x)))

    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: plain kernel versions
            got = model(op, torch.from_numpy(x), impl=impl)
            assert got.shape == (x.shape[0], dims[-1])
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gcn_parameters_and_seed():
    g = torch.Generator().manual_seed(0)
    a = GCN((8, 16, 3), device="cpu", generator=g)
    b = GCN((8, 16, 3), device="cpu", generator=torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in a.parameters()] == [(8, 16), (16,), (16, 3), (3,)]
    assert list(a.state_dict()) == ["layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b"]
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    limit = np.sqrt(6.0 / (8 + 16))
    assert float(a.layers[0].w.detach().abs().max()) <= limit


def test_gcn_forward_with_grad_trains():
    """With grad enabled the forward records a graph (the refusal of the
    forward-only slices is gone): the loss has a grad_fn, every parameter
    gets a finite grad, and an optimizer step lowers the loss."""
    csr = CSR.from_dense(np.eye(4, dtype=np.float32) + np.eye(4, k=1, dtype=np.float32))
    op = make_operator(normalized_adjacency(csr), device="cpu")
    model = GCN((3, 4, 2), device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32))
    y = torch.tensor([0, 1, 1, 0])
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = model.loss_fn(op, x, y)
    assert loss.grad_fn is not None
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    opt.step()
    with torch.no_grad():
        assert float(model.loss_fn(op, x, y)) < float(loss)
        assert model(op, torch.ones(4, 3)).shape == (4, 2)


def test_interop_rejects_wrong_keys():
    with pytest.raises(KeyError):
        gcn_params_from_numpy({"layer_1": {"w": np.zeros((2, 2)), "b": np.zeros(2)}})
