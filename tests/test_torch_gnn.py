"""The GNN convolutions, GraphSAGE and GAT against the JAX package, on the
CPU: outputs and the grads (every parameter and the input features) of
a summed loss sum(out * ct / n_nodes), with the JAX parameters carried over by the
interop converters. On cora: GCNConv on the normalized adjacency
(binned, relabeled), SAGEConv and GraphSAGE on the mean adjacency (a
non-symmetric operator: built transpose plan), GATConv and GAT (heads 4)
on the pattern's COO, GINConv on the unnormalized adjacency.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.data.graphs import load_graph as jload_graph
from of_spmm_tpu.models.gat import GAT as JGAT
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.models.sage import GraphSAGE as JGraphSAGE
from of_spmm_tpu.models.sage import mean_adjacency as jmean_adjacency
from of_spmm_tpu.nn import gnn as jgnn
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu_torch import interop
from of_spmm_tpu_torch.data.graphs import load_graph, random_features
from of_spmm_tpu_torch.models import GAT, GraphSAGE, mean_adjacency, normalized_adjacency
from of_spmm_tpu_torch.nn import GATConv, GCNConv, GINConv, SAGEConv
from of_spmm_tpu_torch.ops import make_operator
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

HIDDEN = 16


@functools.lru_cache(maxsize=None)
def _cora(kind: str):
    """Both packages' operators of cora's normalized ("gcn"), mean
    ("sage") or unnormalized ("gin") adjacency, and seeded features."""
    csr, cfg = load_graph("cora", symmetrize=True)
    jcsr, _ = jload_graph("cora", symmetrize=True)
    prep = {"gcn": (normalized_adjacency, jnormalized_adjacency),
            "sage": (mean_adjacency, jmean_adjacency), "gin": (lambda a: a, lambda a: a)}[kind]
    op = make_operator(prep[0](csr), device="cpu")
    jop = jmake_operator(prep[1](jcsr), place=False)
    x, _ = random_features(cfg)
    return op, jop, x, cfg


def _check(module, jparams, jloss_of, op, x, impls=("torch", "cuda"), layers=""):
    """``module``'s output and grads against JAX's for the loss
    sum(out * ct), ct normal over the node count (a mean over nodes, as a
    training loss is); ``jloss_of(params, x, ct)`` is the JAX loss;
    ``layers`` names the model's module list of the JAX ``layer_i``."""
    with torch.no_grad():
        shape = tuple(module(op, torch.from_numpy(x)).shape)
    ct = (np.random.default_rng(5).standard_normal(shape) / shape[0]).astype(np.float32)
    (jloss, (jgp, jgx)) = jax.jit(jax.value_and_grad(jloss_of, argnums=(0, 1)))(
        jparams, jnp.asarray(x), jnp.asarray(ct))
    jflat = dict(_flatten(jgp, layers))
    for impl in impls:  # "cuda" on CPU tensors: the kernels' plain versions
        module.zero_grad()
        xt = torch.from_numpy(x).requires_grad_()
        loss = (module(op, xt, impl=impl) * torch.from_numpy(ct)).sum()
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
        grads = {name: p.grad for name, p in module.named_parameters()}
        assert sorted(grads) == sorted(jflat)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jflat[name]), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def _flatten(tree, layers: str, prefix: str = ""):
    """A JAX params tree as state_dict names: ``layer_i`` becomes
    ``<layers>.i``."""
    for key, leaf in tree.items():
        name = f"{layers}.{key[6:]}" if key.startswith("layer_") else key
        if isinstance(leaf, dict):
            yield from _flatten(leaf, layers, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


CONVS = {
    "gcn": (lambda fi, fo: GCNConv(fi, fo, device="cpu"),
            lambda fi, fo: jgnn.GCNConv(fi, fo), interop.gcn_conv_params_from_numpy),
    "sage": (lambda fi, fo: SAGEConv(fi, fo, device="cpu"),
             lambda fi, fo: jgnn.SAGEConv(fi, fo), interop.sage_conv_params_from_numpy),
    "gat": (lambda fi, fo: GATConv(fi, fo, heads=4, device="cpu"),
            lambda fi, fo: jgnn.GATConv(fi, fo, heads=4), interop.gat_conv_params_from_numpy),
    "gat_mean": (lambda fi, fo: GATConv(fi, fo, heads=4, concat_heads=False, device="cpu"),
                 lambda fi, fo: jgnn.GATConv(fi, fo, heads=4, concat_heads=False),
                 interop.gat_conv_params_from_numpy),
    "gin": (lambda fi, fo: GINConv(fi, 2 * fo, fo, device="cpu"),
            lambda fi, fo: jgnn.GINConv(fi, 2 * fo, fo), interop.gin_conv_params_from_numpy),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_matches_jax(name):
    op, jop, x, cfg = _cora({"gat": "gcn", "gat_mean": "gcn"}.get(name, name))
    make, jmake, convert = CONVS[name]
    conv, jconv = make(cfg.feature_dim, HIDDEN), jmake(cfg.feature_dim, HIDDEN)
    jparams = jconv.init(jax.random.key(1))
    if name == "gin":
        # a nonzero eps, so its grad and the (1 + eps) path show. Sum
        # aggregation makes pre-activations of ~10; one within float32's
        # rounding of the ReLU kink would flip its derivative between the
        # packages (at eps = 0.25 one sits at 8.7e-7), so the case holds a
        # margin from the kink first
        jparams = {**jparams, "eps": jnp.asarray(-0.5, jnp.float32)}
        p = jax.tree.map(np.asarray, jparams)
        agg = np.asarray(jgnn.spmm(jop, jnp.asarray(x), impl="xla"))
        u = ((1 + p["eps"]) * x + agg) @ p["w1"] + p["b1"]
        assert np.abs(u).min() > 1e-6 * np.abs(u).max()
    conv.load_state_dict(convert(jax.tree.map(np.asarray, jparams)))
    impls = ("torch",) if name.startswith("gat") else ("torch", "cuda")  # GAT runs no SpMM
    _check(conv, jparams,
           lambda p, xx, ct: jnp.sum(jconv.apply(p, jop, xx, impl="xla") * ct), op, x, impls)


def test_graphsage_matches_jax():
    op, jop, x, cfg = _cora("sage")
    assert not op.transpose_aliased and op.relabeled
    dims = (cfg.feature_dim, HIDDEN, HIDDEN, cfg.n_classes)
    jmodel = JGraphSAGE(feature_dims=dims)
    jparams = jmodel.init(jax.random.key(2))
    model = GraphSAGE(dims, device="cpu")
    model.load_state_dict(interop.sage_params_from_numpy(jax.tree.map(np.asarray, jparams)))
    _check(model, jparams,
           lambda p, xx, ct: jnp.sum(jmodel.apply(p, jop, xx, impl="xla") * ct), op, x,
           layers="layers")


def test_gat_matches_jax():
    op, jop, x, cfg = _cora("gcn")
    dims = (cfg.feature_dim, 8, cfg.n_classes)
    jmodel = JGAT(feature_dims=dims, heads=4)
    jparams = jmodel.init(jax.random.key(3))
    model = GAT(dims, heads=4, device="cpu")
    model.load_state_dict(interop.gat_params_from_numpy(jax.tree.map(np.asarray, jparams)))
    _check(model, jparams, lambda p, xx, ct: jnp.sum(jmodel.apply(p, jop, xx) * ct), op, x,
           impls=("torch",), layers="convs")
    y = np.random.default_rng(4).integers(0, cfg.n_classes, x.shape[0]).astype(np.int32)
    jloss = jax.jit(jmodel.loss_fn)(jparams, jop, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(model.loss_fn(op, torch.from_numpy(x), torch.from_numpy(y)).item(),
                               float(jloss), rtol=RTOL)


@pytest.mark.parametrize("convert,good", [
    (interop.gcn_conv_params_from_numpy, {"w": np.zeros((2, 2)), "b": np.zeros(2)}),
    (interop.sage_conv_params_from_numpy,
     {"w_self": np.zeros((2, 2)), "w_neigh": np.zeros((2, 2)), "b": np.zeros(2)}),
    (interop.gat_conv_params_from_numpy,
     {"w": np.zeros((2, 4)), "a_src": np.zeros((2, 2)), "a_dst": np.zeros((2, 2))}),
    (interop.gin_conv_params_from_numpy,
     {"eps": np.zeros(()), "w1": np.zeros((2, 3)), "b1": np.zeros(3), "w2": np.zeros((3, 2)),
      "b2": np.zeros(2)}),
    (interop.sage_params_from_numpy,
     {"layer_0": {"w_self": np.zeros((2, 2)), "w_neigh": np.zeros((2, 2)), "b": np.zeros(2)}}),
    (interop.gat_params_from_numpy,
     {"layer_0": {"w": np.zeros((2, 4)), "a_src": np.zeros((2, 2)), "a_dst": np.zeros((2, 2)),
                  "b": np.zeros(4)}}),
])
def test_interop_converters_reject_wrong_keys(convert, good):
    assert len(convert(good)) >= len(good)
    nested = "layer_0" in good
    inner = good["layer_0"] if nested else good
    missing = dict(list(inner.items())[1:])
    extra = {**inner, "w_extra": np.zeros(2)}
    for bad in (missing, extra):
        with pytest.raises(KeyError):
            convert({"layer_0": bad} if nested else bad)
    if nested:
        with pytest.raises(KeyError):
            convert({"layer_1": inner})
