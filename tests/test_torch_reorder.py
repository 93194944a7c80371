"""The port's locality reorder against the JAX package, on the CPU.

- ``bfs_order``, ``label_prop_order`` and ``matching_order``: the same
  permutations on the same CSR, with the native library and without it
  (``_lib`` forced to None in both packages: the numpy fallback).
- ``reorder_locality``: the same relabeled CSR arrays and permutations for
  every method; ``locality_stats``: the same dicts; a rectangular matrix
  and an unknown method raise ``ValueError`` in both.
- ``make_operator(reorder=...)`` on panels, fused and ranges: forward and
  the backward (``impl="torch"``) against the JAX operator with the same
  reorder (Pallas, interpret mode), and a 2-layer GCN on a reordered
  operator against the JAX GCN.
- The layouts the port refuses ``reorder=`` on (binned, tiered, expansion,
  auto), beside the JAX package, which ignores it there.

Tolerance: rtol 1e-4, atol 1e-5 * max|want| + 1e-5; permutations and plan
arrays exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu import native as jnative
from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.ops.autograd import spmm as jspmm
from of_spmm_tpu.sparse import reorder as jreorder
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator, spmm
from of_spmm_tpu_torch.sparse import reorder
from of_spmm_tpu_torch.sparse.formats import CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
REORDER_LAYOUTS = ("panels", "fused", "ranges")


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


def _community_graph(n=320, n_comm=8, p_in=0.08, p_out=0.004, seed=0, values="normalized"):
    """A symmetric stochastic block model with its ids shuffled: the
    structure the reorder recovers. ``values``: "normalized" (D^-1/2 A
    D^-1/2, which the engines plan as rank-1) or "random" (symmetric
    random values)."""
    rng = np.random.default_rng(seed)
    comm = np.sort(rng.integers(0, n_comm, n))
    dense = (rng.random((n, n)) < p_out).astype(np.float32)
    same = comm[:, None] == comm[None, :]
    dense[same] = (rng.random(int(same.sum())) < p_in).astype(np.float32)
    np.fill_diagonal(dense, 0)
    dense = np.maximum(dense, dense.T)
    perm = rng.permutation(n)
    dense = dense[perm][:, perm]
    if values == "normalized":
        deg = dense.sum(1)
        with np.errstate(divide="ignore"):
            s = np.where(deg > 0, deg ** -0.5, 0.0)
        return (dense * s[:, None] * s[None, :]).astype(np.float32)
    r = rng.random((n, n)).astype(np.float32)
    return (dense * (r + r.T)).astype(np.float32)


def _pair(dense):
    return JCSR.from_dense(dense), CSR.from_dense(dense)


@pytest.fixture(params=["native", "fallback"])
def native_mode(request, monkeypatch):
    """Both packages with their native library, or both without it."""
    if request.param == "fallback":
        monkeypatch.setattr(jnative, "_lib", lambda: None)
        monkeypatch.setattr(native, "_lib", lambda: None)
    assert native.available() == jnative.available()
    return request.param


@pytest.mark.parametrize("fn, kwargs", [
    ("bfs_order", {}),
    ("label_prop_order", {}),
    ("matching_order", {}),                  # n < coarse_n: the coarsest order alone
    ("matching_order", {"coarse_n": 32}),    # several contraction levels
    ("matching_order", {"coarse_n": 8, "max_levels": 2}),
])
def test_orders_match_jax(fn, kwargs, native_mode):
    jc, tc = _pair(_community_graph(seed=1))
    want = np.asarray(getattr(jreorder, fn)(jc, **kwargs))
    got = getattr(reorder, fn)(tc, **kwargs)
    assert got.dtype == np.int64
    assert np.array_equal(np.sort(got), np.arange(tc.shape[0]))
    assert np.array_equal(got, want)


def test_native_and_fallback_matching_differ(monkeypatch):
    """The two matching algorithms (Jaccard-weighted greedy native pass,
    mutual numpy pass) give different permutations on the same graph, in
    the JAX package and in the port alike: an ordering depends on whether
    the host built the native library."""
    if not native.available():
        pytest.skip("no native toolchain: only the fallback runs here")
    jc, tc = _pair(_community_graph(seed=2))
    nat = reorder.matching_order(tc, coarse_n=32)
    assert np.array_equal(nat, np.asarray(jreorder.matching_order(jc, coarse_n=32)))
    monkeypatch.setattr(jnative, "_lib", lambda: None)
    monkeypatch.setattr(native, "_lib", lambda: None)
    fb = reorder.matching_order(tc, coarse_n=32)
    assert np.array_equal(fb, np.asarray(jreorder.matching_order(jc, coarse_n=32)))
    assert not np.array_equal(nat, fb)


@pytest.mark.parametrize("method", ["match", "hem", True, "lp", "bfs+lp", "bfs", "identity"])
def test_reorder_locality_matches_jax(method):
    dense = _community_graph(seed=3, values="random")
    jc, tc = _pair(dense)
    jrel, jofn, jnfo = jreorder.reorder_locality(jc, method)
    rel, ofn, nfo = reorder.reorder_locality(tc, method)
    for a, b in ((rel.indptr, jrel.indptr), (rel.cols, jrel.cols), (rel.vals, jrel.vals),
                 (ofn, jofn), (nfo, jnfo)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(nfo[ofn], np.arange(tc.shape[0]))
    # P A P^T: entry (i, j) of the relabeled matrix is A[ofn[i], ofn[j]]
    np.testing.assert_array_equal(rel.to_dense(), dense[ofn][:, ofn])


@pytest.mark.parametrize("R, window", [(128, 12288), (64, 128), (32, 64)])
def test_locality_stats_matches_jax(R, window):
    jc, tc = _pair(_community_graph(seed=4))
    jrel, _, _ = jreorder.reorder_locality(jc, "match")
    rel, _, _ = reorder.reorder_locality(tc, "match")
    for j, t in ((jc, tc), (jrel, rel)):
        assert reorder.locality_stats(t, R=R, window=window) == \
            jreorder.locality_stats(j, R=R, window=window)


def test_reorder_raises_like_jax():
    rng = np.random.default_rng(8)
    jc, tc = _pair((rng.random((10, 20)) < 0.3).astype(np.float32))
    for mod, c in ((jreorder, jc), (reorder, tc)):
        with pytest.raises(ValueError, match="square"):
            mod.reorder_locality(c)
    jc, tc = _pair(_community_graph(n=40, seed=9))
    for mod, c in ((jreorder, jc), (reorder, tc)):
        with pytest.raises(ValueError, match="unknown reorder method"):
            mod.reorder_locality(c, "metis5")


@pytest.mark.parametrize("layout", REORDER_LAYOUTS)
@pytest.mark.parametrize("method, values", [("match", "normalized"), ("bfs", "random"),
                                            ("lp", "normalized"), (True, "random")])
def test_operator_reorder_matches_jax(layout, method, values):
    """make_operator(reorder=...) on the engine layouts: the same
    permutation and relabeled plan as the JAX operator, the forward and
    the backward (the engine on the transpose plan) against JAX's."""
    rng = np.random.default_rng(10)
    dense = _community_graph(seed=5, values=values)
    jc, tc = _pair(dense)
    jop = jmake_operator(jc, layout=layout, place=False, reorder=method)
    op = make_operator(tc, layout=layout, reorder=method, device="cpu")
    assert op.relabeled and op.transpose_aliased
    assert np.array_equal(op.old_from_new.numpy(), np.asarray(jop.old_from_new))
    assert np.array_equal(op.new_from_old.numpy(), np.asarray(jop.new_from_old))
    x = rng.standard_normal((dense.shape[1], 8)).astype(np.float32)
    w = rng.standard_normal((dense.shape[0], 8)).astype(np.float32)
    want = np.asarray(jspmm(jop, jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda xx: jnp.sum(jspmm(jop, xx) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = spmm(op, xt, impl="torch")
    (y * torch.from_numpy(w)).sum().backward()
    _close(y.detach().numpy(), want)
    _close(xt.grad.numpy(), want_g)
    _close(y.detach().numpy(), dense @ x)
    _close(xt.grad.numpy(), dense.T @ w)


@pytest.mark.parametrize("layout", REORDER_LAYOUTS)
def test_gcn_on_reordered_operator_matches_jax(layout):
    """A 2-layer GCN on a shuffled community graph's normalized adjacency
    through make_operator(reorder="match"), weights carried over from the
    JAX GCN on the JAX operator with the same reorder."""
    rng = np.random.default_rng(11)
    pattern = (_community_graph(seed=6) > 0).astype(np.float32)
    a_hat = normalized_adjacency(CSR.from_dense(pattern))
    ja_hat = jnormalized_adjacency(JCSR.from_dense(pattern))
    op = make_operator(a_hat, layout=layout, reorder="match", device="cpu")
    jop = jmake_operator(ja_hat, layout=layout, place=False, reorder="match")
    dims = (16, 8, 4)
    x = rng.standard_normal((pattern.shape[0], dims[0])).astype(np.float32)
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    want = np.asarray(jmodel.apply(params, jop, jnp.asarray(x)))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = model(op, torch.from_numpy(x)).numpy()
        plain = model(op, torch.from_numpy(x), impl="torch").numpy()
    assert got.shape == (pattern.shape[0], dims[-1])
    _close(got, want)
    _close(plain, want)


@pytest.mark.parametrize("layout", ["binned", "tiered", "expansion", "auto"])
def test_reorder_refused_where_jax_ignores_it(layout):
    """The port raises ValueError naming the three layouts reorder applies
    to; the JAX package builds the same operator as without reorder= (a
    quirk of the reference the port does not copy)."""
    dense = _community_graph(n=128, seed=7)
    jc, tc = _pair(dense)
    with pytest.raises(ValueError, match="panels|fused|ranges"):
        make_operator(tc, layout=layout, reorder="match", device="cpu")
    jop = jmake_operator(jc, layout=layout, place=False, reorder="match")
    jplain = jmake_operator(jc, layout=layout, place=False)
    for a, b in ((jop.old_from_new, jplain.old_from_new), (jop.new_from_old, jplain.new_from_old)):
        assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b))
    x = np.random.default_rng(12).standard_normal((dense.shape[1], 4)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jspmm(jop, jnp.asarray(x))),
                                  np.asarray(jspmm(jplain, jnp.asarray(x))))
