"""The port's distributed SpMM (shard-mesh form) against the JAX package's.

The port runs S shards on ``ShardMesh(["cpu"] * S)``; the JAX package runs
``dist_spmm`` / ``dist_spmm_allgather`` in ``shard_map`` over the
conftest's virtual CPU devices (jitted: eager shard_map takes seconds a
call). Same seeded matrices and inputs, the same options; forward and the
gradient of sum(Y * W) within rtol 1e-4 / atol 1e-5, for every body
tests/test_dist_spmm.py covers: padded, uneven rows, split, hubs, ragged x
refined x split, the all-gather baseline (and where JAX's is wrong:
hub and split plans), panels at S = 2, 4, 8 (shards
with unequal step counts among them), ragged panels and split panels with
hubs. The port's "torch" and "cuda" impls (the plain versions on CPU
tensors) against JAX "xla"; its "panels" against JAX "panels" (Pallas in
interpret mode, which sums in a bf16 hi/lo pair: there atol is
1e-5 * max|want| + 1e-5, tests/test_torch_panels.py's bar) and at the
strict bar against the float32 dense product. Then
``dist_gcn_apply`` and one ``make_dist_train_step`` step against the JAX
package's on the same weights, and the errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.parallel import dist_spmm as jdist_spmm
from of_spmm_tpu.parallel import dist_spmm_allgather as jdist_spmm_allgather
from of_spmm_tpu.parallel import partition_rows as jpartition_rows
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu.train import dist_gcn_apply as jdist_gcn_apply
from of_spmm_tpu.train import make_dist_train_step as jmake_dist_train_step
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN
from of_spmm_tpu_torch.parallel import (
    ShardMesh, default_mesh, dist_spmm, dist_spmm_allgather, partition_rows)
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.train import dist_gcn_apply, make_dist_train_step
from tests.conftest import ATOL, RTOL
from tests.test_torch_partition import _blocky, _hubby, _normalized, _wide


def _random_dense(n, m, density, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)


def _banded(n, seed=0, band=48, p_in=0.12, p_out=0.004):
    """Cluster-banded adjacency (what a locality reorder produces)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < p_out).astype(np.float32)
    for i in range(n):
        lo, hi = max(0, i - band // 2), min(n, i + band // 2)
        dense[i, lo:hi] += rng.random(hi - lo) < p_in
    return ((dense > 0) * rng.standard_normal((n, n))).astype(np.float32)


def _mesh(S):
    return Mesh(np.asarray(jax.devices()[:S]), ("x",))


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _jax_y_grad(plan, x, w, S, impl, fn=jdist_spmm):
    """JAX Y and d sum(Y * W) / dX, in one jitted function."""
    mesh = _mesh(S)

    @jax.jit
    def f(xx):
        y, vjp = jax.vjp(lambda a: fn(plan, a, mesh, impl=impl), xx)
        return y, vjp(jnp.asarray(w))[0]

    y, g = f(jnp.asarray(x))
    return np.asarray(y), np.asarray(g)


def _port_y_grad(plan, x, w, S, impl, fn=dist_spmm):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(plan, xt, ShardMesh(["cpu"] * S), impl=impl)
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _close_pallas_panels(got, want):
    """Against the JAX panel kernel, which sums in a bf16 hi/lo pair (about
    2^-17 of each term): tests/test_torch_panels.py's bar."""
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


# (name, dense matrix, S, partition options, JAX impl, port impls)
CASES = [
    ("padded-S2", lambda: _random_dense(96, 96, 0.08, 2), 2, {}, "xla", ("torch", "cuda")),
    ("padded-S4", lambda: _random_dense(96, 96, 0.08, 4), 4, {}, "xla", ("torch", "cuda")),
    ("padded-S8", lambda: _random_dense(96, 96, 0.08, 8), 8, {}, "xla", ("torch", "cuda")),
    ("uneven", lambda: _random_dense(50, 50, 0.12, 11), 4, {}, "xla", ("torch", "cuda")),
    ("rectangular", lambda: _random_dense(72, 100, 0.1, 3), 4, {}, "xla", ("torch", "cuda")),
    ("split", lambda: _random_dense(96, 96, 0.08, 7), 8, dict(split_boundary=True), "xla",
     ("torch", "cuda")),
    ("split-grad", lambda: _random_dense(48, 48, 0.15, 9), 4, dict(split_boundary=True), "xla",
     ("torch", "cuda")),
    ("hubs", lambda: _hubby(256, 11), 4, dict(replicate_hubs=12), "xla", ("torch", "cuda")),
    ("hubs-ragged-auto", lambda: _hubby(256, 13), 4, dict(ragged=True, replicate_hubs="auto"),
     "xla", ("cuda",)),
    ("ragged", lambda: _banded(128, 11), 4, dict(ragged=True), "xla", ("torch", "cuda")),
    ("ragged-refined", lambda: _banded(128, 11), 4, dict(ragged=True, refine_slack=0.2), "xla",
     ("torch", "cuda")),
    ("ragged-split", lambda: _banded(128, 11), 4, dict(ragged=True, split_boundary=True), "xla",
     ("cuda",)),
    ("ragged-refined-split", lambda: _banded(128, 11), 4,
     dict(ragged=True, refine_slack=0.2, split_boundary=True), "xla", ("torch", "cuda")),
    ("refined-S8", lambda: _blocky(512, 17), 8, dict(ragged=True, refine_slack=0.2), "xla",
     ("cuda",)),
    ("panels-S2", lambda: _normalized(133, 0.06, 2), 2, dict(local_engine="panels"), "panels",
     ("panels",)),
    ("panels-S4", lambda: _normalized(261, 0.06, 4), 4, dict(local_engine="panels"), "panels",
     ("panels",)),
    ("panels-S8", lambda: _normalized(517, 0.06, 8), 8, dict(local_engine="panels"), "panels",
     ("panels",)),
    ("panels-unequal-steps", lambda: _wide(1280, 2), 2, dict(local_engine="panels"), "panels",
     ("panels",)),
    ("panels-ragged", lambda: _normalized(256, 0.06, 11), 4,
     dict(ragged=True, local_engine="panels"), "panels", ("panels",)),
    ("panels-split", lambda: _normalized(256, 0.06, 17), 4,
     dict(ragged=True, split_boundary=True, local_engine="panels"), "panels", ("panels",)),
    ("panels-split-hubs", lambda: _normalized(256, 0.06, 17), 4,
     dict(ragged=True, split_boundary=True, replicate_hubs=32, local_engine="panels"), "panels",
     ("panels",)),
    ("panels-split-a2a-auto-hubs", lambda: _normalized(384, 0.08, 19), 8,
     dict(split_boundary=True, replicate_hubs="auto", local_engine="panels"), "panels",
     ("panels",)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dist_spmm_matches_jax(case):
    name, dense_of, S, kw, jimpl, impls = case
    dense = dense_of()
    x, _ = _inputs(dense.shape[1], 8, 1)
    _, w = _inputs(dense.shape[0], 8, 2)
    plan = partition_rows(CSR.from_dense(dense), S, **kw)
    jplan = jpartition_rows(JCSR.from_dense(dense), S, **kw)
    if jimpl == "panels":
        y_want, g_want = dense @ x, dense.T @ w
        y_pallas, g_pallas = _jax_y_grad(jplan, x, w, S, "panels")
    else:
        y_want, g_want = _jax_y_grad(jplan, x, w, S, "xla")
        _close(y_want, dense @ x)  # the oracle itself
    for impl in impls:
        y, g = _port_y_grad(plan, x, w, S, impl)
        assert y.shape == (dense.shape[0], 8) and g.shape == x.shape
        _close(y, y_want)
        _close(g, g_want)
        if jimpl == "panels":
            _close_pallas_panels(y, y_pallas)
            _close_pallas_panels(g, g_pallas)


@pytest.mark.parametrize("name,dense_of,S,kw", [
    ("padded", lambda: _random_dense(64, 64, 0.1, 7), 4, {}),
    ("ragged-refined", lambda: _banded(128, 13), 4, dict(ragged=True, refine_slack=0.2)),
    ("hubs", lambda: _hubby(256, 11), 4, dict(replicate_hubs=12)),
    ("split", lambda: _hubby(256, 11), 4, dict(split_boundary=True)),
])
def test_allgather_baseline_matches_jax(name, dense_of, S, kw):
    """The all-gather baseline against JAX's on plain plans. On hub and
    split plans JAX's baseline is wrong (its body appends no hub slab:
    NaN; it reads ``plan.buckets``, empty on a split plan: zeros); the
    port's runs the shard body on them, and both hold to the dense
    product."""
    dense = dense_of()
    x, w = _inputs(dense.shape[0], 8, 3)
    plan = partition_rows(CSR.from_dense(dense), S, **kw)
    jplan = jpartition_rows(JCSR.from_dense(dense), S, **kw)
    y, g = _port_y_grad(plan, x, w, S, "cuda", fn=dist_spmm_allgather)
    _close(y, dense @ x)
    _close(g, dense.T @ w)
    y_want, g_want = _jax_y_grad(jplan, x, w, S, "xla", fn=jdist_spmm_allgather)
    if name in ("hubs", "split"):
        assert not np.allclose(y_want, dense @ x, rtol=RTOL, atol=1e-3)
    else:
        _close(y, y_want)
        _close(g, g_want)


def _gcn_case():
    dense = _normalized(261, 0.06, 4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((261, 8)).astype(np.float32)
    labels = rng.integers(0, 4, 261).astype(np.int32)
    dims = (8, 16, 16, 4)
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    return dense, x, labels, jmodel, params, model


@pytest.mark.parametrize("kw,impl", [({}, "torch"), ({}, "cuda"),
                                     (dict(ragged=True, local_engine="panels"), "panels")])
def test_dist_gcn_apply_matches_jax(kw, impl):
    dense, x, _, jmodel, params, model = _gcn_case()
    jplan = jpartition_rows(JCSR.from_dense(dense), 4, **kw)
    mesh = _mesh(4)
    want = np.asarray(jax.jit(lambda p, xx: jdist_gcn_apply(jmodel, p, jplan, xx, mesh))(
        params, jnp.asarray(x)))
    plan = partition_rows(CSR.from_dense(dense), 4, **kw)
    with torch.no_grad():
        got = dist_gcn_apply(model, plan, torch.from_numpy(x), ShardMesh(["cpu"] * 4), impl=impl)
    assert got.shape == (261, 4)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kw", [{}, dict(ragged=True, refine_slack=0.2)])
def test_dist_train_step_matches_jax(kw):
    dense, x, labels, jmodel, params, model = _gcn_case()
    jplan = jpartition_rows(JCSR.from_dense(dense), 4, **kw)
    jloss, jparams = jmake_dist_train_step(jmodel, jplan, _mesh(4))(
        params, jnp.asarray(x), jnp.asarray(labels))
    plan = partition_rows(CSR.from_dense(dense), 4, **kw)
    step = make_dist_train_step(model, plan, ShardMesh(["cpu"] * 4), lr=1e-2)
    loss = step(torch.from_numpy(x), torch.from_numpy(labels))
    _close(loss.numpy(), np.asarray(jloss))
    want = gcn_params_from_numpy(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        _close(p.numpy(), want[name].numpy())


def test_errors_as_jax():
    dense = _normalized(128, 0.1, 23)
    x = torch.zeros((128, 4))
    plan = partition_rows(CSR.from_dense(dense), 2)
    with pytest.raises(ValueError, match="2 shards"):
        dist_spmm(plan, x, ShardMesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="local_engine"):
        dist_spmm(plan, x, ShardMesh(["cpu"] * 2), impl="panels")
    with pytest.raises(ValueError, match="impl"):
        dist_spmm(plan, x, ShardMesh(["cpu"] * 2), impl="pallas")
    split = partition_rows(CSR.from_dense(dense), 4, split_boundary=True)
    hubbed = partition_rows(CSR.from_dense(dense), 4, replicate_hubs=16)
    smuggled = dataclasses.replace(split, hub_local_idx=hubbed.hub_local_idx,
                                   hub_perm=hubbed.hub_perm)
    with pytest.raises(ValueError, match="hub"):
        dist_spmm(smuggled, x, ShardMesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="split_boundary=True, local_engine='panels'"):
        dist_spmm(dataclasses.replace(split, panel_fwd=hubbed.buckets), x,
                  ShardMesh(["cpu"] * 4), impl="panels")
    with pytest.raises(ValueError, match="ShardMesh needs"):
        ShardMesh([])
    with pytest.raises(RuntimeError, match="CUDA devices"):
        default_mesh(torch.cuda.device_count() + 1)


@pytest.mark.parametrize("kw,impl", [({}, "cuda"), (dict(local_engine="panels"), "panels"),
                                     (dict(split_boundary=True), "torch")])
def test_backward_without_transpose_raises(kw, impl):
    plan = partition_rows(CSR.from_dense(_normalized(128, 0.1, 23)), 2, with_transpose=False,
                          **kw)
    x = torch.randn((128, 4), requires_grad=True)
    y = dist_spmm(plan, x, ShardMesh(["cpu"] * 2), impl=impl)
    with pytest.raises(RuntimeError, match="with_transpose=False"):
        y.sum().backward()


def test_mesh_places_each_plan_once():
    plan = partition_rows(CSR.from_dense(_normalized(128, 0.1, 23)), 2)
    mesh = ShardMesh(["cpu", "cpu"])
    first = mesh.place(plan)
    assert mesh.place(plan) is first
    assert first[1].buckets.work is not None and first[1].transpose.work is not None
    pack = mesh.index(plan, "x_pack_idx", "cpu")
    assert pack is None and mesh.index(plan, "y_unpack_idx", "cpu") is None
