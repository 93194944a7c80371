"""The port's plan builders give the same arrays as the JAX package's.

bin_rows, bin_rows_relabeled and bin_rows_tiered on the same CSR must be
equal array for array (heavy rows that split, a cold tier, empty rows),
and the graph generators must give the same edges for the same seed.
"""

import dataclasses

import numpy as np
import pytest

from of_spmm_tpu.data.graphs import GraphConfig as JGraphConfig
from of_spmm_tpu.data.graphs import load_graph as jload_graph
from of_spmm_tpu.data.graphs import synthetic_edges as jsynthetic_edges
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.sparse import binned as jbinned
from of_spmm_tpu.sparse.formats import COO as JCOO
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu.sparse.tiled import bin_rows_tiered as jbin_rows_tiered
from of_spmm_tpu_torch.data.graphs import GraphConfig, load_graph, synthetic_edges
from of_spmm_tpu_torch.models.gcn import normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator
from of_spmm_tpu_torch.sparse import binned
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.tiled import TieredEll, bin_rows_tiered


def _assert_tree_equal(a, b, path="plan"):
    """Structural equality of a port plan and a JAX plan: same dataclass
    field names, equal arrays, equal static values."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_tree_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif hasattr(a, "shape") and not isinstance(a, tuple):
        x = np.asarray(a.cpu() if hasattr(a, "cpu") else a)
        y = np.asarray(b)
        assert x.dtype == y.dtype, f"{path}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _dense(n, m, density, seed, heavy=(), empty=()):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)
    for r in heavy:
        d[r, :] = rng.standard_normal(m)
    for r in empty:
        d[r] = 0
    return d


def _powerlaw_csrs(n=500, e=5000, seed=0):
    src, dst = jsynthetic_edges(JGraphConfig("pl", n, e, power_law=True), seed=seed)
    vals = np.random.default_rng(seed + 1).standard_normal(src.shape[0]).astype(np.float32)
    return (CSR.from_coo(COO.from_edges(src, dst, n, vals)),
            JCSR.from_coo(JCOO.from_edges(src, dst, n, vals)))


def _cases():
    heavy = _dense(120, 300, 0.04, seed=1, heavy=(5, 77), empty=(0, 64, 119))
    return {
        "heavy_empty": (CSR.from_dense(heavy), JCSR.from_dense(heavy)),
        "powerlaw": _powerlaw_csrs(),
    }


@pytest.mark.parametrize("case", ["heavy_empty", "powerlaw"])
@pytest.mark.parametrize("ladder,max_width", [("auto", 256), ("auto", 16), ((2, 4, 8), 8)])
def test_bin_rows_equal(case, ladder, max_width):
    a, b = _cases()[case]
    got = binned.bin_rows(a, ladder=ladder, max_width=max_width)
    want = jbinned.bin_rows(b, ladder=ladder, max_width=max_width)
    _assert_tree_equal(got, want)
    if max_width <= 16:
        assert got.has_split_rows


@pytest.mark.parametrize("max_width", [256, 16])
def test_bin_rows_relabeled_equal(max_width):
    sq = _dense(150, 150, 0.05, seed=2, heavy=(9,), empty=(3, 149))
    for a, b in [(CSR.from_dense(sq), JCSR.from_dense(sq)), _powerlaw_csrs(seed=4)]:
        got = binned.bin_rows_relabeled(a, max_width=max_width)
        want = jbinned.bin_rows_relabeled(b, max_width=max_width)
        _assert_tree_equal(got, want)


def test_optimal_ladder_equal():
    for a, b in _cases().values():
        for mb, mw in [(10, 256), (3, 64), (8, 16)]:
            assert binned.optimal_ladder(a, mb, mw) == jbinned.optimal_ladder(b, mb, mw)


@pytest.mark.parametrize("case", ["heavy_empty", "powerlaw"])
@pytest.mark.parametrize("tier_size,max_width", [(64, 256), (128, 16), (64, 8)])
def test_bin_rows_tiered_equal(case, tier_size, max_width):
    a, b = _cases()[case]
    got = bin_rows_tiered(a, tier_size=tier_size, max_width=max_width)
    want = jbin_rows_tiered(b, tier_size=tier_size, max_width=max_width)
    _assert_tree_equal(got, want)
    tiers = [t.tier for t in got.tiers]
    assert tiers[0] == -1 and len(tiers) > 2  # a cold tier and several warm ones
    # empty rows point at the sentinel (one past the concatenated ELL rows)
    if case == "heavy_empty":
        assert (got.finish.pos[[0, 64, 119]] == got.n_ell_rows).all()


def test_synthetic_edges_equal():
    for cfg in [("pl", 3000, 20000, True), ("er", 500, 2000, False)]:
        s, d = synthetic_edges(GraphConfig(*cfg), seed=3)
        js, jd = jsynthetic_edges(JGraphConfig(*cfg), seed=3)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(d, jd)


@pytest.mark.parametrize("symmetrize", [False, True])
def test_load_graph_cora_equal(symmetrize):
    csr, cfg = load_graph("cora", symmetrize=symmetrize)
    jcsr, jcfg = jload_graph("cora", symmetrize=symmetrize)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_tree_equal(csr, jcsr)
    _assert_tree_equal(normalized_adjacency(csr), jnormalized_adjacency(jcsr))


@pytest.mark.parametrize("layout,tier_size", [("auto", None), ("tiered", 512), ("binned", None)])
def test_make_operator_plans_equal(layout, tier_size):
    """Placed (CPU) operator plans equal the JAX package's unplaced ones,
    transpose aliasing included."""
    csr, _ = load_graph("cora", symmetrize=True)
    jcsr, _ = jload_graph("cora", symmetrize=True)
    op = make_operator(normalized_adjacency(csr), layout=layout, tier_size=tier_size,
                       device="cpu")
    jop = jmake_operator(jnormalized_adjacency(jcsr), layout=layout, tier_size=tier_size,
                         place=False)
    _assert_tree_equal(op.binned, jop.binned)
    assert op.transpose_aliased and jop.transpose_aliased
    assert op.binned_t is op.binned
    assert isinstance(op.binned, TieredEll) == (layout == "tiered")
    assert op.relabeled == jop.relabeled
    if op.relabeled:
        _assert_tree_equal(op.old_from_new, jop.old_from_new)
        _assert_tree_equal(op.new_from_old, jop.new_from_old)


def test_make_operator_non_symmetric_transpose_equal():
    d = _dense(90, 90, 0.06, seed=11, heavy=(4,), empty=(8,))
    for layout in ("binned", "tiered"):
        op = make_operator(CSR.from_dense(d), layout=layout, tier_size=32, device="cpu")
        jop = jmake_operator(JCSR.from_dense(d), layout=layout, tier_size=32, place=False)
        assert not op.transpose_aliased
        _assert_tree_equal(op.binned_t, jop.binned_t)
