"""The port's one-hot expansion engine (layout="expansion") against the JAX
package, on the CPU.

- ``build_expansion_plan``: plan arrays equal to the JAX package's on the
  same CSR (the bf16 values bitwise), on cora, random general and rank-1
  matrices, a non-square matrix, empty rows, an empty tile and an uneven
  last tile, several tiers (small ``stage_tier``) and several groups
  (small ``stage_budget``); with and without the native pass 1.
- Placement: ``stage_row`` against the JAX wrapper's staged table
  (``_stage_hilo``, tier clamp included), and the refusal of a lane that
  names a staged row beyond the table.
- ``expansion_spmm_torch`` (the kernel's plain version) against JAX
  ``spmm_expansion`` (Pallas, interpret mode) at the JAX tests' tolerance
  (rtol 2e-4 / atol 5e-4: the TPU kernel drops the vl * lo term, the port
  does not) and against the float64 dense product of the plan's values
  (rtol 1e-4 / atol 1e-5), at d = 8, 40 and 160; bf16 X against JAX's
  bf16 fast mode (max error below 0.03 max(max|want|, 1), the bar of
  tests/test_expansion.py::test_expansion_bf16_fast_mode).
- ``make_operator(layout="expansion")`` against the JAX operator
  (symmetric: transpose aliased; asymmetric: transpose built), and a GCN
  on cora against the JAX GCN (max-relative 1e-4).

The CUDA kernel runs only on the card; chip_smoke.py holds it against
``expansion_spmm_torch`` there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.data.graphs import load_graph as jload_graph
from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.ops.autograd import spmm as jspmm
from of_spmm_tpu.ops.pallas.expansion import _stage_hilo, spmm_expansion as jspmm_expansion
from of_spmm_tpu.sparse import expansion as jexp
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.data.graphs import load_graph
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator, place_plan, spmm, spmm_expansion
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.expansion import expansion_spmm, expansion_spmm_torch
from of_spmm_tpu_torch.sparse import expansion as texp
from of_spmm_tpu_torch.sparse.formats import CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

JAX_RTOL, JAX_ATOL = 2e-4, 5e-4   # tests/test_expansion.py
RTOL, ATOL = 1e-4, 1e-5           # against the float64 dense product
BF16_NORMWISE = 0.03               # tests/test_expansion.py, bf16 fast mode


def _dense(n, m, density, seed=0, rank1=False, empty_rows=None):
    """A seeded random pattern with standard-normal values, or with
    symmetric-normalized (rank-1) values; ``empty_rows`` are cleared."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m)) < density).astype(np.float32)
    if empty_rows is not None:
        dense[empty_rows] = 0
    if rank1:
        dr, dc = dense.sum(1), dense.sum(0)
        with np.errstate(divide="ignore"):
            r = np.where(dr > 0, dr ** -0.5, 0.0)
            c = np.where(dc > 0, dc ** -0.5, 0.0)
        return (dense * r[:, None] * c[None, :]).astype(np.float32)
    return dense * rng.standard_normal((n, m)).astype(np.float32)


def _cora():
    """cora's normalized adjacency as GCN builds it: (CSR, dense). The CSR
    keeps the duplicate self-loop of nodes that already had one (two
    lanes); the dense matrix sums them."""
    csr, _ = load_graph("cora", symmetrize=True)
    a_hat = normalized_adjacency(csr)
    return a_hat, a_hat.to_dense()


def _case(make, *args, **kw):
    """A CASES maker: (CSR, dense) of the seeded dense matrix."""
    def build():
        dense = make(*args, **kw)
        return CSR.from_dense(dense), dense
    return build


def _jcsr(csr):
    """The JAX package's CSR of the same arrays."""
    return JCSR(indptr=csr.indptr, cols=csr.cols, vals=csr.vals, shape=csr.shape)


_SMALL = dict(R=64, TILE=256, CW=128, stage_tier=128)
# name -> (dense matrix maker, build kwargs)
CASES = {
    "cora": (_cora, {}),
    "general_tiers": (_case(_dense, 300, 257, 0.05), _SMALL),
    "rank1_tiers": (_case(_dense, 300, 257, 0.05, seed=2, rank1=True), _SMALL),
    "nonsquare_wide": (_case(_dense, 64, 2000, 0.01, seed=1),
                       dict(R=64, TILE=256, CW=128, stage_tier=512)),
    "empty_rows_uneven": (_case(_dense, 70, 90, 0.04, seed=4, empty_rows=slice(10, 20)),
                          dict(R=32, TILE=128, CW=128, stage_tier=128)),
    "empty_tile": (_case(_dense, 100, 80, 0.05, seed=6, empty_rows=slice(32, 64)),
                   dict(R=32, TILE=128, CW=256, stage_tier=64)),
    "multi_group": (_case(_dense, 256, 300, 0.06, seed=9),
                    dict(R=32, TILE=128, CW=128, stage_tier=128, stage_budget=64)),
}

_GROUP_FIELDS = ("stage_idx", "win_lidx", "lrow", "base_blk", "tile_of")


def assert_groups_equal(p, j, fields, plan_fields):
    """Plan ``p`` (the port's) equals ``j`` (the JAX package's) array for
    array; bf16 values compared bitwise."""
    for f in plan_fields:
        assert getattr(p, f) == getattr(j, f), f
    assert len(p.groups) == len(j.groups)
    for pg, jg in zip(p.groups, j.groups):
        assert (pg.n_steps, pg.n_tiles, pg.stage_tier_ptr) == \
            (jg.n_steps, jg.n_tiles, jg.stage_tier_ptr)
        for f in fields:
            a, b = getattr(pg, f), np.asarray(getattr(jg, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in ("val_hi", "val_lo"):
            a, b = getattr(pg, f), getattr(jg, f)
            assert (a is None) == (b is None), f
            if a is not None:
                b = np.asarray(b)
                if b.dtype != np.uint16:  # the JAX package's plan
                    assert b.dtype == jnp.bfloat16, f
                    b = b.view(np.uint16)
                assert a.dtype == np.uint16 and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def plan_values_dense(dense):
    """The matrix with each value as the plan carries it: its bf16 pair."""
    out = dense.astype(np.float64)
    nz = dense != 0
    hi, lo = texp.bf16_pair_bits(dense[nz])
    out[nz] = texp.bf16_value(hi).astype(np.float64) + texp.bf16_value(lo)
    return out


def close_to_float64(got, dense, x, bf16_pair=True):
    """Elementwise against the float64 product of the plan's values (each
    value rounded to its bf16 pair, unless ``bf16_pair`` is False)."""
    want = (plan_values_dense(dense) if bf16_pair else dense) @ x.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_jax(case):
    make, kw = CASES[case]
    csr, dense = make()
    plan = texp.build_expansion_plan(csr, **kw)
    jplan = jexp.build_expansion_plan(_jcsr(csr), **kw)
    assert_groups_equal(plan, jplan, _GROUP_FIELDS, ("shape", "R", "TILE", "CW", "stage_tier"))
    assert (plan.n_steps, plan.n_tiles, plan.n_staged) == \
        (jplan.n_steps, jplan.n_tiles, jplan.n_staged)
    assert plan.padding_efficiency(csr.nnz) == jplan.padding_efficiency(csr.nnz)
    if case == "multi_group":
        assert len(plan.groups) > 2
    if case in ("general_tiers", "rank1_tiers", "cora"):
        assert len(plan.groups[0].stage_tier_ptr) - 1 >= (1 if case == "cora" else 3)
    if case == "empty_tile":
        assert 1 not in set(plan.groups[0].tile_of.tolist())  # tile 1 has no step


def test_plan_without_native_pass1_is_equal(monkeypatch):
    """The numpy branch (no native library) builds the same plan."""
    for case in ("general_tiers", "multi_group", "empty_tile"):
        make, kw = CASES[case]
        csr, _ = make()
        with_native = texp.build_expansion_plan(csr, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(native, "expansion_pass1", lambda *a, **k: None)
            without = texp.build_expansion_plan(csr, **kw)
        assert_groups_equal(without, with_native, _GROUP_FIELDS, ("shape", "R", "TILE", "CW"))


@pytest.mark.parametrize("n_x", [None, 200, 70])
def test_stage_rows_match_the_tpu_staging(n_x):
    """X[stage_row] is the staged table the TPU wrapper gathers, pad rows
    and the tier clamp included: on an integer-valued X (exact in a bf16
    hi/lo pair) it equals _stage_hilo's hi + lo, also on an X shorter than
    the plan's columns, where a tier's take starts at min(t * tier, n_x - 1)
    and clips."""
    make, kw = CASES["general_tiers"]
    csr, _ = make()
    plan = texp.build_expansion_plan(csr, **kw)
    jplan = jexp.build_expansion_plan(_jcsr(csr), **kw)
    n_x = n_x or csr.shape[1]
    x = np.random.default_rng(3).integers(-50, 50, (n_x, 8)).astype(np.float32)
    for g, jg in zip(plan.groups, jplan.groups):
        rows = texp.stage_rows(g.stage_idx, g.stage_tier_ptr, plan.stage_tier, n_x)
        hi, lo = _stage_hilo(jg, jplan.stage_tier, jnp.asarray(x), True)
        want = np.asarray(hi).astype(np.float32) + np.asarray(lo).astype(np.float32)
        np.testing.assert_array_equal(x[rows], want)
    assert texp.stage_rows(np.zeros(4, np.int32), (0, 4), 128, 0).tolist() == [-1] * 4


def test_placement_refuses_a_lane_beyond_the_table():
    make, kw = CASES["general_tiers"]
    plan = texp.build_expansion_plan(make()[0], **kw)
    g = plan.groups[0]
    u, real = texp.lane_stage_pos(g, plan.CW)
    assert real.any() and u[real].max() < g.stage_idx.shape[0]
    base = g.base_blk.copy()
    base[0] = g.stage_idx.shape[0] // 128 + 1  # the first step's first window block
    bad = dataclasses.replace(plan, groups=(dataclasses.replace(g, base_blk=base),))
    with pytest.raises(ValueError, match="beyond the group's"):
        texp.attach_stage_rows(bad)
    with pytest.raises(ValueError, match="beyond the group's"):
        place_plan(bad, "cpu")
    placed = place_plan(plan, "cpu")
    assert isinstance(placed.groups[0].stage_row, torch.Tensor)
    rep = texp.plan_memory_report(placed, d=128, hbm_limit=16 << 30)
    assert rep["stage_row_bytes"] == 4 * plan.n_staged and rep["fits"]
    assert rep["peak_bytes"] == (rep["plan_bytes"] + rep["stage_row_bytes"] + rep["x_bytes"]
                                 + rep["out_bytes"])


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel and the dense product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,d", [("general_tiers", 40), ("multi_group", 8),
                                    ("nonsquare_wide", 160), ("empty_rows_uneven", 8)])
def test_plain_version_matches_jax_kernel(case, d):
    make, kw = CASES[case]
    csr, dense = make()
    plan = place_plan(texp.build_expansion_plan(csr, **kw), "cpu")
    x = np.random.default_rng(5).standard_normal((dense.shape[1], d)).astype(np.float32)
    got = expansion_spmm_torch(plan, torch.from_numpy(x)).numpy()
    want = jspmm_expansion(jexp.build_expansion_plan(_jcsr(csr), **kw),
                           jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAX_RTOL, atol=JAX_ATOL)
    close_to_float64(got, dense, x)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 40, 160])
def test_plain_version_matches_float64(case, d):
    """Every plan shape at every width against the float64 dense product;
    the wrapper on a CPU tensor runs the plain version and launches
    nothing."""
    make, kw = CASES[case]
    csr, dense = make()
    plan = place_plan(texp.build_expansion_plan(csr, **kw), "cpu")
    x = np.random.default_rng(d).standard_normal((dense.shape[1], d)).astype(np.float32)
    before = dict(cuda_build.LAUNCHES)
    got = expansion_spmm(plan, torch.from_numpy(x)).numpy()
    assert cuda_build.LAUNCHES == before
    close_to_float64(got, dense, x)


def test_bf16_input_matches_jax_fast_mode():
    """bf16 X: the port computes in float32 and returns bf16; JAX's bf16
    fast mode, at the bf16 bar of the JAX test of the same matrix
    (tests/test_expansion.py::test_expansion_bf16_fast_mode)."""
    dense = _dense(128, 128, 0.08, seed=0)
    dense = dense + dense.T
    kw = dict(R=64, TILE=128, CW=128, stage_tier=512)
    x = np.random.default_rng(7).standard_normal((128, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = spmm_expansion(texp.build_expansion_plan(CSR.from_dense(dense), **kw), xb)
    assert got.dtype == torch.bfloat16
    want = jspmm_expansion(jexp.build_expansion_plan(JCSR.from_dense(dense), **kw),
                           jnp.asarray(x).astype(jnp.bfloat16), interpret=True)
    want = np.asarray(want).astype(np.float32)
    assert np.abs(got.float().numpy() - want).max() < BF16_NORMWISE * max(np.abs(want).max(), 1.0)


# ---------------------------------------------------------------------------
# the operator and the GCN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
def test_operator_matches_jax(symmetric):
    """make_operator(layout="expansion") then spmm against the JAX
    operator (Pallas interpret); the transpose plan is aliased for a
    symmetric matrix and built otherwise (op.T against the dense
    transpose)."""
    if symmetric:
        dense = _dense(128, 128, 0.08, seed=0)
        dense = dense + dense.T
    else:
        dense = _dense(96, 200, 0.05, seed=0)
    op = make_operator(CSR.from_dense(dense), layout="expansion", device="cpu")
    jop = jmake_operator(JCSR.from_dense(dense), layout="expansion", place=False)
    assert isinstance(op.binned, texp.ExpansionPlan)
    assert op.transpose_aliased == symmetric == jop.transpose_aliased
    rng = np.random.default_rng(3)
    x = rng.standard_normal((dense.shape[1], 32)).astype(np.float32)
    w = rng.standard_normal((dense.shape[0], 32)).astype(np.float32)
    want = np.asarray(jspmm(jop, jnp.asarray(x)))
    before = dict(cuda_build.LAUNCHES)
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain version
        with torch.no_grad():
            got = spmm(op, torch.from_numpy(x), impl=impl).numpy()
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)
        close_to_float64(got, dense, x)
    assert cuda_build.LAUNCHES == before
    with torch.no_grad():
        close_to_float64((op.T @ torch.from_numpy(w)).numpy(), dense.T, w)


def test_gcn_logits_on_cora_match_jax():
    """A 2-layer GCN on cora through layout="expansion" (the transpose plan
    aliased), weights carried over from the JAX GCN: max-relative 1e-4."""
    csr, _ = load_graph("cora", symmetrize=True)
    jcsr, _ = jload_graph("cora", symmetrize=True)
    op = make_operator(normalized_adjacency(csr), layout="expansion", device="cpu")
    jop = jmake_operator(jnormalized_adjacency(jcsr), layout="expansion", place=False)
    assert op.transpose_aliased
    dims = (16, 8, 4)
    x = np.random.default_rng(31).standard_normal((csr.shape[0], dims[0])).astype(np.float32)
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    want = np.asarray(jmodel.apply(params, jop, jnp.asarray(x)))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = model(op, torch.from_numpy(x)).numpy()
    assert got.shape == (csr.shape[0], dims[-1])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_empty_tile_and_empty_matrix_divergence():
    """Where the port departs from the reference on purpose: the JAX v1
    kernel never writes the output block of a tile without nonzeros (it
    reads back NaN in interpret mode), and the JAX package's
    build_expansion_plan fails on a matrix without nonzeros. The port adds into a zeroed output and plans
    an empty matrix as a plan without steps."""
    make, kw = CASES["empty_tile"]
    csr, dense = make()
    x = np.random.default_rng(2).standard_normal((csr.shape[1], 8)).astype(np.float32)
    want = np.asarray(jspmm_expansion(jexp.build_expansion_plan(_jcsr(csr), **kw),
                                      jnp.asarray(x), interpret=True))
    assert not np.isfinite(want[32:64]).all()
    got = spmm_expansion(texp.build_expansion_plan(csr, **kw), torch.from_numpy(x)).numpy()
    assert not got[32:64].any()
    close_to_float64(got, dense, x)
    empty = CSR.from_dense(np.zeros((10, 12), np.float32))
    with pytest.raises(ValueError):
        jexp.build_expansion_plan(_jcsr(empty))
    plan = texp.build_expansion_plan(empty)
    assert plan.n_steps == 0 and plan.n_tiles == 1
    assert not spmm_expansion(plan, torch.ones((12, 3))).any()


def test_refusals():
    """Bad CW / TILE as in the JAX package; the wrapper takes only a placed
    ExpansionPlan and float32 x of the right height; without a card and
    without a device the operator raises."""
    dense = _dense(200, 200, 0.05, seed=1)
    csr = CSR.from_dense(dense)
    for kw in (dict(CW=200), dict(TILE=100)):
        with pytest.raises(ValueError, match="must be a multiple of 128") as got:
            texp.build_expansion_plan(csr, **kw)
        with pytest.raises(ValueError) as want:
            jexp.build_expansion_plan(JCSR.from_dense(dense), **kw)
        assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_operator(csr, layout="expansion")
    plan = texp.build_expansion_plan(csr, **_SMALL)
    x = torch.zeros((200, 4))
    with pytest.raises(ValueError, match="not placed"):
        expansion_spmm(plan, x)
    placed = place_plan(plan, "cpu")
    with pytest.raises(TypeError):
        expansion_spmm(placed, x.double())
    with pytest.raises(ValueError, match="rows"):
        expansion_spmm(placed, torch.zeros((199, 4)))
    with pytest.raises(TypeError, match="ExpansionPlan"):
        expansion_spmm(make_operator(csr, layout="fused", device="cpu").binned, x)
    with pytest.raises(TypeError, match="place_plan"):
        place_plan(make_operator(csr, layout="fused", device="cpu").binned, "cpu")
