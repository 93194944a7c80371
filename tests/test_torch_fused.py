"""The port's fused engine against the JAX package, on the CPU.

- ``build_fused_plan``: plan arrays equal to the JAX package's on the same
  CSR (values compared as the float32 of the JAX package's bf16 pair), for
  the cases of tests/test_fused_plan.py: rank-1 and general values, rows
  and chunks staging, window mode, several segments, virtual tiles,
  duplicate edges, and the memory-budget split and refusal (with the same
  ``hbm_limit`` on both sides: the budget decides the segments).
- ``fused_spmm_torch`` (the kernel's plain version, driven by the window
  provenance) against JAX ``spmm_fused`` (Pallas, interpret mode), the
  port's ``fused_sim.simulate``, the JAX ``simulate`` and the dense product.
- ``make_operator(layout="fused")`` and a 2-layer GCN against the JAX
  package's.

The CUDA kernel runs only on the card; chip_smoke.py holds it against
``fused_spmm_torch`` there. Tolerance: rtol 1e-4, atol 1e-5 * max|want| +
1e-5 (tests/test_fused_plan.py): the port computes in fp32, the JAX kernel
in bf16 hi/lo pairs (about 2^-17 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.ops.autograd import spmm as jspmm
from of_spmm_tpu.ops.pallas.fused import spmm_fused
from of_spmm_tpu.sparse import fused as jfused
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu.sparse.fused_sim import simulate as jsimulate
from of_spmm_tpu.utils.errors import CapacityError as JCapacityError
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator, place_operator, spmm
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.fused import fused_spmm, fused_spmm_torch
from of_spmm_tpu_torch.ops.cuda.staged import staged_spmm_units_torch
from of_spmm_tpu_torch.sparse import fused as tfused
from of_spmm_tpu_torch.sparse import panels as tpanels
from of_spmm_tpu_torch.sparse import staged_windows
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.fused_sim import simulate
from of_spmm_tpu_torch.utils.errors import CapacityError

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


def _graph(n, m, density, seed=0, rank1=False, skew=False):
    """tests/test_fused_plan.py's pattern (random, optionally hub-skewed)
    with random values, or with symmetric-normalized values, which the
    plan detects as rank-1 (the r_i * c_j products of that file's
    generator are not detected, so its "rank1" cases plan one-hot)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m)) < density).astype(np.float32)
    if skew:
        hubs = rng.choice(m, size=max(m // 50, 1), replace=False)
        dense[:, hubs] = (rng.random((n, hubs.shape[0])) < 0.6).astype(np.float32)
    if rank1:
        dr, dc = dense.sum(1), dense.sum(0)
        with np.errstate(divide="ignore"):
            r = np.where(dr > 0, dr ** -0.5, 0.0).astype(np.float32)
            c = np.where(dc > 0, dc ** -0.5, 0.0).astype(np.float32)
        return dense * r[:, None] * c[None, :]
    return dense * rng.random((n, m)).astype(np.float32)


def _hub_rows(seed, p):
    """A 512-node pattern whose first 128 rows are dense (a hub tile)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((512, 512)) < 0.02).astype(np.float32)
    dense[:128, :] = (rng.random((128, 512)) < p).astype(np.float32)
    return dense


def _window_graph(unweighted):
    rng = np.random.default_rng(17)
    dense = (rng.random((1024, 1024)) < 0.03).astype(np.float32)
    dense[:, :24] = (rng.random((1024, 24)) < 0.7).astype(np.float32)  # hubs
    if not unweighted:
        dense = dense * rng.random((1024, 1024)).astype(np.float32)
    return dense


def _dup_csrs():
    """Unit-valued edges with two duplicate self-loops per row: coalesced,
    the value 2.0 no longer factors, so the plan takes one-hot lanes."""
    rng = np.random.default_rng(11)
    n = 260
    rows, cols = [], []
    for i in range(n):
        nb = rng.choice(n, size=4, replace=False)
        rows += [i] * 4 + [i, i]
        cols += nb.tolist() + [i, i]
    rows, cols = np.asarray(rows), np.asarray(cols)
    order = np.argsort(rows * n + cols, kind="stable")
    rows, cols = rows[order], cols[order].astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    vals = np.ones(rows.shape[0], np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), 1.0)
    return (CSR(indptr=indptr, cols=cols, vals=vals, shape=(n, n)),
            JCSR(indptr=indptr, cols=cols, vals=vals, shape=(n, n)), dense)


def _dense_case(make, *args, **kw):
    def build():
        d = make(*args, **kw)
        return CSR.from_dense(d), JCSR.from_dense(d), d
    return build


_BASE = dict(R=128, T=256, hot_budget=256, hot_min_run=1)
_WINDOW = dict(R=256, T=512, hot_budget=128, hot_min_run=1, staging="chunks", stage_tier=256,
               s_cap=512, window=True)
# name -> (matrix maker returning (port CSR, JAX CSR, dense), build kwargs)
PLAN_CASES = {
    "rank1_chunks": (_dense_case(_graph, 700, 700, 0.02, seed=3, rank1=True), _BASE),
    "general_chunks": (_dense_case(_graph, 700, 700, 0.02, seed=3), _BASE),
    "rank1_rows": (_dense_case(_graph, 700, 700, 0.02, seed=13, rank1=True),
                   dict(_BASE, staging="rows")),
    "general_rows": (_dense_case(_graph, 700, 700, 0.02, seed=13),
                     dict(_BASE, staging="rows")),
    "hot_skew": (_dense_case(_graph, 900, 900, 0.01, skew=True, rank1=True, seed=7),
                 dict(R=128, T=256, hot_budget=512, hot_min_run=2)),
    "multi_segment": (_dense_case(_graph, 1024, 1024, 0.02, rank1=True, seed=5),
                      dict(R=128, T=256, hot_budget=0, seg_steps=8)),
    "virtual_tiles_rows": (_dense_case(_hub_rows, 23, 0.6),
                           dict(R=128, T=256, hot_budget=0, s_cap=256, staging="rows")),
    "virtual_tiles_chunks": (_dense_case(_hub_rows, 43, 0.5),
                             dict(R=128, T=256, hot_budget=0, staging="chunks",
                                  stage_tier=128, s_cap=256)),
    "window_rank1": (_dense_case(_window_graph, True), _WINDOW),
    "window_general": (_dense_case(_window_graph, False), _WINDOW),
    "duplicates": (_dup_csrs, dict(R=128, T=256, hot_budget=0, staging="chunks",
                                   stage_tier=128)),
    "defaults": (_dense_case(_graph, 1100, 1000, 0.01, seed=23, rank1=True), {}),
}

_SEG_FIELDS = ("ctrl", "scols", "lidx", "lrow", "blk", "tile_of", "stage_take")
_PLAN_FIELDS = ("shape", "R", "T", "multihot", "staging", "stage_tier", "S_buf", "DMAX",
                "n_staged", "n_lanes", "window", "cq")


def _assert_plans_equal(p, j, seg_fields=_SEG_FIELDS, plan_fields=_PLAN_FIELDS):
    for f in plan_fields:
        assert getattr(p, f) == getattr(j, f), f
    for f in ("hot_ids", "row_scale", "col_scale"):
        a, b = getattr(p, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert len(p.segments) == len(j.segments)
    for ps, js in zip(p.segments, j.segments):
        assert (ps.n_steps, ps.n_tiles, ps.stage_tier_ptr) == \
            (js.n_steps, js.n_tiles, js.stage_tier_ptr)
        for f in seg_fields:
            a, b = getattr(ps, f), getattr(js, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
        for f in ("val_hi", "val_lo"):  # float32 here, bf16 there
            a, b = getattr(ps, f), getattr(js, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, np.asarray(b).astype(np.float32), err_msg=f)


def _placed(plan):
    return place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=plan.shape),
                          "cpu").binned


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_equals_jax(case):
    make, kw = PLAN_CASES[case]
    csr, jcsr, _ = make()
    plan = tfused.build_fused_plan(csr, **kw)
    _assert_plans_equal(plan, jfused.build_fused_plan(jcsr, **kw))
    if case.startswith("virtual_tiles"):
        n_vt = sum(int((s.ctrl[:, 0, 1] == 1).sum()) for s in plan.segments)
        assert n_vt > sum(s.n_tiles for s in plan.segments)
    if case == "multi_segment":
        assert len(plan.segments) > 1
    assert plan.multihot == (case not in ("duplicates", "window_general", "general_rows",
                                          "general_chunks"))
    assert plan.window == case.startswith("window")


def test_plan_without_native_pass1_is_equal(monkeypatch):
    """The numpy branch (no native library) builds the same plan."""
    for case in ("general_chunks", "hot_skew"):
        make, kw = PLAN_CASES[case]
        csr, _, _ = make()
        with_native = tfused.build_fused_plan(csr, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(native, "expansion_pass1", lambda *a, **k: None)
            _assert_plans_equal(tfused.build_fused_plan(csr, **kw), with_native)


def test_memory_budget_split_and_refusal():
    """The same tight hbm_limit on both sides cuts the same extra segments
    (tests/test_fused_plan.py::test_fused_plan_hbm_budget_splits_and_rejects),
    and a budget below the fixed cost refuses on both."""
    dense = _graph(1500, 1500, 0.03, rank1=True, seed=9)
    csr, jcsr = CSR.from_dense(dense), JCSR.from_dense(dense)
    kw = dict(R=128, T=256, hot_budget=0, s_cap=256)
    big = tfused.build_fused_plan(csr, hbm_limit=1 << 40, **kw)
    _assert_plans_equal(big, jfused.build_fused_plan(jcsr, hbm_limit=1 << 40, **kw))
    rep = jfused.plan_memory_report(big, d=128, hbm_limit=1 << 40)
    fixed = rep["peak_bytes"] - int(1.5 * rep["max_table_bytes"])
    tight_limit = int((fixed + int(1.5 * rep["max_table_bytes"] / 3)) / 0.80) + 1
    tight = tfused.build_fused_plan(csr, hbm_limit=tight_limit, **kw)
    assert len(tight.segments) > len(big.segments)
    _assert_plans_equal(tight, jfused.build_fused_plan(jcsr, hbm_limit=tight_limit, **kw))
    x = np.random.default_rng(6).standard_normal((1500, 8)).astype(np.float32)
    _close(fused_spmm_torch(_placed(tight), torch.from_numpy(x)).numpy(), dense @ x)
    with pytest.raises(CapacityError, match="cannot fit"):
        tfused.build_fused_plan(csr, hbm_limit=int(fixed * 0.5), **kw)
    with pytest.raises(JCapacityError, match="cannot fit"):
        jfused.build_fused_plan(jcsr, hbm_limit=int(fixed * 0.5), **kw)


def test_plan_memory_report():
    """The port's report counts what it keeps on the card: no staged table
    and no hot table; the JAX package's keys."""
    csr, jcsr, _ = PLAN_CASES["hot_skew"][0]()
    kw = PLAN_CASES["hot_skew"][1]
    plan = tfused.build_fused_plan(csr, **kw)
    rep = tfused.plan_memory_report(plan, d=128, hbm_limit=16 << 30)
    jrep = jfused.plan_memory_report(jfused.build_fused_plan(jcsr, **kw), d=128,
                                     hbm_limit=16 << 30)
    assert set(rep) == set(jrep)
    assert rep["fits"] and rep["max_table_bytes"] == 0 and rep["hot_bytes"] == 0
    assert rep["peak_bytes"] == rep["plan_bytes"] + rep["x_bytes"] + rep["out_bytes"]
    assert not tfused.plan_memory_report(plan, d=128, hbm_limit=1 << 20)["fits"]


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel, the step oracles and the dense
# product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,d", [("rank1_chunks", 16), ("general_chunks", 16),
                                    ("window_rank1", 16), ("window_general", 16),
                                    ("virtual_tiles_chunks", 8), ("duplicates", 8)])
def test_plain_version_matches_jax_kernel(case, d):
    """fused_spmm_torch on the placed plan against the JAX Pallas kernel in
    interpret mode, both step oracles and the dense product."""
    make, kw = PLAN_CASES[case]
    csr, jcsr, dense = make()
    plan = _placed(tfused.build_fused_plan(csr, **kw))
    jplan = jfused.build_fused_plan(jcsr, **kw)
    x = np.random.default_rng(5).standard_normal((csr.shape[1], d)).astype(np.float32)
    got = fused_spmm_torch(plan, torch.from_numpy(x)).numpy()
    _close(got, np.asarray(spmm_fused(jplan, jnp.asarray(x), interpret=True)))
    _close(got, dense @ x)
    sim = simulate(tfused.build_fused_plan(csr, **kw), x)
    _close(sim, jsimulate(jplan, x))
    _close(sim, got)


@pytest.mark.parametrize("case", ["window_rank1", "window_general", "virtual_tiles_chunks",
                                  "rank1_rows"])
def test_unit_plain_version_matches_jax_kernel(case, monkeypatch):
    """The kernel's split into work units (sparse/staged_windows.py
    work_list), run by its plain version ``staged_spmm_units_torch`` at a
    selection cap low enough that tiles (window blocks in window mode)
    split (partials, row-scaled, summed per key), against the JAX Pallas
    kernel in interpret mode, the unsplit plain version and the dense
    product."""
    make, kw = PLAN_CASES[case]
    csr, jcsr, dense = make()
    monkeypatch.setattr(tpanels, "UNIT_EDGES", 64)
    plan = _placed(tfused.build_fused_plan(csr, **kw))
    assert sum(int(s.windows.split_tiles.shape[0]) for s in plan.segments) > 1
    x = np.random.default_rng(9).standard_normal((csr.shape[1], 8)).astype(np.float32)
    got = staged_spmm_units_torch(plan, torch.from_numpy(x)).numpy()
    if case != "rank1_rows":  # rows staging runs slowly in interpret mode
        want = spmm_fused(jfused.build_fused_plan(jcsr, **kw), jnp.asarray(x), interpret=True)
        _close(got, np.asarray(want))
    _close(got, fused_spmm_torch(plan, torch.from_numpy(x)).numpy())
    _close(got, dense @ x)


def test_zero_matrix_jax_kernel_gives_nan_port_gives_zeros():
    """A reference fault the port does not copy (ROADMAP.md Queue 3): on a
    50 x 50 matrix without nonzeros the JAX kernel in interpret mode
    returns NaN in every row (one segment of two pad steps, every lane on
    the row sentinel). The port's plain version and its unit version give
    zeros; the kernel writes them through the tile's empty work unit, as
    the wrapper no longer zeroes Y."""
    csr, jcsr = CSR.from_dense(np.zeros((50, 50), np.float32)), JCSR.from_dense(
        np.zeros((50, 50), np.float32))
    x = np.random.default_rng(1).standard_normal((50, 8)).astype(np.float32)
    want = np.asarray(spmm_fused(jfused.build_fused_plan(jcsr), jnp.asarray(x), interpret=True))
    assert want.shape == (50, 8) and np.isnan(want).all()
    plan = _placed(tfused.build_fused_plan(csr))
    win = plan.segments[0].windows
    assert win.unit_slots.shape[0] == 0 and win.units.tolist() == [[0, 0, 0]]
    for fn in (fused_spmm_torch, staged_spmm_units_torch):
        got = fn(plan, torch.from_numpy(x)).numpy()
        assert got.shape == (50, 8) and not got.any()


def test_plain_version_wide_features_and_segments():
    """d = 200 (two 128-wide slabs on the TPU kernel) on a multi-segment
    hot plan, against the JAX kernel (tests/test_fused_plan.py)."""
    dense = _graph(512, 512, 0.03, rank1=True, seed=17, skew=True)
    kw = dict(R=128, T=256, hot_budget=256, hot_min_run=1, seg_steps=8)
    plan = _placed(tfused.build_fused_plan(CSR.from_dense(dense), **kw))
    assert len(plan.segments) > 1 and plan.n_hot
    x = np.random.default_rng(6).standard_normal((512, 200)).astype(np.float32)
    got = fused_spmm(plan, torch.from_numpy(x)).numpy()  # CPU tensor: the plain version
    want = spmm_fused(jfused.build_fused_plan(JCSR.from_dense(dense), **kw), jnp.asarray(x),
                      interpret=True)
    _close(got, np.asarray(want))
    _close(got, dense @ x)


@pytest.mark.parametrize("case", ["rank1_rows", "general_rows", "virtual_tiles_rows",
                                  "hot_skew", "multi_segment", "defaults"])
def test_plain_version_matches_oracles(case):
    """The other plan shapes against the port's and the JAX step oracles
    and the dense product (rows staging runs slowly in interpret mode)."""
    make, kw = PLAN_CASES[case]
    csr, jcsr, dense = make()
    plan = tfused.build_fused_plan(csr, **kw)
    x = np.random.default_rng(4).standard_normal((csr.shape[1], 12)).astype(np.float32)
    got = fused_spmm_torch(_placed(plan), torch.from_numpy(x)).numpy()
    _close(got, dense @ x)
    _close(simulate(plan, x), dense @ x)
    _close(simulate(plan, x), jsimulate(jfused.build_fused_plan(jcsr, **kw), x))


def test_windows_follow_the_staging_copies():
    """Each virtual tile's staged rows are the X rows its lanes name: the
    provenance of a rows-mode plan holds the tile's staged column list,
    and of a chunks-mode plan the tier-clamped take entries."""
    for case in ("virtual_tiles_rows", "virtual_tiles_chunks"):
        make, kw = PLAN_CASES[case]
        csr, _, dense = make()
        plan = tfused.build_fused_plan(csr, **kw)
        for seg in plan.segments:
            win = staged_windows.segment_windows(plan, seg)
            firsts = np.nonzero((seg.ctrl[:, 0, 0] >= 0) & (seg.ctrl[:, 0, 1] == 1))[0]
            assert np.array_equal(win.step_win[firsts, 1],
                                  np.concatenate([[0], np.cumsum(win.step_win[firsts, 2])[:-1]]))
            assert win.staged_rows.shape[0] == int(win.step_win[firsts, 2].sum())
            assert win.staged_rows.min() >= 0 and win.staged_rows.max() < csr.shape[1]
            assert win.range_rows.shape[0] == 0 and (win.step_win[:, 0] <= 0).all()


def test_attach_windows_refuses_a_lane_naming_nothing():
    """Plan bugs that placement refuses: a tile whose staged rows were
    never copied (its lanes name no row of X), and a lane past its tile's
    parity of the staging scratch (it reads rows the next tile's copies
    overwrite)."""
    make, kw = PLAN_CASES["general_chunks"]
    csr, _, _ = make()
    plan = tfused.build_fused_plan(csr, **kw)
    seg = plan.segments[0]
    first = int(np.nonzero(seg.ctrl[:, 0, 1])[0][0])  # the first tile: parity 0
    ctrl = seg.ctrl.copy()
    ctrl[:first, 0, 3] = 0  # drop the prologue's copies
    blk = seg.blk.copy()
    blk[first, 0, 0] = plan.n_hot // 128 + plan.S_buf // 128
    for bad_seg, match in ((dataclasses.replace(seg, ctrl=ctrl), "resolves to no row"),
                           (dataclasses.replace(seg, blk=blk), "overwrites the staged rows")):
        bad = dataclasses.replace(plan, segments=(bad_seg,) + plan.segments[1:])
        with pytest.raises(ValueError, match=match):
            staged_windows.attach_windows(bad)


# ---------------------------------------------------------------------------
# the operator and the GCN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank1", [True, False])
def test_operator_matches_jax(rank1):
    """make_operator(layout="fused") then spmm against the JAX package's
    operator (Pallas interpret); op.T against the dense transpose."""
    dense = _graph(600, 600, 0.02, rank1=rank1, seed=21)
    op = make_operator(CSR.from_dense(dense), layout="fused", device="cpu")
    jop = jmake_operator(JCSR.from_dense(dense), layout="fused", place=False)
    assert op.binned.multihot == rank1 and not op.transpose_aliased
    rng = np.random.default_rng(7)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    w = rng.standard_normal((600, 16)).astype(np.float32)
    want = np.asarray(jspmm(jop, jnp.asarray(x)))
    before = dict(cuda_build.LAUNCHES)
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain version
        with torch.no_grad():
            _close(spmm(op, torch.from_numpy(x), impl=impl).numpy(), want)
    assert cuda_build.LAUNCHES == before
    _close(want, dense @ x)
    with torch.no_grad():
        _close((op.T @ torch.from_numpy(w)).numpy(), dense.T @ w)


def test_gcn_logits_match_jax():
    """A 2-layer GCN through layout="fused" on a symmetric normalized
    adjacency (the transpose plan is aliased), weights carried over from
    the JAX GCN."""
    rng = np.random.default_rng(31)
    n = 400
    dense = (rng.random((n, n)) < 0.02).astype(np.float32)
    dense = np.maximum(dense, dense.T)
    np.fill_diagonal(dense, 0)
    a_hat = normalized_adjacency(CSR.from_dense(dense))
    ja_hat = jnormalized_adjacency(JCSR.from_dense(dense))
    op = make_operator(a_hat, layout="fused", device="cpu")
    jop = jmake_operator(ja_hat, layout="fused", place=False)
    assert op.transpose_aliased and op.binned.multihot
    dims = (16, 8, 4)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    want = np.asarray(jmodel.apply(params, jop, jnp.asarray(x)))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = model(op, torch.from_numpy(x)).numpy()
    assert got.shape == (n, dims[-1])
    _close(got, want)


def test_refusals():
    """Without a card and without a device the operator raises; the
    wrapper takes only a placed FusedPlan and float32 x of the right
    height; staging must be rows or chunks."""
    csr = CSR.from_dense(_graph(200, 200, 0.05, seed=1, rank1=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_operator(csr, layout="fused")
    with pytest.raises(ValueError, match="staging"):
        tfused.build_fused_plan(csr, staging="table")
    with pytest.raises(ValueError, match="rank1=True"):
        tfused.build_fused_plan(CSR.from_dense(_graph(200, 200, 0.05, seed=1)), rank1=True)
    plan = tfused.build_fused_plan(csr, T=256)
    x = torch.zeros((200, 4))
    with pytest.raises(ValueError, match="not placed"):
        fused_spmm(plan, x)
    placed = _placed(plan)
    with pytest.raises(TypeError):
        fused_spmm(placed, x.double())
    with pytest.raises(ValueError, match="rows"):
        fused_spmm(placed, torch.zeros((199, 4)))
    with pytest.raises(TypeError, match="FusedPlan"):
        fused_spmm(make_operator(csr, layout="ranges", device="cpu").binned, x)
