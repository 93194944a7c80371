"""The port's ranges engine against the JAX package, on the CPU.

- ``build_ranges_plan``: plan arrays equal to the JAX package's on the
  same CSR (values compared as the float32 of the JAX package's bf16
  pair), for the cases of tests/test_ranges_plan.py: a single range,
  switching ranges with scattered columns, hot columns, several segments,
  scattered overflow pieces, duplicate edges, short-lived ranges and the
  per-segment stage cap, plus a graph narrower than one range window (its
  copies clamp to the top end of X).
- ``ranges_spmm_torch`` (the kernel's plain version, driven by the window
  provenance) against JAX ``spmm_ranges`` (Pallas, interpret mode), the
  port's ``ranges_sim.simulate``, the JAX ``simulate`` and the dense
  product, on banded (community-like) and random graphs.
- ``make_operator(layout="ranges")`` and a 2-layer GCN against the JAX
  package's.

The CUDA kernel runs only on the card; chip_smoke.py holds it against
``ranges_spmm_torch`` there. Tolerance: rtol 1e-4, atol 1e-5 * max|want| +
1e-5 (tests/test_ranges_plan.py): the port computes in fp32, the JAX
kernel in bf16 hi/lo pairs (about 2^-17 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.models.gcn import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.ops.autograd import spmm as jspmm
from of_spmm_tpu.ops.pallas.ranges import spmm_ranges
from of_spmm_tpu.sparse import ranges as jranges
from of_spmm_tpu.sparse.formats import COO as JCOO
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu.sparse.ranges_sim import simulate as jsimulate
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator, place_operator, spmm
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.ranges import ranges_spmm, ranges_spmm_torch
from of_spmm_tpu_torch.ops.cuda.staged import staged_spmm_units_torch
from of_spmm_tpu_torch.sparse import panels as tpanels
from of_spmm_tpu_torch.sparse import ranges as tranges
from of_spmm_tpu_torch.sparse import staged_windows
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.ranges_sim import simulate

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


def _graph(n, m, density, seed=0, rank1=False, skew=False, banded=0.0):
    """tests/test_ranges_plan.py's pattern (random, optionally banded
    around the diagonal and hub-skewed) with random values, or with
    symmetric-normalized values, which the plan detects as rank-1."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m)) < density).astype(np.float32)
    if banded:
        for i in range(n):
            lo = max(0, (i * m // n) - 64)
            band = rng.random(min(128, m - lo)) < banded
            dense[i, lo:lo + band.shape[0]] += band
        dense = (dense > 0).astype(np.float32)
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


def _short_lived():
    """Each 128-row tile's mass sits in its own column band: every tile
    opens a new short range (tests/test_ranges_plan.py)."""
    n = 512
    dense = np.zeros((n, n), np.float32)
    rng = np.random.default_rng(17)
    for t in range(n // 128):
        lo = (t * 131) % (n - 128)
        dense[t * 128:(t + 1) * 128, lo:lo + 128] += (rng.random((128, 128)) < 0.5)
    return (dense > 0).astype(np.float32)


def _one_range_band():
    """One long-lived range (the first 256 columns of every row) and heavy
    scattered volume elsewhere."""
    dense = _graph(1024, 4096, 0.06, seed=23)
    dense[:, :256] = 1.0
    return dense


def _dense_case(make, *args, **kw):
    def build():
        d = make(*args, **kw)
        return CSR.from_dense(d), JCSR.from_dense(d), d
    return build


def _dup_case():
    """Random COO entries with repeats: duplicates sum (general values)."""
    rng = np.random.default_rng(13)
    n = 400
    rows = rng.integers(0, n, 4000).astype(np.int32)
    cols = rng.integers(0, n, 4000).astype(np.int32)
    vals = rng.random(4000).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    return (CSR.from_coo(COO.from_arrays(rows, cols, vals, (n, n))),
            JCSR.from_coo(JCOO.from_arrays(rows, cols, vals, (n, n))), dense)


_T256 = dict(T=256, hot_budget=0, range_cap=256)
# name -> (matrix maker returning (port CSR, JAX CSR, dense), build kwargs)
PLAN_CASES = {
    "single_range_rank1": (_dense_case(_graph, 768, 768, 0.02, rank1=True, seed=3),
                           dict(T=256, hot_budget=0)),
    "single_range_general": (_dense_case(_graph, 768, 768, 0.02, seed=3),
                             dict(T=256, hot_budget=0)),
    "switching_rank1": (_dense_case(_graph, 1024, 1024, 0.004, rank1=True, seed=5, banded=0.3),
                        _T256),
    "switching_general": (_dense_case(_graph, 1024, 1024, 0.004, seed=5, banded=0.3), _T256),
    "hot_skew": (_dense_case(_graph, 900, 900, 0.01, skew=True, rank1=True, seed=7, banded=0.2),
                 dict(T=256, hot_budget=512, hot_min_run=2, range_cap=256)),
    "multi_segment": (_dense_case(_graph, 1024, 1024, 0.01, rank1=True, seed=9, banded=0.3),
                      dict(_T256, seg_steps=8)),
    "overflow_pieces": (_dense_case(_graph, 512, 2048, 0.15, rank1=True, seed=11),
                        dict(_T256, s_cap=256)),
    "duplicates": (_dup_case, _T256),
    "short_lived": (_dense_case(_short_lived), dict(_T256, rq=128)),
    "seg_stage_cap": (_dense_case(_one_range_band),
                      dict(_T256, seg_steps=4096, seg_stage_cap=2048)),
    "top_end": (_dense_case(_graph, 300, 100, 0.05, rank1=True, seed=29), dict(T=256)),
    "defaults": (_dense_case(_graph, 1100, 1000, 0.01, rank1=True, seed=23, banded=0.3), {}),
}

_SEG_FIELDS = ("ctrl", "scols", "rcopy", "lidx", "lrow", "blk", "tile_of", "stage_take")
_PLAN_FIELDS = ("shape", "R", "T", "multihot", "RC", "S_buf", "DMAX", "RMAX", "RQ", "n_ranges",
                "n_range_rows", "n_scattered", "n_lanes", "stage_tier", "cq")


def _assert_plans_equal(p, j):
    for f in _PLAN_FIELDS:
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
        for f in _SEG_FIELDS:
            np.testing.assert_array_equal(getattr(ps, f), np.asarray(getattr(js, f)), err_msg=f)
        for f in ("val_hi", "val_lo"):  # float32 here, bf16 there
            a, b = getattr(ps, f), getattr(js, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b).astype(np.float32), err_msg=f)


def _placed(plan):
    return place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=plan.shape),
                          "cpu").binned


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_equals_jax(case):
    make, kw = PLAN_CASES[case]
    csr, jcsr, _ = make()
    plan = tranges.build_ranges_plan(csr, **kw)
    _assert_plans_equal(plan, jranges.build_ranges_plan(jcsr, **kw))
    assert plan.multihot == (case.endswith("rank1") or case in (
        "hot_skew", "multi_segment", "overflow_pieces", "top_end", "defaults", "short_lived"))
    if case.startswith("single_range"):
        assert plan.n_ranges == 1 and plan.n_scattered == 0
    if case.startswith("switching"):
        assert plan.n_ranges > 2 and plan.n_scattered > 0
    if case == "multi_segment":
        assert len(plan.segments) > 1
    if case == "overflow_pieces":
        n_vt = sum(int((s.ctrl[:, 0, 1] == 1).sum()) for s in plan.segments)
        assert n_vt > sum(s.n_tiles for s in plan.segments)
    if case == "short_lived":
        assert plan.n_ranges >= 3
    if case == "seg_stage_cap":
        assert plan.n_ranges == 1 and len(plan.segments) > 1
    if case == "top_end":
        assert plan.RC == 128 > plan.shape[1]


def test_plan_without_native_pass1_is_equal(monkeypatch):
    """The numpy branch (no native library) builds the same plan."""
    make, kw = PLAN_CASES["hot_skew"]
    csr, _, _ = make()
    with_native = tranges.build_ranges_plan(csr, **kw)
    monkeypatch.setattr(native, "expansion_pass1", lambda *a, **k: None)
    _assert_plans_equal(tranges.build_ranges_plan(csr, **kw), with_native)


def test_plan_memory_report():
    """The port's report counts what it keeps on the card (no take table,
    no hot table), under the JAX package's keys; a tiny limit does not
    fit."""
    csr, jcsr, _ = PLAN_CASES["hot_skew"][0]()
    kw = PLAN_CASES["hot_skew"][1]
    plan = tranges.build_ranges_plan(csr, **kw)
    rep = tranges.plan_memory_report(plan, d=128, hbm_limit=16 << 30)
    jrep = jranges.plan_memory_report(jranges.build_ranges_plan(jcsr, **kw), d=128,
                                      hbm_limit=16 << 30)
    assert set(rep) == set(jrep)
    assert rep["fits"] and rep["max_table_bytes"] == 0
    assert rep["peak_bytes"] == rep["plan_bytes"] + rep["x_bytes"] + rep["out_bytes"]
    assert not tranges.plan_memory_report(plan, d=128, hbm_limit=1 << 20)["fits"]


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel, the step oracles and the dense
# product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank1,d", [(True, 160), (False, 8)])
def test_plain_version_matches_jax_kernel(rank1, d):
    """ranges_spmm_torch on a banded hot multi-segment plan with several
    ranges against the JAX Pallas kernel in interpret mode
    (tests/test_ranges_plan.py::test_ranges_kernel_matches_dense), both
    step oracles and the dense product."""
    dense = _graph(640, 640, 0.01, rank1=rank1, seed=15, banded=0.3)
    kw = dict(T=256, hot_budget=256, hot_min_run=1, range_cap=256, seg_steps=16)
    csr = CSR.from_dense(dense)
    plan = tranges.build_ranges_plan(csr, **kw)
    jplan = jranges.build_ranges_plan(JCSR.from_dense(dense), **kw)
    assert len(plan.segments) > 1 and plan.n_ranges > 1 and plan.multihot == rank1
    x = np.random.default_rng(2).standard_normal((640, d)).astype(np.float32)
    got = ranges_spmm(_placed(plan), torch.from_numpy(x)).numpy()  # CPU: the plain version
    _close(got, np.asarray(spmm_ranges(jplan, jnp.asarray(x), interpret=True)))
    _close(got, dense @ x)
    _close(simulate(plan, x), jsimulate(jplan, x))
    _close(simulate(plan, x), got)


@pytest.mark.parametrize("case", ["overflow_pieces", "top_end"])
def test_plain_version_matches_jax_kernel_edges(case):
    """Scattered overflow pieces, and a range clamped at the top end of X
    (the TPU wrapper's zero padding), against the JAX kernel."""
    make, kw = PLAN_CASES[case]
    csr, jcsr, dense = make()
    plan = _placed(tranges.build_ranges_plan(csr, **kw))
    x = np.random.default_rng(3).standard_normal((csr.shape[1], 8)).astype(np.float32)
    got = ranges_spmm_torch(plan, torch.from_numpy(x)).numpy()
    want = spmm_ranges(jranges.build_ranges_plan(jcsr, **kw), jnp.asarray(x), interpret=True)
    _close(got, np.asarray(want))
    _close(got, dense @ x)


@pytest.mark.parametrize("case", ["overflow_pieces", "top_end", "hot_skew",
                                  "single_range_general"])
def test_unit_plain_version_matches_jax_kernel(case, monkeypatch):
    """The kernel's split into work units (sparse/staged_windows.py
    work_list), run by its plain version ``staged_spmm_units_torch`` at a
    selection cap low enough that tiles split (partials, row-scaled,
    summed per tile), against the JAX Pallas kernel in interpret mode,
    the unsplit plain version and the dense product."""
    make, kw = PLAN_CASES[case]
    csr, jcsr, dense = make()
    monkeypatch.setattr(tpanels, "UNIT_EDGES", 64)
    plan = _placed(tranges.build_ranges_plan(csr, **kw))
    split = sum(int(s.windows.split_tiles.shape[0]) for s in plan.segments)
    assert split > 1 or case == "top_end"  # x of 100 rows: one slot per tile
    x = np.random.default_rng(9).standard_normal((csr.shape[1], 8)).astype(np.float32)
    got = staged_spmm_units_torch(plan, torch.from_numpy(x)).numpy()
    want = spmm_ranges(jranges.build_ranges_plan(jcsr, **kw), jnp.asarray(x), interpret=True)
    _close(got, np.asarray(want))
    _close(got, ranges_spmm_torch(plan, torch.from_numpy(x)).numpy())
    _close(got, dense @ x)


@pytest.mark.parametrize("case", ["single_range_rank1", "single_range_general", "switching_rank1",
                                  "switching_general", "hot_skew", "multi_segment", "duplicates",
                                  "short_lived", "seg_stage_cap", "defaults"])
def test_plain_version_matches_oracles(case):
    make, kw = PLAN_CASES[case]
    csr, jcsr, dense = make()
    plan = tranges.build_ranges_plan(csr, **kw)
    x = np.random.default_rng(4).standard_normal((csr.shape[1], 12)).astype(np.float32)
    got = ranges_spmm_torch(_placed(plan), torch.from_numpy(x)).numpy()
    _close(got, dense @ x)
    sim = simulate(plan, x)
    _close(sim, dense @ x)
    _close(sim, jsimulate(jranges.build_ranges_plan(jcsr, **kw), x))


def test_windows_resolve_range_rows_from_rcopy():
    """A step's range window holds the chunk starts rcopy wrote (clip
    included), one window per first-of-range step; a tile's scattered rows
    are its tier-clamped take entries."""
    make, kw = PLAN_CASES["switching_rank1"]
    csr, _, _ = make()
    plan = tranges.build_ranges_plan(csr, **kw)
    for seg in plan.segments:
        win = staged_windows.segment_windows(plan, seg)
        ctrl = seg.ctrl[:, 0, :]
        comp = ctrl[:, 0] >= 0
        assert win.range_rows.shape == (int((comp & (ctrl[:, 10] == 1)).sum()),
                                        plan.RC // plan.RQ)
        copied = set(seg.rcopy[:, 0, :][seg.rcopy[:, 0, :] > 0].tolist()) | {0}
        assert set(win.range_rows.ravel().tolist()) <= copied
        assert (win.step_win[comp, 0] >= 0).all()
        assert win.staged_rows.min() >= 0 and win.staged_rows.max() < csr.shape[1]


# ---------------------------------------------------------------------------
# the operator and the GCN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank1", [True, False])
def test_operator_matches_jax(rank1):
    """make_operator(layout="ranges") then spmm against the JAX package's
    operator (Pallas interpret); op.T against the dense transpose."""
    dense = _graph(600, 600, 0.02, rank1=rank1, seed=21, banded=0.2)
    op = make_operator(CSR.from_dense(dense), layout="ranges", device="cpu")
    jop = jmake_operator(JCSR.from_dense(dense), layout="ranges", place=False)
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
    """A 2-layer GCN through layout="ranges" on a symmetric normalized
    banded adjacency (the transpose plan is aliased), weights carried over
    from the JAX GCN."""
    rng = np.random.default_rng(37)
    n = 512
    dense = (_graph(n, n, 0.004, seed=37, banded=0.1) > 0).astype(np.float32)
    dense = np.maximum(dense, dense.T)
    np.fill_diagonal(dense, 0)
    a_hat = normalized_adjacency(CSR.from_dense(dense))
    ja_hat = jnormalized_adjacency(JCSR.from_dense(dense))
    op = make_operator(a_hat, layout="ranges", device="cpu")
    jop = jmake_operator(ja_hat, layout="ranges", place=False)
    assert op.transpose_aliased and op.binned.multihot
    dims = (16, 8, 4)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(1))
    want = np.asarray(jmodel.apply(params, jop, jnp.asarray(x)))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = model(op, torch.from_numpy(x)).numpy()
    assert got.shape == (n, dims[-1])
    _close(got, want)


def test_refusals():
    """Without a card and without a device the operator raises; the
    wrapper takes only a placed RangesPlan and float32 x of the right
    height; a range window that is not a multiple of 128 is refused at
    placement."""
    csr = CSR.from_dense(_graph(300, 300, 0.05, seed=1, rank1=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_operator(csr, layout="ranges")
    plan = tranges.build_ranges_plan(csr, T=256)
    x = torch.zeros((300, 4))
    with pytest.raises(ValueError, match="not placed"):
        ranges_spmm(plan, x)
    placed = _placed(plan)
    with pytest.raises(TypeError):
        ranges_spmm(placed, x.double())
    with pytest.raises(ValueError, match="rows"):
        ranges_spmm(placed, torch.zeros((299, 4)))
    with pytest.raises(TypeError, match="RangesPlan"):
        ranges_spmm(make_operator(csr, layout="fused", device="cpu").binned, x)
    odd = tranges.build_ranges_plan(csr, T=256, range_cap=200)
    assert odd.RC == 200
    with pytest.raises(ValueError, match="multiple of 128"):
        _placed(odd)
