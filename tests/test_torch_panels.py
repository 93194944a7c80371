"""The port's panel engine against the JAX package, on the CPU.

- ``build_panels_plan``: plan arrays equal to the JAX package's on the
  same CSR (masks compared expanded: the native pass-1 and the numpy
  branch order the compact edges differently), for the cases of
  tests/test_panels_plan.py plus direct rows, per-edge values and
  duplicate edges; the mask expansions (numpy, and the scatter-add the
  placement runs on the card) against the JAX package's.
- ``panel_spmm_torch`` (the kernel's plain version, driven by the window
  provenance) against JAX ``spmm_panels`` (Pallas, interpret mode), the
  port's ``panels_sim.simulate`` and the JAX ``simulate``.
- ``make_operator(layout="panels")``: rank-1 and per-edge plans, the
  aliased transpose, and GCN logits, against the JAX package.

The CUDA kernel runs only on the card; chip_smoke.py holds it against
``panel_spmm_torch`` there. Tolerance: rtol 1e-4, atol 1e-5 * max|want| +
1e-5 (tests/test_panels_plan.py): the port computes in fp32, the JAX
kernel in a bf16 hi/lo pair (about 2^-17 relative).
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
from of_spmm_tpu.ops.pallas.panels import spmm_panels
from of_spmm_tpu.sparse import panels as jpanels
from of_spmm_tpu.sparse.formats import COO as JCOO
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu.sparse.panels_sim import simulate as jsimulate
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.data.graphs import load_graph
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator, place_operator, spmm
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.panels import (
    panel_spmm, panel_spmm_torch, panel_spmm_units_torch)
from of_spmm_tpu_torch.sparse import panels as tpanels
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.fused import device_hbm_bytes
from of_spmm_tpu_torch.sparse.panels_sim import simulate
from of_spmm_tpu_torch.utils.config import FLAGS

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


def _graph(n, m, density, seed=0, skew=False, banded=0.0):
    """tests/test_panels_plan.py's generator: a random (optionally banded,
    hub-skewed) pattern with sym-normalized, rank-1 values."""
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
    dense = (dense > 0).astype(np.float32)
    dr, dc = dense.sum(1), dense.sum(0)
    with np.errstate(divide="ignore"):
        r = np.where(dr > 0, dr ** -0.5, 0.0).astype(np.float32)
        c = np.where(dc > 0, dc ** -0.5, 0.0).astype(np.float32)
    return dense * r[:, None] * c[None, :]


def _per_edge_coo():
    """A random non-community matrix with mixed-sign values: no rank-1
    factorization, duplicates summed (tests/test_panels_plan.py)."""
    rng = np.random.default_rng(41)
    n, m, nnz = 700, 900, 12000
    return (rng.integers(0, n, nnz).astype(np.int32), rng.integers(0, m, nnz).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32), (n, m))


def _dup_csr(cls):
    """An unweighted CSR with duplicate (row, col) entries: the raw values
    factor rank-1 (all ones), so duplicates ride the scattered path."""
    rng = np.random.default_rng(19)
    n = 384
    indptr, cols = [0], []
    for _ in range(n):
        c = np.sort(rng.choice(n, rng.integers(1, 12)))  # with repeats
        cols.extend(c.tolist())
        indptr.append(len(cols))
    return cls(indptr=np.asarray(indptr, np.int64), cols=np.asarray(cols, np.int32),
               vals=np.ones(len(cols), np.float32), shape=(n, n))


# name -> (matrix maker, build kwargs). Matrix makers return (port CSR,
# JAX CSR, dense float64).
def _dense_case(*args, **kw):
    def make():
        d = _graph(*args, **kw)
        return CSR.from_dense(d), JCSR.from_dense(d), d.astype(np.float64)
    return make


def _per_edge_case():
    rows, cols, vals, shape = _per_edge_coo()
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    return (CSR.from_coo(COO.from_arrays(rows, cols, vals, shape)),
            JCSR.from_coo(JCOO.from_arrays(rows, cols, vals, shape)), dense)


def _dup_case():
    a, b = _dup_csr(CSR), _dup_csr(JCSR)
    dense = np.zeros(a.shape, np.float64)
    np.add.at(dense, (np.repeat(np.arange(a.shape[0]), np.diff(a.indptr)), a.cols), 1.0)
    return a, b, dense


PLAN_CASES = {
    "single_range": (_dense_case(768, 768, 0.02, seed=3), dict(T=256, hot_budget=0)),
    "switching_scattered": (_dense_case(1024, 1024, 0.004, seed=5, banded=0.3),
                            dict(T=256, hot_budget=0, range_cap=256)),
    "hot_skew": (_dense_case(900, 900, 0.01, skew=True, seed=7, banded=0.2),
                 dict(T=256, hot_budget=512, hot_min_run=2, range_cap=256)),
    "multi_segment": (_dense_case(1024, 1024, 0.01, seed=9, banded=0.3),
                      dict(T=256, hot_budget=0, range_cap=256, seg_steps=8)),
    "overflow_pieces": (_dense_case(512, 2048, 0.15, seed=11),
                        dict(T=256, hot_budget=0, range_cap=256, s_cap=256)),
    "big_chunks": (_dense_case(256, 8192, 0.2, seed=13),
                   dict(T=256, hot_budget=0, range_cap=256, s_cap=4096)),
    "min_block_1": (_dense_case(512, 512, 0.003, seed=15),
                    dict(T=256, hot_budget=0, range_cap=512, min_block=1)),
    "min_block_64": (_dense_case(512, 512, 0.003, seed=15),
                     dict(T=256, hot_budget=0, range_cap=512, min_block=64)),
    "direct_rows": (_dense_case(1000, 1000, 0.008, skew=True, seed=3, banded=0.3),
                    dict(T=256, hot_budget=256, hot_min_run=1, range_cap=256, seg_steps=12,
                         direct_quota=4)),
    "per_edge": (_per_edge_case, dict(T=1024, per_edge=True)),
    "duplicates": (_dup_case, dict(T=256, hot_budget=0, range_cap=256)),
    "defaults": (_dense_case(1100, 1000, 0.01, seed=23, banded=0.3), {}),
}

_SEG_FIELDS = ("ctrl", "rcopy", "dsrc", "blk", "tile_of", "stage_take", "stage_scale",
               "mask_counts")
_PLAN_FIELDS = ("shape", "R", "T", "RC", "S_buf", "RMAX", "RQ", "n_ranges", "n_range_rows",
                "n_scattered", "n_groups", "n_direct")


def _assert_plans_equal(p, j):
    for f in _PLAN_FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    for f in ("hot_ids", "row_scale", "col_scale"):
        np.testing.assert_array_equal(getattr(p, f), np.asarray(getattr(j, f)), err_msg=f)
    assert len(p.segments) == len(j.segments)
    for ps, js in zip(p.segments, j.segments):
        assert (ps.n_steps, ps.n_tiles) == (js.n_steps, js.n_tiles)
        for f in _SEG_FIELDS:
            a, b = getattr(ps, f), getattr(js, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
        np.testing.assert_array_equal(
            tpanels._expand_masks_np(ps.mask_edges, ps.mask_counts),
            jpanels._expand_masks_np(js.mask_edges, js.mask_counts))


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_equals_jax(case):
    make, kw = PLAN_CASES[case]
    csr, jcsr, _ = make()
    plan = tpanels.build_panels_plan(csr, **kw)
    _assert_plans_equal(plan, jpanels.build_panels_plan(jcsr, **kw))
    if case == "direct_rows":
        assert plan.n_direct > 0 and plan.n_hot > 0 and len(plan.segments) > 1
    if case == "duplicates":
        assert plan.n_scattered > 0 and plan.n_groups > 0


def test_plan_without_native_pass1_is_equal(monkeypatch):
    """The numpy branch (no native library) builds the same plan: the
    compact edges differ in order only, so the expanded masks agree."""
    make, kw = PLAN_CASES["hot_skew"]
    csr, _, _ = make()
    with_native = tpanels.build_panels_plan(csr, **kw)
    monkeypatch.setattr(native, "expansion_pass1", lambda *a, **k: None)
    _assert_plans_equal(tpanels.build_panels_plan(csr, **kw), with_native)


def test_plan_t_flag_and_non_rank1_refusal(monkeypatch):
    """OFS_FUSED_T forces T in both packages alike; values that do not
    factor rank-1 are refused unless per_edge=True."""
    csr, jcsr, _ = PLAN_CASES["switching_scattered"][0]()
    monkeypatch.setenv("OFS_FUSED_T", "512")
    plan = tpanels.build_panels_plan(csr, hot_budget=0)
    assert plan.T == 512
    _assert_plans_equal(plan, jpanels.build_panels_plan(jcsr, hot_budget=0))
    monkeypatch.delenv("OFS_FUSED_T")
    rng = np.random.default_rng(17)
    dense = ((rng.random((256, 256)) < 0.05) * rng.random((256, 256))).astype(np.float32)
    with pytest.raises(ValueError, match="rank-1"):
        tpanels.build_panels_plan(CSR.from_dense(dense), T=256)


@pytest.mark.parametrize("case", ["hot_skew", "per_edge", "direct_rows"])
def test_mask_expansion_matches_jax(case):
    """ensure_masks on the host, and the scatter-add expansion that
    placement runs on the target device, against the JAX package's."""
    make, kw = PLAN_CASES[case]
    csr, jcsr, _ = make()
    plan = tpanels.build_panels_plan(csr, **kw)
    jplan = jpanels.ensure_masks(jpanels.build_panels_plan(jcsr, **kw))
    on_host = tpanels.ensure_masks(plan)
    on_dev = tpanels.ensure_masks(plan, device="cpu")
    for a, b, j in zip(on_host.segments, on_dev.segments, jplan.segments):
        assert a.mask_edges is None and b.mask_counts is None
        np.testing.assert_array_equal(a.masks, np.asarray(j.masks))
        assert isinstance(b.masks, torch.Tensor) and b.masks.dtype == torch.int32
        np.testing.assert_array_equal(b.masks.numpy(), np.asarray(j.masks))
    # placement checks each bit from the compact edges: a plan expanded
    # before it is refused, and a placed plan (windows attached, masks
    # expanded) places again and computes the same product
    with pytest.raises(ValueError, match="compact mask edges"):
        _placed(on_host)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (csr.shape[1], 6)).astype(np.float32))
    once = _placed(plan)
    np.testing.assert_array_equal(panel_spmm_torch(_placed(once), x).numpy(),
                                  panel_spmm_torch(once, x).numpy())


def _placed(plan):
    return place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=plan.shape),
                          "cpu").binned


@pytest.mark.parametrize("case,d", [("hot_ranges_segments_direct", 8),
                                    ("hot_ranges_segments_direct", 160),
                                    ("big_chunks", 8), ("big_chunks", 160)])
def test_plain_version_matches_jax_kernel(case, d):
    """panel_spmm_torch on the placed plan (window provenance, masks
    expanded by the scatter-add) against the JAX Pallas kernel in
    interpret mode, both step oracles and the dense product."""
    if case == "big_chunks":
        dense = _graph(256, 8192, 0.2, seed=27)
        kw = dict(T=256, hot_budget=0, range_cap=256, s_cap=4096)
    else:
        dense = _graph(640, 640, 0.01, seed=15, banded=0.3)
        kw = dict(T=256, hot_budget=256, hot_min_run=1, range_cap=256, seg_steps=16,
                  direct_quota=4)
    plan = tpanels.build_panels_plan(CSR.from_dense(dense), **kw)
    jplan = jpanels.build_panels_plan(JCSR.from_dense(dense), **kw)
    if case == "big_chunks":
        assert plan.S_buf >= 2048
        assert max(int(s.ctrl[:, 0, tpanels.C_SBIG].max()) for s in plan.segments) > 0
    else:
        assert plan.n_hot and plan.n_direct and plan.n_ranges > 1 and len(plan.segments) > 1
    x = np.random.default_rng(2).standard_normal((dense.shape[1], d)).astype(np.float32)
    got = panel_spmm_torch(_placed(plan), torch.from_numpy(x)).numpy()
    want = np.asarray(spmm_panels(jplan, jnp.asarray(x), interpret=True))
    _close(got, want)
    _close(got, dense @ x)
    if d == 8:
        _close(simulate(plan, x), np.asarray(jsimulate(jplan, x)))
        _close(simulate(plan, x), got)


def test_unit_plain_version_matches_jax_kernel(monkeypatch):
    """The kernel's split into work units (sparse/panels.py work_units),
    run by its plain version ``panel_spmm_units_torch`` at an edge cap
    low enough that the hub-heavy tiles split (partials, row-scaled,
    summed per tile), against the JAX Pallas kernel in interpret mode,
    the unsplit plain version and the dense product."""
    dense = _graph(512, 768, 0.01, skew=True, seed=21, banded=0.2)
    kw = dict(T=256, hot_budget=256, hot_min_run=1, range_cap=256)
    monkeypatch.setattr(tpanels, "UNIT_EDGES", 64)
    placed = _placed(tpanels.build_panels_plan(CSR.from_dense(dense), **kw))
    assert sum(int(s.windows.split_tiles.shape[0]) for s in placed.segments) > 1
    jplan = jpanels.build_panels_plan(JCSR.from_dense(dense), **kw)
    x = np.random.default_rng(8).standard_normal((dense.shape[1], 8)).astype(np.float32)
    got = panel_spmm_units_torch(placed, torch.from_numpy(x)).numpy()
    _close(got, np.asarray(spmm_panels(jplan, jnp.asarray(x), interpret=True)))
    _close(got, panel_spmm_torch(placed, torch.from_numpy(x)).numpy())
    _close(got, dense @ x)


@pytest.mark.parametrize("case", ["per_edge", "duplicates", "multi_segment", "overflow_pieces",
                                  "defaults"])
def test_plain_version_matches_dense(case):
    """The plain version against the dense product on the other plan
    shapes: per-edge values (the port's step oracle applies stage_scale;
    the JAX one does not), duplicate edges, several segments, tiles split
    into pieces, the default parameters."""
    make, kw = PLAN_CASES[case]
    csr, _, dense = make()
    plan = tpanels.build_panels_plan(csr, **kw)
    x = np.random.default_rng(4).standard_normal((csr.shape[1], 12)).astype(np.float32)
    got = panel_spmm_torch(_placed(plan), torch.from_numpy(x)).numpy()
    _close(got, dense @ x)
    _close(simulate(plan, x), dense @ x)


def test_windows_resolve_range_rows_from_rcopy():
    """The range window of a step holds the chunk starts that rcopy wrote
    (clip included), one window per first-of-range step; the scattered
    region starts at the tile's slice of stage_take."""
    dense = _graph(1000, 1000, 0.008, skew=True, seed=3, banded=0.3)
    plan = tpanels.build_panels_plan(CSR.from_dense(dense), T=256, hot_budget=256,
                                     hot_min_run=1, range_cap=256, seg_steps=12,
                                     direct_quota=4)
    for seg in plan.segments:
        win = tpanels.segment_windows(plan, seg)
        ctrl = seg.ctrl[:, 0, :]
        comp = ctrl[:, tpanels.C_TILE] >= 0
        first_of_range = comp & (ctrl[:, tpanels.C_RFIRST] == 1)
        assert win.range_rows.shape == (first_of_range.sum(), plan.RC // plan.RQ)
        copied = set(seg.rcopy[:, 0, :][seg.rcopy[:, 0, :] > 0].tolist()) | {0}
        assert set(win.range_rows.ravel().tolist()) <= copied
        tiles = ctrl[comp, tpanels.C_TILE]
        assert np.array_equal(np.diff(win.tile_steps), np.bincount(tiles, minlength=seg.n_tiles))
        firsts = np.nonzero(comp & (ctrl[:, tpanels.C_TFIRST] == 1))[0]
        assert np.array_equal(win.step_win[firsts, 2] + win.step_win[firsts, 4],
                              ctrl[firsts, tpanels.C_SEXT])


def test_attach_windows_refuses_a_bit_naming_nothing():
    """A mask bit past its tile's scattered region names no row of X: a
    plan bug that placement refuses (the kernel would read a zero)."""
    dense = _graph(512, 2048, 0.15, seed=11)
    plan = tpanels.build_panels_plan(CSR.from_dense(dense), T=256, hot_budget=0,
                                     range_cap=256, s_cap=256)
    seg = plan.segments[0]
    step = int(np.nonzero(seg.ctrl[:, 0, tpanels.C_TFIRST])[0][0])
    blk = seg.blk.copy()
    blk[step, 0, 0] = (plan.n_hot + plan.RC) // 128 + plan.S_buf // 128 + 1
    bad = dataclasses.replace(plan, segments=(dataclasses.replace(seg, blk=blk),)
                              + plan.segments[1:])
    with pytest.raises(ValueError, match="resolves to no row"):
        tpanels.attach_windows(bad)


def test_plan_memory_report_and_hbm():
    dense = _graph(1024, 1024, 0.01, seed=31, banded=0.3)
    plan = tpanels.build_panels_plan(CSR.from_dense(dense), T=256, hot_budget=256,
                                     hot_min_run=1, range_cap=256)
    jplan = jpanels.build_panels_plan(JCSR.from_dense(dense), T=256, hot_budget=256,
                                      hot_min_run=1, range_cap=256)
    rep = tpanels.plan_memory_report(plan, d=128, hbm_limit=16 << 30)
    assert set(rep) == set(jpanels.plan_memory_report(jplan, d=128, hbm_limit=16 << 30))
    assert rep["fits"] and rep["max_table_bytes"] == 0
    assert not tpanels.plan_memory_report(plan, d=128, hbm_limit=1 << 20)["fits"]
    FLAGS.override("OFS_HBM_BYTES", 12345)
    try:
        assert device_hbm_bytes() == 12345
    finally:
        FLAGS.override("OFS_HBM_BYTES", None)
    if not torch.cuda.is_available():
        assert device_hbm_bytes() == 80 * 10**9  # the H100's, on a host without a card


def test_default_t_quirk_matches_jax():
    for nnz, n in [(10, 100), (10, 1024 * 128), (10, 1023 * 128 + 1), (8_000_000, 10)]:
        assert tpanels.default_panels_t(nnz, n) == jpanels.default_panels_t(nnz, n)


# ---------------------------------------------------------------------------
# the operator and the GCN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rank1", "per_edge"])
def test_operator_matches_jax(case):
    """make_operator(layout="panels") then spmm against the JAX package's
    operator (Pallas interpret); op.T against the dense transpose."""
    rng = np.random.default_rng(43)
    if case == "rank1":
        dense = _graph(600, 600, 0.02, seed=21, banded=0.2)
    else:  # a random non-rank-1 matrix: the per-edge fallback
        n = 500
        dense = (rng.random((n, n)) < 0.02).astype(np.float32)
        dense *= rng.standard_normal((n, n)).astype(np.float32)
    op = make_operator(CSR.from_dense(dense), layout="panels", device="cpu")
    jop = jmake_operator(JCSR.from_dense(dense), layout="panels", place=False)
    assert op.binned.per_edge == (case == "per_edge")
    assert not op.transpose_aliased  # neither matrix is symmetric
    x = rng.standard_normal((dense.shape[1], 16)).astype(np.float32)
    w = rng.standard_normal((dense.shape[0], 16)).astype(np.float32)
    want = np.asarray(jspmm(jop, jnp.asarray(x)))
    before = dict(cuda_build.LAUNCHES)
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain version
        with torch.no_grad():
            got = spmm(op, torch.from_numpy(x), impl=impl).numpy()
        _close(got, want)
    assert cuda_build.LAUNCHES == before
    _close(want, dense @ x)
    with torch.no_grad():
        _close((op.T @ torch.from_numpy(w)).numpy(), dense.T @ w)


def test_gcn_logits_match_jax():
    """GCN inference through layout="panels" on synthetic cora (2708
    nodes, symmetric: the transpose plan is aliased), narrow features so
    the interpreted JAX kernel stays quick; weights carried over."""
    csr, _ = load_graph("cora", symmetrize=True)
    jcsr, _ = jload_graph("cora", symmetrize=True)
    a_hat, ja_hat = normalized_adjacency(csr), jnormalized_adjacency(jcsr)
    x = np.random.default_rng(6).standard_normal((csr.shape[0], 24)).astype(np.float32)
    dims = (24, 16, 7)
    op = make_operator(a_hat, layout="panels", device="cpu")
    jop = jmake_operator(ja_hat, layout="panels", place=False)
    assert op.transpose_aliased and op.binned_t is op.binned and not op.binned.per_edge
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    want = np.asarray(jmodel.apply(params, jop, jnp.asarray(x)))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = model(op, torch.from_numpy(x)).numpy()
    assert got.shape == (csr.shape[0], dims[-1])
    _close(got, want)


def test_refusals():
    """reorder= plans the relabeled matrix and maps x in and y out (its
    refusal on the other layouts: tests/test_torch_reorder.py); without a
    card and without a device the operator raises; the wrapper takes only
    a placed plan and float32 x of the right height."""
    dense = _graph(200, 200, 0.05, seed=1)
    csr = CSR.from_dense(dense)
    rop = make_operator(csr, layout="panels", reorder="bfs", device="cpu")
    assert rop.relabeled and isinstance(rop.binned, tpanels.PanelPlan)
    xr = torch.from_numpy(np.random.default_rng(2).standard_normal((200, 4)).astype(np.float32))
    np.testing.assert_allclose(spmm(rop, xr).numpy(), dense @ xr.numpy(), rtol=RTOL,
                               atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_operator(csr, layout="panels")
    plan = tpanels.build_panels_plan(csr, T=256)
    x = torch.zeros((200, 4))
    with pytest.raises(ValueError, match="not placed"):
        panel_spmm(plan, x)
    placed = _placed(plan)
    with pytest.raises(TypeError):
        panel_spmm(placed, x.double())
    with pytest.raises(ValueError, match="rows"):
        panel_spmm(placed, torch.zeros((199, 4)))
