"""The expansion kernel's work list (sparse/expansion.py ``lane_work``, cut
by sparse/panels.py ``work_units``; ``LaneWork`` on both engines' plans)
and its unit-by-unit plain version, without JAX at import, so that the
file also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_expansion_work.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU, for v1 and v2 (rank-1 and general) plans with
several groups and tiers, hub columns (output blocks cut into several
units), empty tiles and non-square matrices, cut at small lane caps: the
work list holds every real lane once and no padding lane, in its output
block's run, sorted by row; no unit exceeds the cap; a block's units run
together, blocks heaviest first; every output block has a unit, a block
without lanes exactly one empty unit, and the split blocks are those
with several;
``expansion_units_torch`` (each unit's partial sum, row-scaled, added per
block) equals the plain versions; and on cases without empty tiles it
equals the JAX kernels in interpret mode. The ``cuda``-marked test holds
both kernels against their plain versions on the card, on these split
plans, at d % 4 == 0 (float4 path) and d % 4 != 0 (scalar path), and
counts one launch per SpMM.
"""

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops import place_plan
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda import expansion as ek
from of_spmm_tpu_torch.ops.cuda import expansion2 as e2k
from of_spmm_tpu_torch.sparse import expansion as texp
from of_spmm_tpu_torch.sparse import expansion2 as texp2
from of_spmm_tpu_torch.sparse.formats import COO, CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _graph(n, m, seed, per_row=3, hubs=0, general=False, empty=None):
    """A seeded pattern: random entries and ``hubs`` columns that most rows
    meet (so an output block holds many lanes and splits into units);
    symmetric-normalized (rank-1) or standard-normal values with
    duplicate entries; rows in ``empty`` hold nothing."""
    rng = np.random.default_rng(seed)
    k = rng.poisson(per_row, n)
    r = [np.repeat(np.arange(n), k)]
    c = [rng.integers(0, m, int(k.sum()))]
    if hubs:
        hub = rng.choice(m, hubs, replace=False)
        hr, hh = np.nonzero(rng.random((n, hubs)) < 0.6)
        r.append(hr)
        c.append(hub[hh])
    rows, cols = np.concatenate(r).astype(np.int64), np.concatenate(c).astype(np.int64)
    if empty is not None:
        keep = (rows < empty.start) | (rows >= empty.stop)
        rows, cols = rows[keep], cols[keep]
    if general:
        dup = rows.shape[0] // 10
        rows, cols = np.r_[rows, rows[:dup]], np.r_[cols, cols[:dup]]
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    else:
        key = np.unique(rows * m + cols)
        rows, cols = key // m, key % m
        dr = np.bincount(rows, minlength=n).astype(np.float64)
        dc = np.bincount(cols, minlength=m).astype(np.float64)
        vals = (dr[rows] ** -0.5 * dc[cols] ** -0.5).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows.astype(np.int32), cols.astype(np.int32), vals,
                                        (n, m)))


# name -> (plan build, graph, build kwargs, lane cap)
CASES = {
    "v1_general_groups_tiers": (texp.build_expansion_plan,
                                lambda: _graph(700, 900, 1, per_row=6, hubs=8, general=True),
                                dict(R=128, TILE=256, CW=256, stage_tier=256, stage_budget=1024),
                                64),
    "v1_hubs_r256": (texp.build_expansion_plan, lambda: _graph(800, 800, 2, hubs=24),
                     dict(R=256, TILE=256, CW=256), 256),
    "v1_empty_tile_nonsquare": (texp.build_expansion_plan,
                                lambda: _graph(500, 700, 3, per_row=4, empty=slice(128, 320)),
                                dict(R=128, TILE=256, CW=128, stage_tier=256), 96),
    "v2_rank1_hubs": (texp2.build_expansion2_plan, lambda: _graph(800, 800, 4, hubs=24),
                      dict(R=256, G=2), 200),
    "v2_general_groups_tiers": (texp2.build_expansion2_plan,
                                lambda: _graph(600, 700, 5, per_row=6, hubs=6, general=True),
                                dict(R=128, G=4, stage_tier=256, stage_budget=512), 64),
    "v2_rank1_empty_tile_nonsquare": (texp2.build_expansion2_plan,
                                      lambda: _graph(500, 300, 6, per_row=4,
                                                     empty=slice(130, 390)),
                                      dict(R=64, G=2, stage_tier=128), 48),
}


def _plan(case, device="cpu"):
    """The case's compact plan, its CSR and the plan placed with its work
    list cut at the case's lane cap."""
    build, make, kw, cap = CASES[case]
    csr = make()
    plan = build(csr, **kw)
    return plan, csr, place_plan(plan, device, max_lanes=cap)


def _reals(plan):
    """Each group's real lanes (flat indices) and their output rows."""
    out = []
    tile0 = 0
    for g in plan.groups:
        if isinstance(plan, texp2.Expansion2Plan):
            _u, real = texp2.lane_stage_pos(g, plan.R)
            per_step = plan.G * 128
        else:
            _u, real = texp.lane_stage_pos(g, plan.CW)
            per_step = plan.TILE
        e = np.nonzero(real)[0]
        rows = (tile0 + g.tile_of.astype(np.int64)[e // per_step]) * plan.R \
            + g.lrow.reshape(-1)[e].astype(np.int64)
        out.append((e, rows))
        tile0 += g.n_tiles
    return out


def _work(placed):
    w = placed.work
    units = w.units.numpy().astype(np.int64)
    key = np.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
    return w.lanes.numpy().astype(np.int64), units, w.split_keys.numpy(), key


def test_cases_have_what_they_are_here_for():
    for case in CASES:
        plan, csr, placed = _plan(case)
        _lanes, units, split, key = _work(placed)
        assert split.shape[0] > 0, case  # every case cuts some block into units
        nwb = -(-plan.R // 128)
        if "groups" in case:
            assert len(plan.groups) > 1 and max(len(g.stage_tier_ptr) for g in plan.groups) > 2
        if "empty" in case:
            assert plan.shape[0] != plan.shape[1]
            assert (units[:, 1] == units[:, 2]).sum() >= 1  # blocks without lanes
        if "rank1" in case:
            assert plan.rank1
        if "r256" in case:
            assert nwb == 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_work_list_holds_every_real_lane_once_in_its_block(case):
    plan, _csr, placed = _plan(case)
    lanes, units, _split, key = _work(placed)
    nwb = -(-plan.R // 128)
    reals = _reals(plan)
    seen = [np.zeros(g.lrow.size, np.int64) for g in plan.groups]
    for (k, a, b, gi), kk in zip(units, key):
        e = lanes[a:b]
        seen[gi][e] += 1
        rows = reals[gi][1][np.searchsorted(reals[gi][0], e)]
        assert np.isin(e, reals[gi][0]).all()  # no padding lane
        assert (rows // plan.R * nwb + rows % plan.R // 128 == kk).all()  # its block
        assert (np.diff(rows) >= 0).all()  # sorted by row
    for s, (e, _rows) in zip(seen, reals):
        assert (s[e] == 1).all() and s.sum() == e.shape[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_hold_the_cap_run_key_by_key_heaviest_first_and_cover_every_block(case):
    plan, _csr, placed = _plan(case)
    _lanes, units, split, key = _work(placed)
    cap = CASES[case][3]
    size = units[:, 2] - units[:, 1]
    assert (size <= cap).all() and placed.work.E == cap
    starts = np.r_[True, key[1:] != key[:-1]]
    assert np.unique(key).shape[0] == starts.sum()  # a key's units run together
    key_lanes = np.add.reduceat(size, np.nonzero(starts)[0])
    assert (np.diff(key_lanes) <= 0).all()  # keys heaviest first
    for a, b in zip(np.nonzero(starts)[0], np.r_[np.nonzero(starts)[0][1:], key.shape[0]]):
        assert (np.diff(size[a:b]) <= 0).all()  # a key's units heaviest first
    per_key = np.bincount(key, minlength=plan.n_tiles * -(-plan.R // 128))
    assert per_key.shape[0] == plan.n_tiles * -(-plan.R // 128) and (per_key >= 1).all()
    assert np.array_equal(split, np.nonzero(per_key > 1)[0])
    assert np.array_equal(units[:, 0] < 0, per_key[key] > 1)
    empty = size == 0
    assert (per_key[key[empty]] == 1).all()  # a block without lanes: one empty unit


@pytest.mark.parametrize("case", sorted(CASES))
def test_unit_plain_version_equals_plain_version(case):
    _plan_, _csr, placed = _plan(case)
    plain = e2k.expansion2_spmm_torch if case.startswith("v2") else ek.expansion_spmm_torch
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((placed.shape[1], 13))
                         .astype(np.float32))
    want = plain(placed, x).numpy()
    got = ek.expansion_units_torch(placed, x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


@pytest.mark.parametrize("case", ["v1_general_groups_tiers", "v2_rank1_hubs",
                                  "v2_general_groups_tiers"])
def test_unit_plain_version_matches_jax_kernel(case):
    """The unit version of each engine against the JAX kernel in
    interpret mode, at the JAX tests' tolerance (tests/test_expansion.py:
    the TPU kernel drops the vl * lo term). No empty tile: the JAX v1
    kernel never writes one."""
    import jax.numpy as jnp
    from of_spmm_tpu.ops.pallas.expansion import spmm_expansion as jspmm_expansion
    from of_spmm_tpu.ops.pallas.expansion2 import spmm_expansion2 as jspmm_expansion2
    from of_spmm_tpu.sparse import expansion as jexp
    from of_spmm_tpu.sparse import expansion2 as jexp2
    from of_spmm_tpu.sparse.formats import CSR as JCSR

    build, _make, kw, _cap = CASES[case]
    _plan_, csr, placed = _plan(case)
    jcsr = JCSR(indptr=csr.indptr, cols=csr.cols, vals=csr.vals, shape=csr.shape)
    x = np.random.default_rng(9).standard_normal((csr.shape[1], 8)).astype(np.float32)
    if case.startswith("v2"):
        want = jspmm_expansion2(jexp2.build_expansion2_plan(jcsr, **kw), jnp.asarray(x),
                                interpret=True)
    else:
        want = jspmm_expansion(jexp.build_expansion_plan(jcsr, **kw), jnp.asarray(x),
                               interpret=True)
    got = ek.expansion_units_torch(placed, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=5e-4)


@pytest.mark.cuda
def test_expansion_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    names = {"v1": "expansion_spmm", "v2": "expansion2_spmm"}
    kernels = {"v1": (ek.expansion_spmm, ek.expansion_spmm_torch),
               "v2": (e2k.expansion2_spmm, e2k.expansion2_spmm_torch)}
    before = {v: cuda_build.LAUNCHES[n] for v, n in names.items()}
    calls = dict.fromkeys(names, 0)
    for case in sorted(CASES):
        engine = case[:2]
        _plan_, _csr, placed = _plan(case, dev)
        for d in (128, 60, 7):
            x = torch.randn((placed.shape[1], d), generator=gen).to(dev)
            kernel, plain = kernels[engine]
            got, want = kernel(placed, x), plain(placed, x)
            torch.cuda.synchronize()
            calls[engine] += 1
            err = (got - want).abs()
            assert torch.isfinite(got).all()
            assert bool((err <= 1e-5 + 1e-4 * want.abs()).all()), (case, d, float(err.max()))
    for v, n in names.items():  # one launch a SpMM, never the plain version
        assert cuda_build.LAUNCHES[n] == before[v] + calls[v]
