"""The panel kernel's work list (sparse/panels.py ``work_units``) and its
unit-by-unit plain version, without JAX, so that the file also runs on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_panel_work.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU: the work list covers every group slot with mask bits
once, in step order, cuts no unit above the edge cap unless it is one
slot, and lists units heaviest first; ``panel_spmm_units_torch`` (each
unit's partial sum, row-scaled, added per tile) equals
``panel_spmm_torch``. tests/test_torch_panels.py holds the unit version
against the JAX kernel. The ``cuda``-marked test holds the kernel against
the plain version on the card, on plans whose tiles are cut into several
units, at d % 4 == 0 (float4 path) and d % 4 != 0 (scalar path).
"""

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops import place_operator
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.panels import (
    panel_spmm, panel_spmm_torch, panel_spmm_units_torch)
from of_spmm_tpu_torch.sparse import panels as tpanels
from of_spmm_tpu_torch.sparse.formats import COO, CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _hub_graph(n, m, seed, per_row=3, hubs=24, band=16):
    """A seeded pattern with hub columns that most rows meet (so a tile's
    slots hold thousands of edges and split into units), a band and
    random entries; symmetric-normalized, hence rank-1, values."""
    rng = np.random.default_rng(seed)
    k = rng.poisson(per_row, n)
    r = [np.repeat(np.arange(n), k), np.repeat(np.arange(n), band)]
    c = [rng.integers(0, m, int(k.sum())),
         np.clip(r[1] * m // n - 64 + rng.integers(0, 128, r[1].shape[0]), 0, m - 1)]
    hub = rng.choice(m, hubs, replace=False)
    hr, hh = np.nonzero(rng.random((n, hubs)) < 0.6)
    r.append(hr)
    c.append(hub[hh])
    key = np.unique(np.concatenate(r).astype(np.int64) * m + np.concatenate(c))
    rows, cols = key // m, key % m
    dr = np.bincount(rows, minlength=n).astype(np.float64)
    dc = np.bincount(cols, minlength=m).astype(np.float64)
    vals = (dr[rows] ** -0.5 * dc[cols] ** -0.5).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows.astype(np.int32), cols.astype(np.int32), vals,
                                        (n, m)))


# name -> (graph, build kwargs, unit edge cap)
CASES = {
    "hubs_split": (lambda: _hub_graph(700, 2000, 1), dict(T=256, hot_budget=256, hot_min_run=1,
                                                         range_cap=512, seg_steps=16), 96),
    "hubs_one_slot_units": (lambda: _hub_graph(700, 2000, 2), dict(T=512, hot_budget=0,
                                                                  range_cap=256), 1),
    "defaults": (lambda: _hub_graph(900, 900, 3, hubs=8), {}, 2048),
    "per_edge": (lambda: _hub_graph(300, 1500, 4, hubs=4), dict(T=512, per_edge=True), 128),
}


def _plan(case, monkeypatch, device="cpu"):
    """The case's compact plan, and the plan placed with its work list cut
    at the case's edge cap."""
    make, kw, cap = CASES[case]
    monkeypatch.setattr(tpanels, "UNIT_EDGES", cap)
    plan = tpanels.build_panels_plan(make(), **kw)
    placed = place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=plan.shape),
                            device).binned
    return plan, placed, cap


def _units_np(seg):
    win = seg.windows
    return (np.asarray(win.unit_slots).astype(np.int64), np.asarray(win.units).astype(np.int64),
            np.asarray(win.split_tiles).astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_work_list_covers_every_slot_once_in_step_order(case, monkeypatch):
    plan, placed, _cap = _plan(case, monkeypatch)
    G = plan.T // 128
    for seg, pseg in zip(plan.segments, placed.segments):
        slots, units, split = _units_np(pseg)
        counts = np.asarray(seg.mask_counts)
        assert np.array_equal(slots, np.nonzero(counts)[0])  # every slot with bits, in order
        tile = np.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
        step_tile = seg.ctrl[:, 0, tpanels.C_TILE]
        covered = np.zeros(slots.shape[0], np.int64)
        for t, a, b in zip(tile, units[:, 1], units[:, 2]):
            covered[a:b] += 1
            assert (step_tile[slots[a:b] // G] == t).all()  # a unit stays in its tile
        assert (covered == 1).all()
        # every tile has a unit, and a split tile is exactly one with several
        per_tile = np.bincount(tile, minlength=seg.n_tiles)
        assert (per_tile >= 1).all() and per_tile.shape[0] == seg.n_tiles
        assert np.array_equal(split, np.nonzero(per_tile > 1)[0])
        assert np.array_equal(units[:, 0] < 0, per_tile[tile] > 1)
        # a tile's units, taken by their first slot, tile its slot list in order
        for t in range(seg.n_tiles):
            mine = units[tile == t]
            mine = mine[np.argsort(mine[:, 1])]
            assert (mine[1:, 1] == mine[:-1, 2]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_hold_the_edge_cap_and_run_heaviest_first(case, monkeypatch):
    plan, placed, cap = _plan(case, monkeypatch)
    split_seen = False
    for seg, pseg in zip(plan.segments, placed.segments):
        slots, units, split = _units_np(pseg)
        edges = np.r_[0, np.cumsum(np.asarray(seg.mask_counts).astype(np.int64)[slots])]
        weight = edges[units[:, 2]] - edges[units[:, 1]]
        size = units[:, 2] - units[:, 1]
        assert ((weight <= cap) | (size == 1)).all()
        assert (np.diff(weight) <= 0).all()
        # greedy: each unit of a tile but its last could not take the next slot
        tile = np.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
        for t in np.unique(tile):
            mine = units[tile == t]
            mine = mine[np.argsort(mine[:, 1])]
            for a, b in mine[:-1, 1:]:
                assert edges[b + 1] - edges[a] > cap
        split_seen |= split.shape[0] > 0
    if case.startswith("hubs"):
        assert split_seen


def test_work_units_refuses_a_bad_cap_and_handles_no_edges():
    with pytest.raises(ValueError, match="positive"):
        tpanels.work_units(np.zeros(2, np.int32), np.ones(4, np.int32), 2, 1, 0)
    slots, units, split = tpanels.work_units(np.array([0, -1, 1]), np.zeros(6, np.int32), 2, 3,
                                             16)
    assert slots.shape == (0,) and split.shape == (0,)
    assert units.tolist() == [[0, 0, 0], [1, 0, 0], [2, 0, 0]]  # each tile writes its zeros


@pytest.mark.parametrize("case", sorted(CASES))
def test_unit_plain_version_equals_plain_version(case, monkeypatch):
    _plan_, placed, _cap = _plan(case, monkeypatch)
    x = np.random.default_rng(5).standard_normal((placed.shape[1], 13)).astype(np.float32)
    want = panel_spmm_torch(placed, torch.from_numpy(x)).numpy()
    got = panel_spmm_units_torch(placed, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


@pytest.mark.cuda
def test_panel_kernel_matches_plain_version_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    launches = cuda_build.LAUNCHES["panel_spmm"]
    calls = 0
    for case in sorted(CASES):
        _plan_, placed, _cap = _plan(case, monkeypatch, dev)
        for d in (128, 256, 60, 7):
            x = torch.randn((placed.shape[1], d), generator=gen).to(dev)
            got = panel_spmm(placed, x)
            want = panel_spmm_torch(placed, x)
            torch.cuda.synchronize()
            calls += len(placed.segments)
            err = (got - want).abs()
            assert torch.isfinite(got).all()
            assert bool((err <= 1e-5 + 1e-4 * want.abs()).all()), (case, d, float(err.max()))
    assert cuda_build.LAUNCHES["panel_spmm"] == launches + calls  # never the plain version
