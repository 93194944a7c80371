"""The fused and ranges kernels' work list (sparse/staged_windows.py
``work_list``, cut by sparse/panels.py ``work_units``) and their
unit-by-unit plain version, without JAX, so that the file also runs on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_staged_work.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU, for fused (rows and chunks staging, window mode, tiles
of 256 rows, general values) and ranges (hot rows, a range past the end
of x, scattered pieces, general values) plans cut at a small selection
cap: the work list covers every group slot with a real selection once, in
step order; no unit exceeds the cap unless it is one slot; units run
heaviest first; every key (tile, or window block) without selections has
one empty unit; ``staged_spmm_units_torch`` (each unit's partial sum,
row-scaled, added per key) equals ``staged_spmm_torch``.
tests/test_torch_fused.py and tests/test_torch_ranges.py hold the unit
version against the JAX kernels. The ``cuda``-marked test holds both
kernels against their plain versions on the card, on these split plans,
at d % 4 == 0 (float4 path) and d % 4 != 0 (scalar path).
"""

import dataclasses

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops import place_operator
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.fused import fused_spmm
from of_spmm_tpu_torch.ops.cuda.ranges import ranges_spmm
from of_spmm_tpu_torch.ops.cuda.staged import staged_spmm_torch, staged_spmm_units_torch
from of_spmm_tpu_torch.sparse import panels as tpanels
from of_spmm_tpu_torch.sparse import staged_windows
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.fused import build_fused_plan
from of_spmm_tpu_torch.sparse.ranges import build_ranges_plan

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _graph(n, m, seed, per_row=3, hubs=0, band=0, general=False, empty=None):
    """A seeded pattern: random entries, a band around the diagonal, hub
    columns that most rows meet (so a tile's slots hold many selections
    and split into units); symmetric-normalized (rank-1: multi-hot lanes)
    or random (general: one-hot lanes) values; rows in ``empty`` hold
    nothing."""
    rng = np.random.default_rng(seed)
    k = rng.poisson(per_row, n)
    r = [np.repeat(np.arange(n), k)]
    c = [rng.integers(0, m, int(k.sum()))]
    if band:
        r.append(np.repeat(np.arange(n), band))
        c.append(np.clip(r[-1] * m // n - 64 + rng.integers(0, 128, r[-1].shape[0]), 0, m - 1))
    if hubs:
        hub = rng.choice(m, hubs, replace=False)
        hr, hh = np.nonzero(rng.random((n, hubs)) < 0.6)
        r.append(hr)
        c.append(hub[hh])
    key = np.unique(np.concatenate(r).astype(np.int64) * m + np.concatenate(c))
    rows, cols = key // m, key % m
    if empty is not None:
        keep = (rows < empty.start) | (rows >= empty.stop)
        rows, cols = rows[keep], cols[keep]
    if general:
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    else:
        dr = np.bincount(rows, minlength=n).astype(np.float64)
        dc = np.bincount(cols, minlength=m).astype(np.float64)
        vals = (dr[rows] ** -0.5 * dc[cols] ** -0.5).astype(np.float32)
    return CSR.from_coo(COO.from_arrays(rows.astype(np.int32), cols.astype(np.int32), vals,
                                        (n, m)))


# name -> (plan build function, graph, build kwargs, selection cap)
CASES = {
    "fused_rows": (build_fused_plan, lambda: _graph(700, 900, 1, hubs=16),
                   dict(T=256, hot_budget=128, hot_min_run=2, staging="rows", s_cap=256), 96),
    "fused_chunks_segments": (build_fused_plan, lambda: _graph(900, 900, 2, hubs=8, band=8),
                              dict(T=256, hot_budget=0, seg_steps=16), 128),
    "fused_window": (build_fused_plan, lambda: _graph(1024, 1024, 3, hubs=24, band=8),
                     dict(R=256, T=512, hot_budget=128, hot_min_run=1, stage_tier=256,
                          s_cap=512, window=True), 256),
    "fused_wide_tiles_general": (build_fused_plan,
                                 lambda: _graph(600, 600, 4, per_row=6, hubs=6, general=True,
                                                empty=slice(256, 512)),
                                 dict(R=256, T=256, hot_budget=128, hot_min_run=1), 64),
    "ranges_hot": (build_ranges_plan, lambda: _graph(1200, 1500, 5, hubs=24, band=12),
                   dict(T=512, hot_budget=256, hot_min_run=2, range_cap=512, seg_steps=24), 128),
    "ranges_top_end": (build_ranges_plan, lambda: _graph(700, 100, 6, per_row=5),
                       dict(T=256), 48),
    "ranges_pieces": (build_ranges_plan, lambda: _graph(384, 3000, 7, per_row=200),
                      dict(T=256, hot_budget=0, range_cap=256, s_cap=256), 512),
    "ranges_general": (build_ranges_plan,
                       lambda: _graph(800, 800, 8, per_row=8, hubs=4, general=True,
                                      empty=slice(300, 560)),
                       dict(T=256, hot_budget=0, range_cap=256, seg_steps=20), 64),
}


def _plan(case, monkeypatch, device="cpu"):
    """The case's compact plan, and the plan placed with its work list cut
    at the case's selection cap."""
    build, make, kw, cap = CASES[case]
    monkeypatch.setattr(tpanels, "UNIT_EDGES", cap)
    plan = build(make(), **kw)
    placed = place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=plan.shape),
                            device).binned
    return plan, placed, cap


def _work(plan, pseg):
    win = pseg.windows
    slots, units, split = (np.asarray(a.cpu()).astype(np.int64)
                           for a in (win.unit_slots, win.units, win.split_tiles))
    key = np.where(units[:, 0] < 0, ~units[:, 0], units[:, 0])
    return slots, units, split, key


def _step_keys(plan, seg):
    ctrl = seg.ctrl[:, 0, :].astype(np.int64)
    nwb, _rows = staged_windows.unit_geometry(plan)
    if getattr(plan, "window", False):
        return np.where(ctrl[:, 0] >= 0, ctrl[:, 0] * nwb + ctrl[:, 10], -1), nwb
    return ctrl[:, 0], 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_work_list_covers_every_slot_once_in_step_order(case, monkeypatch):
    plan, placed, _cap = _plan(case, monkeypatch)
    G = plan.T // 128
    for seg, pseg in zip(plan.segments, placed.segments):
        slots, units, split, key = _work(plan, pseg)
        sel = staged_windows.slot_selections(plan, seg)
        assert np.array_equal(slots, np.nonzero(sel)[0])  # every slot with selections, in order
        step_key, nwb = _step_keys(plan, seg)
        covered = np.zeros(slots.shape[0], np.int64)
        for k, a, b in zip(key, units[:, 1], units[:, 2]):
            covered[a:b] += 1
            assert (step_key[slots[a:b] // G] == k).all()  # a unit stays in its key
        assert (covered == 1).all()
        # every key has a unit, and a split key is exactly one with several
        per_key = np.bincount(key, minlength=seg.n_tiles * nwb)
        assert per_key.shape[0] == seg.n_tiles * nwb and (per_key >= 1).all()
        assert np.array_equal(split, np.nonzero(per_key > 1)[0])
        assert np.array_equal(units[:, 0] < 0, per_key[key] > 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_hold_the_cap_and_run_heaviest_first(case, monkeypatch):
    plan, placed, cap = _plan(case, monkeypatch)
    split_seen = False
    for seg, pseg in zip(plan.segments, placed.segments):
        slots, units, split, _key = _work(plan, pseg)
        sel = np.r_[0, np.cumsum(staged_windows.slot_selections(plan, seg)[slots])]
        weight = sel[units[:, 2]] - sel[units[:, 1]]
        size = units[:, 2] - units[:, 1]
        assert ((weight <= cap) | (size == 1)).all()
        assert (np.diff(weight) <= 0).all()
        split_seen |= split.shape[0] > 0
    # x of 100 rows: each tile's selections lie in one window block, one slot
    assert split_seen or case == "ranges_top_end"


@pytest.mark.parametrize("case", ["fused_wide_tiles_general", "ranges_general"])
def test_keys_without_selections_have_an_empty_unit(case, monkeypatch):
    """Rows 256-511 (fused, 256-row tiles) and 300-559 (ranges, 128-row
    tiles) hold nothing, so whole tiles have no selections. Each gets one
    unit with no slots, which writes its zero rows."""
    plan, placed, _cap = _plan(case, monkeypatch)
    empty_seen = 0
    for seg, pseg in zip(plan.segments, placed.segments):
        slots, units, _split, key = _work(plan, pseg)
        G = plan.T // 128
        step_key, nwb = _step_keys(plan, seg)
        live = np.unique(step_key[slots // G])
        for k in np.setdiff1d(np.arange(seg.n_tiles * nwb), live):
            mine = units[key == k]
            assert mine.shape[0] == 1 and mine[0, 0] == k and mine[0, 1] == mine[0, 2]
            empty_seen += 1
    assert empty_seen > 0


def test_selections_count_real_lanes():
    """slot_selections: the set bits of real multi-hot lanes (padding
    lanes' words do not count), or the real one-hot lanes; summed over a
    plan, one per stored entry."""
    for build, make, kw, _cap in (CASES["fused_rows"], CASES["ranges_general"]):
        csr = make()
        plan = build(csr, **kw)
        total = sum(int(staged_windows.slot_selections(plan, s).sum()) for s in plan.segments)
        assert total == csr.nnz
        if plan.multihot:  # set every bit of the padding lanes' words: no change
            seg = plan.segments[0]
            pad = seg.lrow >= staged_windows.geometry(plan)[4]
            assert pad.any()
            noisy = dataclasses.replace(seg, lidx=np.where(pad[:, None, :], -1, seg.lidx))
            assert np.array_equal(staged_windows.slot_selections(plan, noisy),
                                  staged_windows.slot_selections(plan, seg))


@pytest.mark.parametrize("case", sorted(CASES))
def test_unit_plain_version_equals_plain_version(case, monkeypatch):
    _plan_, placed, _cap = _plan(case, monkeypatch)
    x = np.random.default_rng(5).standard_normal((placed.shape[1], 13)).astype(np.float32)
    want = staged_spmm_torch(placed, torch.from_numpy(x)).numpy()
    got = staged_spmm_units_torch(placed, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


@pytest.mark.cuda
def test_staged_kernels_match_plain_version_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    kernels = {"fused": fused_spmm, "ranges": ranges_spmm}
    before = {e: cuda_build.LAUNCHES[f"{e}_spmm"] for e in kernels}
    calls = dict.fromkeys(kernels, 0)
    for case in sorted(CASES):
        engine = case.split("_")[0]
        _plan_, placed, _cap = _plan(case, monkeypatch, dev)
        for d in (128, 60, 7):
            x = torch.randn((placed.shape[1], d), generator=gen).to(dev)
            got = kernels[engine](placed, x)
            want = staged_spmm_torch(placed, x)
            torch.cuda.synchronize()
            calls[engine] += sum(1 for s in placed.segments if s.n_tiles)
            err = (got - want).abs()
            assert torch.isfinite(got).all()
            assert bool((err <= 1e-5 + 1e-4 * want.abs()).all()), (case, d, float(err.max()))
    for e in kernels:  # never the plain version
        assert cuda_build.LAUNCHES[f"{e}_spmm"] == before[e] + calls[e]
