"""The port's one-hot expansion engine v2 (``build_expansion2_plan``,
``spmm_expansion2``) against the JAX package, on the CPU.

- ``build_expansion2_plan``: plan arrays equal to the JAX package's on the
  same CSR (the bf16 values bitwise), with ``rank1`` auto, forced and off,
  on cora, random general and rank-1 matrices, a non-square matrix, empty
  rows, an empty tile and an uneven last tile, several tiers and several
  groups; with and without the native pass 1.
- Placement: ``stage_row`` and ``stage_scale`` against the JAX wrapper's
  staged table (``_stage``), and the refusal of a real lane that names a
  staged row beyond the table.
- ``expansion2_spmm_torch`` against JAX ``spmm_expansion2`` (Pallas,
  interpret mode) at rtol 2e-4 / atol 5e-4 (tests/test_expansion2.py) and
  against the float64 dense product of the plan's values at rtol 1e-4 /
  atol 1e-5, at d = 8, 40 and 160; bf16 X at rtol 0.05 / atol 0.02.

The CUDA kernel runs only on the card; chip_smoke.py holds it against
``expansion2_spmm_torch`` there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.ops.pallas.expansion2 import _stage, spmm_expansion2 as jspmm_expansion2
from of_spmm_tpu.sparse import expansion2 as jexp2
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.ops import place_plan, spmm_expansion2
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda.expansion2 import expansion2_spmm, expansion2_spmm_torch
from of_spmm_tpu_torch.sparse import expansion as texp
from of_spmm_tpu_torch.sparse import expansion2 as texp2
from tests.test_torch_expansion import (
    JAX_ATOL, JAX_RTOL, _case, _cora, _dense, _jcsr, assert_groups_equal, close_to_float64)

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

BF16_RTOL, BF16_ATOL = 0.05, 0.02  # tests/test_expansion2.py, bf16 fast mode

_SMALL = dict(R=64, G=2, stage_tier=128)
# name -> (dense matrix maker, build kwargs, expected rank1)
CASES = {
    "cora": (_cora, {}, True),
    "general_tiers": (_case(_dense, 300, 257, 0.05), _SMALL, False),
    "rank1_tiers": (_case(_dense, 300, 257, 0.05, seed=2, rank1=True), _SMALL, True),
    "rank1_forced": (_case(_dense, 300, 257, 0.05, seed=2, rank1=True),
                     dict(_SMALL, rank1=True), True),
    "rank1_off": (_case(_dense, 300, 257, 0.05, seed=2, rank1=True),
                  dict(_SMALL, rank1=False), False),
    "nonsquare_wide": (_case(_dense, 64, 2000, 0.01, seed=1, rank1=True),
                       dict(R=64, G=2, stage_tier=512), True),
    "empty_rows_uneven": (_case(_dense, 70, 90, 0.04, seed=4, empty_rows=slice(10, 20)),
                          dict(R=32, G=2, stage_tier=128), False),
    "empty_tile_rank1": (_case(_dense, 100, 80, 0.05, seed=6, empty_rows=slice(32, 64),
                               rank1=True), dict(R=32, G=2, stage_tier=64), True),
    "multi_group": (_case(_dense, 256, 128, 0.06, seed=5),
                    dict(R=32, G=2, stage_tier=128, stage_budget=256), False),
}

_GROUP_FIELDS = ("stage_idx", "lidx", "lrow", "blk_of", "tile_of")


def _assert_plans_equal(p, j):
    assert_groups_equal(p, j, _GROUP_FIELDS, ("shape", "R", "G", "stage_tier", "rank1"))
    for a, b in [(p.row_scale, j.row_scale)] + [(pg.stage_scale, jg.stage_scale)
                                                 for pg, jg in zip(p.groups, j.groups)]:
        assert (a is None) == (b is None)
        if a is not None:
            b = np.asarray(b)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _close_to_float64(got, csr, dense, plan, x):
    """Against the float64 product of what the plan computes with: the
    float32 factors r_i * c_j of each entry on rank-1 plans (summed over
    duplicate entries), each value's bf16 pair otherwise."""
    if not plan.rank1:
        close_to_float64(got, dense, x)
        return
    c = texp2.factor_rank1(csr)[1].astype(np.float32)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    a = np.zeros(csr.shape)
    r = torch.as_tensor(plan.row_scale).numpy().astype(np.float64)
    np.add.at(a, (rows, csr.cols), r[rows] * c[csr.cols])
    close_to_float64(got, a, x, bf16_pair=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_jax(case):
    make, kw, rank1 = CASES[case]
    csr, _ = make()
    plan = texp2.build_expansion2_plan(csr, **kw)
    jplan = jexp2.build_expansion2_plan(_jcsr(csr), **kw)
    assert plan.rank1 == rank1
    _assert_plans_equal(plan, jplan)
    assert (plan.n_steps, plan.n_staged) == (jplan.n_steps, jplan.n_staged)
    assert plan.padding_efficiency(csr.nnz) == jplan.padding_efficiency(csr.nnz)
    if case == "multi_group":
        assert len(plan.groups) > 1
    if case == "empty_tile_rank1":  # the empty tile's one step is all padding
        g = plan.groups[0]
        steps = np.nonzero(g.tile_of == 1)[0]
        assert steps.shape[0] == 1 and (g.lrow.reshape(-1, plan.G * 128)[steps] == 32).all()


def test_plan_without_native_pass1_is_equal(monkeypatch):
    """The numpy branch (no native library) builds the same plan."""
    for case in ("general_tiers", "rank1_tiers", "empty_tile_rank1", "multi_group"):
        make, kw, _ = CASES[case]
        csr, _ = make()
        with_native = texp2.build_expansion2_plan(csr, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(native, "expansion_pass1", lambda *a, **k: None)
            without = texp2.build_expansion2_plan(csr, **kw)
        assert_groups_equal(without, with_native, _GROUP_FIELDS, ("shape", "R", "G", "rank1"))


@pytest.mark.parametrize("case", ["rank1_tiers", "general_tiers"])
def test_stage_rows_match_the_tpu_staging(case):
    """X[stage_row] (times stage_scale on rank-1 plans) is the staged table
    the TPU wrapper gathers, pad rows included; on an integer-valued X of
    a general plan it is exact."""
    make, kw, _ = CASES[case]
    csr, _ = make()
    plan = texp2.attach_stage_rows(texp2.build_expansion2_plan(csr, **kw))
    jplan = jexp2.build_expansion2_plan(_jcsr(csr), **kw)
    x = np.random.default_rng(3).integers(-50, 50, (csr.shape[1], 8)).astype(np.float32)
    for g, jg in zip(plan.groups, jplan.groups):
        hi, lo = _stage(jg, jplan.stage_tier, jnp.asarray(x), True)
        want = np.asarray(hi).astype(np.float32) + np.asarray(lo).astype(np.float32)
        got = x[g.stage_row]
        if g.stage_scale is None:
            np.testing.assert_array_equal(got, want)
        else:  # the scaled rows split into a hi/lo pair: 2^-16 relative
            np.testing.assert_allclose(got * g.stage_scale[:, None], want, rtol=2e-5, atol=0)


def test_placement_refuses_a_real_lane_beyond_the_table():
    make, kw, _ = CASES["general_tiers"]
    plan = texp2.build_expansion2_plan(make()[0], **kw)
    g = plan.groups[0]
    blk = g.blk_of.copy()
    blk[0] = g.stage_idx.shape[0] // 128 + 1  # the first group holds real lanes
    bad = dataclasses.replace(plan, groups=(dataclasses.replace(g, blk_of=blk),))
    with pytest.raises(ValueError, match="beyond the group's"):
        texp2.attach_stage_rows(bad)
    # padding lanes (row sentinel R) may name anything
    lrow = g.lrow.copy()
    lrow[0] = plan.R
    texp2.attach_stage_rows(dataclasses.replace(
        plan, groups=(dataclasses.replace(g, blk_of=blk, lrow=lrow),)))
    rep = texp.plan_memory_report(place_plan(plan, "cpu"), d=64, hbm_limit=16 << 30)
    assert rep["stage_row_bytes"] == 4 * plan.n_staged


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel and the dense product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,d", [("rank1_tiers", 40), ("general_tiers", 8),
                                    ("multi_group", 160), ("empty_tile_rank1", 8),
                                    ("nonsquare_wide", 8)])
def test_plain_version_matches_jax_kernel(case, d):
    make, kw, _ = CASES[case]
    csr, dense = make()
    plan = place_plan(texp2.build_expansion2_plan(csr, **kw), "cpu")
    x = np.random.default_rng(5).standard_normal((dense.shape[1], d)).astype(np.float32)
    got = expansion2_spmm_torch(plan, torch.from_numpy(x)).numpy()
    want = jspmm_expansion2(jexp2.build_expansion2_plan(_jcsr(csr), **kw),
                            jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAX_RTOL, atol=JAX_ATOL)
    _close_to_float64(got, csr, dense, plan, x)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 40, 160])
def test_plain_version_matches_float64(case, d):
    """Every plan shape at every width against the float64 dense product;
    the wrapper on a CPU tensor runs the plain version and launches
    nothing."""
    make, kw, _ = CASES[case]
    csr, dense = make()
    plan = place_plan(texp2.build_expansion2_plan(csr, **kw), "cpu")
    x = np.random.default_rng(d).standard_normal((dense.shape[1], d)).astype(np.float32)
    before = dict(cuda_build.LAUNCHES)
    got = expansion2_spmm(plan, torch.from_numpy(x)).numpy()
    assert cuda_build.LAUNCHES == before
    _close_to_float64(got, csr, dense, plan, x)


def test_bf16_input_matches_jax_fast_mode():
    """bf16 X: the port computes in float32 and returns bf16; JAX's bf16
    fast mode (tests/test_expansion2.py::test_expansion2_bf16_fast_mode)."""
    csr, _ = _case(_dense, 128, 300, 0.05, rank1=True)()
    kw = dict(R=64, G=2, stage_tier=512)
    x = np.random.default_rng(2).standard_normal((300, 64)).astype(np.float32)
    got = spmm_expansion2(texp2.build_expansion2_plan(csr, **kw),
                          torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jspmm_expansion2(jexp2.build_expansion2_plan(_jcsr(csr), **kw),
                            jnp.asarray(x).astype(jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_empty_tile_is_zero():
    """An empty tile's output rows are zero on both engines: v2 gives the
    tile one padding step whose lanes (row sentinel R) add nothing; v1
    gives it no step, and the port adds into a zeroed output."""
    make, kw, _ = CASES["empty_tile_rank1"]
    csr, _ = make()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((80, 8)).astype(np.float32))
    y2 = spmm_expansion2(texp2.build_expansion2_plan(csr, **kw), x)
    y1 = texp.build_expansion_plan(csr, R=32, TILE=128, CW=128)
    from of_spmm_tpu_torch.ops import spmm_expansion

    for y in (y2, spmm_expansion(y1, x)):
        assert not y[32:64].any() and y[:32].any() and y[64:].any()


def test_refusals():
    """rank1=True on values that do not factor raises as in the JAX
    package (tests/test_exceptions_more.py); the wrapper takes only a
    placed Expansion2Plan and float32 x of the right height."""
    general, _ = _case(_dense, 64, 64, 0.1, seed=3)()
    with pytest.raises(ValueError, match="rank1=True") as got:
        texp2.build_expansion2_plan(general, rank1=True)
    with pytest.raises(ValueError) as want:
        jexp2.build_expansion2_plan(_jcsr(general), rank1=True)
    assert str(got.value) == str(want.value)
    plan = texp2.build_expansion2_plan(general, R=32, G=2)
    x = torch.zeros((64, 4))
    with pytest.raises(ValueError, match="not placed"):
        expansion2_spmm(plan, x)
    placed = place_plan(plan, "cpu")
    with pytest.raises(TypeError):
        expansion2_spmm(placed, x.double())
    with pytest.raises(ValueError, match="rows"):
        expansion2_spmm(placed, torch.zeros((63, 4)))
    v1 = place_plan(texp.build_expansion_plan(general), "cpu")
    with pytest.raises(TypeError, match="Expansion2Plan"):
        expansion2_spmm(v1, x)
