"""The bucket kernel's work list (ops/cuda/spmm.py ``bucket_work``,
``bucket_units``) and its unit-by-unit plain version, without JAX at
import, so that the file also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_bucket_work.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
lacks). On the CPU, for tiered plans with several tiers, a cold tier and
rows split across ELL rows (``finish.extra_rids`` non-empty), wide
buckets, a relabeled binned plan and a non-square binned plan, cut at
small slot caps: the units cover every ELL row of every bucket once; no
unit holds more than 128 rows, nor more slots than the cap unless it is
one row; units run tier by tier (the cold tier last), heaviest first
within a tier; the device table describes the
buckets in concatenation order; rows of padding only are written (as
zeros); ``bucket_spmm_units_torch`` (each unit's rows written once into a
NaN buffer) equals the plain version; and the whole-plan path through
that unit version equals the JAX package's tiered SpMM (``impl="xla"``).
The ``cuda``-marked test holds the one-launch kernel against the plain
version on the card, on these plans, at d % 4 == 0 (float4 path) and
d % 4 != 0 (scalar path), and counts one launch per SpMM.
"""

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops import place_operator
from of_spmm_tpu_torch.ops import reference as ref
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
from of_spmm_tpu_torch.sparse.binned import bin_rows, bin_rows_relabeled
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.tiled import bin_rows_tiered

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _dense(n, m, density, seed, heavy=(), empty=()):
    """A seeded random pattern with standard-normal values; ``heavy`` rows
    are full, ``empty`` rows hold nothing."""
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)
    for r in heavy:
        d[r] = rng.standard_normal(m)
    for r in empty:
        d[r] = 0
    return d


# name -> (plan maker, slot cap)
CASES = {
    "tiered_split_rows": (lambda: bin_rows_tiered(
        CSR.from_dense(_dense(300, 700, 0.03, 1, heavy=(5, 77), empty=(0, 64, 299))),
        tier_size=128, max_width=16), 48),
    "tiered_wide": (lambda: bin_rows_tiered(
        CSR.from_dense(_dense(400, 900, 0.05, 2, heavy=(3, 150, 151))),
        tier_size=256, max_width=256), 200),
    "binned_relabeled": (lambda: bin_rows_relabeled(
        CSR.from_dense(_dense(400, 400, 0.04, 3, heavy=(9,), empty=(3, 399))),
        max_width=64)[0], 100),
    "binned_nonsquare": (lambda: bin_rows(
        CSR.from_dense(_dense(300, 500, 0.05, 4, heavy=(30,), empty=(7,))),
        max_width=256), kernels.BUCKET_UNIT_SLOTS),
}


def _plan(case, monkeypatch, device="cpu"):
    """The case's plan placed with its work list cut at the case's cap,
    and the cap."""
    make, cap = CASES[case]
    monkeypatch.setattr(kernels, "BUCKET_UNIT_SLOTS", cap)
    plan = make()
    op = place_operator(SpmmOperator(binned=plan, binned_t=plan, shape=plan.shape), device)
    return op.binned, op.work, cap


def _units(work):
    return work.units.cpu().numpy().astype(np.int64)


def test_plans_have_what_they_are_here_for():
    tiered = CASES["tiered_split_rows"][0]()
    assert tiered.tiers[0].tier == -1 and len(tiered.tiers) > 2
    assert tiered.finish.extra_rids.shape[0] > 0  # rows split across ELL rows
    wide = CASES["tiered_wide"][0]()
    assert max(b.width for t in wide.tiers for b in t.buckets) > 128
    relabeled = CASES["binned_relabeled"][0]()
    assert relabeled.slice_counts is not None and relabeled.has_split_rows
    assert CASES["binned_nonsquare"][0]().slice_counts is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_cover_every_ell_row_once(case, monkeypatch):
    plan, work, _cap = _plan(case, monkeypatch)
    buckets = kernels.plan_buckets(plan)
    covered = [np.zeros(c.shape[0], np.int64) for c, _, _ in buckets]
    for b, r0, n in _units(work):
        assert 1 <= n <= kernels.UNIT_ROWS
        covered[b][r0:r0 + n] += 1
    assert all((c == 1).all() for c in covered)
    assert work.n_ell_rows == sum(c.shape[0] for c, _, _ in buckets)


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_hold_the_cap_and_run_tier_by_tier_heaviest_first(case, monkeypatch):
    plan, work, cap = _plan(case, monkeypatch)
    widths = np.array([c.shape[1] for c, _, _ in kernels.plan_buckets(plan)])
    units = _units(work)
    slots = units[:, 2] * widths[units[:, 0]]
    assert ((slots <= cap) | (units[:, 2] == 1)).all()
    tier = np.array(kernels.plan_tiers(plan))[units[:, 0]]
    rank = np.where(tier < 0, tier.max() + 1, tier)  # warm tiers in order, the cold tier last
    assert (np.diff(rank) >= 0).all()
    for t in np.unique(rank):
        assert (np.diff(slots[rank == t]) <= 0).all()
    if case.startswith("tiered"):
        assert tier[0] >= 0 and tier[-1] == -1
    if case == "tiered_wide":  # rows wider than the cap are units alone
        assert ((units[:, 2] == 1) & (slots > cap)).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_describes_the_buckets_in_concatenation_order(case, monkeypatch):
    plan, work, _cap = _plan(case, monkeypatch)
    table = work.table.numpy()
    first = 0
    for (c, v, off), row in zip(kernels.plan_buckets(plan), table):
        assert tuple(row) == (c.data_ptr(), v.data_ptr(), c.shape[1], c.shape[0], off, first)
        first += c.shape[0]
    assert table.shape[0] == len(kernels.plan_buckets(plan))


def test_rows_of_padding_only_are_written(monkeypatch):
    """Bucket row counts are padded to a multiple of 8 with rows of
    padding: the unit version writes them, as zeros."""
    plan, work, _cap = _plan("tiered_split_rows", monkeypatch)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((700, 6)).astype(np.float32))
    cat = kernels.bucket_spmm_units_torch(plan, x, work)
    pad = torch.cat([(v == 0).all(1) for _, v, _ in kernels.plan_buckets(plan)])
    assert pad.any() and not torch.isnan(cat).any() and not cat[pad].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_unit_plain_version_equals_plain_version(case, monkeypatch):
    plan, work, _cap = _plan(case, monkeypatch)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((plan.shape[1], 13))
                         .astype(np.float32))
    want = kernels.bucket_spmm_plan(plan, x, work).numpy()
    got = kernels.bucket_spmm_units_torch(plan, x, work).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max() + ATOL)


def test_whole_plan_path_matches_jax_tiered_spmm(monkeypatch):
    """The tiered SpMM with every bucket through the unit version (one
    call for the whole plan, as the kernel's one launch) and the finish,
    against the JAX package's tiered SpMM on the same CSR (impl="xla")."""
    import jax
    import jax.numpy as jnp
    from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
    from of_spmm_tpu.ops.autograd import spmm as jspmm
    from of_spmm_tpu.sparse.formats import CSR as JCSR

    dense = _dense(300, 700, 0.03, 1, heavy=(5, 77), empty=(0, 64, 299))
    plan, work, _cap = _plan("tiered_split_rows", monkeypatch)
    x = np.random.default_rng(7).standard_normal((700, 8)).astype(np.float32)
    got = ref.spmm_tiered(plan, torch.from_numpy(x),
                          buckets_fn=lambda p, xa: kernels.bucket_spmm_units_torch(p, xa, work))
    jop = jmake_operator(JCSR.from_dense(dense), layout="tiered", tier_size=128, place=False)
    want = np.asarray(jax.jit(lambda xx: jspmm(jop, xx, impl="xla"))(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), dense.astype(np.float64) @ x, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.cuda
def test_bucket_kernel_matches_plain_version_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    before = cuda_build.LAUNCHES["bucket_spmm"]
    calls = 0
    for case in sorted(CASES):
        plan, work, _cap = _plan(case, monkeypatch, dev)
        for d in (128, 60, 7):
            x = torch.randn((plan.shape[1], d), generator=gen).to(dev)
            got = kernels.bucket_spmm_plan(plan, x, work)
            want = torch.cat([kernels.bucket_spmm_torch(c, v, x, o)
                              for c, v, o in kernels.plan_buckets(plan)])
            torch.cuda.synchronize()
            calls += 1
            err = (got - want).abs()
            assert torch.isfinite(got).all()
            assert bool((err <= 1e-5 + 1e-4 * want.abs()).all()), (case, d, float(err.max()))
    assert cuda_build.LAUNCHES["bucket_spmm"] == before + calls  # one launch a plan
