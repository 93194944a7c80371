"""The port's SpMM and its two kernels' plain versions against the JAX
package, on the CPU.

- plain ``bucket_spmm`` vs JAX ``_bucket_contrib`` (Pallas, interpret);
- plain ``gather_rows`` vs JAX ``gather_rows_pallas`` (interpret) on
  in-range indices, and vs the JAX gather oracle out of range;
- ``spmm(op, x)`` vs JAX ``spmm(op, x, impl="pallas" | "xla")`` for the
  binned and tiered layouts, including a tiered matrix with empty rows.

The CUDA kernels themselves run only on the card; chip_smoke.py holds
them against these plain versions there. Pallas interpret mode unrolls
one DMA per gathered slot and compiles once per bucket shape, so the
Pallas cases keep bucket widths <= 8 and few buckets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu.ops import reference as jref
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.ops.autograd import spmm as jspmm
from of_spmm_tpu.ops.pallas.spmm import _bucket_contrib, _pad_features, gather_rows_pallas
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch.ops import make_operator, spmm
from of_spmm_tpu_torch.ops.cuda import build as cuda_build
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.tiled import TieredEll
from of_spmm_tpu_torch.utils.config import FLAGS
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _dense(n, m, density, seed, heavy=(), empty=()):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)
    for r in heavy:
        d[r, :] = rng.standard_normal(m)
    for r in empty:
        d[r] = 0
    return d


def _bucket(R, K, n_x, seed):
    """A padded-ELL bucket as the planner makes one: trailing zero slots
    with column 0."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_x, (R, K)).astype(np.int32)
    vals = rng.standard_normal((R, K)).astype(np.float32)
    lens = rng.integers(1, K + 1, R)
    pad = np.arange(K)[None, :] >= lens[:, None]
    cols[pad], vals[pad] = 0, 0.0
    return cols, vals


def _binned_case():
    """A square matrix with split heavy rows on a narrow ladder: the
    relabeled binned plan, as both packages build it."""
    dense = _dense(96, 96, 0.06, seed=21, heavy=(5,))
    x = np.random.default_rng(22).standard_normal((96, 20)).astype(np.float32)
    return dense, x, _ops(dense, "binned")


def _tiered_case():
    """A matrix whose tiered plan (8-column tiers) has warm buckets, one
    cold bucket, no split rows and no empty rows: the JAX Pallas gather
    has no zero-fill, and each extra gather costs one more interpret-mode
    compile."""
    rng = np.random.default_rng(61)
    dense = np.zeros((64, 64), np.float32)
    for r in range(64):
        if r % 2:  # five scattered nonzeros: runs of 1, all cold
            cols = rng.choice(8, 5, replace=False) * 8 + rng.integers(0, 8, 5)
        else:  # five consecutive nonzeros inside one tier: one warm run
            cols = (r % 8) * 8 + np.arange(5)
        dense[r, cols] = rng.standard_normal(5)
    x = rng.standard_normal((64, 20)).astype(np.float32)
    return dense, x, _ops(dense, "tiered", tier_size=8)


def test_bucket_spmm_plain_matches_pallas():
    """Every bucket of the plan through the plain bucket_spmm and the JAX
    _bucket_contrib (which pads features to 128 lanes, as spmm_pallas
    does)."""
    _, x, (op, jop) = _binned_case()
    xp, d = _pad_features(jnp.asarray(x))
    assert len(op.binned.buckets) == 2
    for b, jb in zip(op.binned.buckets, jop.binned.buckets):
        want = np.asarray(_bucket_contrib(jb, xp, interpret=True))[:, :d]
        got = kernels.bucket_spmm_torch(b.cols, b.vals, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bucket_spmm_row_offset_and_out_slice():
    """A warm tier's bucket reads x from row_offset and writes into its
    slice of a concatenation buffer; the wrapper on CPU tensors runs the
    plain version and launches nothing."""
    cols, vals = _bucket(24, 5, 32, seed=3)
    x = np.random.default_rng(2).standard_normal((100, 12)).astype(np.float32)
    want = np.einsum("rk,rkd->rd", vals, x[64 + cols])
    cat = torch.full((40, 12), float("nan"))
    before = dict(kernels.LAUNCHES)
    got = kernels.bucket_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                              torch.from_numpy(x), 64, out=cat[8:32])
    assert got.data_ptr() == cat[8:32].data_ptr()
    np.testing.assert_allclose(cat[8:32].numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.isnan(cat[:8]).all() and torch.isnan(cat[32:]).all()
    assert kernels.LAUNCHES == before


def test_bucket_spmm_column_outside_x_raises():
    """A column past the end of x is an error, not a zero term: the plain
    version raises here, and the kernel stops with a device-side assertion
    on the card (chip_smoke.py checks that)."""
    cols, vals = _bucket(6, 3, 10, seed=6)
    cols[4, 0] = 10
    x = torch.zeros((10, 4))
    with pytest.raises(IndexError):
        kernels.bucket_spmm(torch.from_numpy(cols), torch.from_numpy(vals), x)


def test_bucket_spmm_plain_chunks_rows():
    cols, vals = _bucket(50, 7, 30, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((30, 6)).astype(np.float32))
    whole = kernels.bucket_spmm_torch(torch.from_numpy(cols), torch.from_numpy(vals), x)
    FLAGS.override("OFS_SPMM_MAX_GATHER_SLOTS", 70)  # 10 rows per chunk
    try:
        chunked = kernels.bucket_spmm_torch(torch.from_numpy(cols), torch.from_numpy(vals), x)
    finally:
        FLAGS.override("OFS_SPMM_MAX_GATHER_SLOTS", None)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)


def test_gather_rows_plain_matches_pallas():
    """In-range indices, at the shapes of the tiered case's finish gather."""
    _, _, (op, _) = _tiered_case()
    rng = np.random.default_rng(62)
    rows, n = op.binned.n_ell_rows, op.binned.n_rows
    table = rng.standard_normal((rows, 20)).astype(np.float32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rows_out_of_range_rows_are_zero():
    """Unlike the Pallas kernel, the port's gather zero-fills indices
    outside the table, as the JAX gather oracle does: the finish's
    sentinel for empty rows relies on it."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    idx = np.array([0, 49, 50, -1, 7, 1 << 30], np.int32)
    got = kernels.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    want = np.asarray(jref.gather(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[[2, 3, 5]].any()


@pytest.mark.parametrize("bad", ["cols_dtype", "vals_shape", "x_noncontig", "out_shape",
                                 "idx_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    cols = torch.zeros((8, 4), dtype=torch.int32)
    vals = torch.zeros((8, 4))
    x = torch.zeros((10, 6))
    with pytest.raises((TypeError, ValueError)):
        if bad == "cols_dtype":
            kernels.bucket_spmm(cols.long(), vals, x)
        elif bad == "vals_shape":
            kernels.bucket_spmm(cols, vals[:, :3].contiguous(), x)
        elif bad == "x_noncontig":
            kernels.bucket_spmm(cols, vals, torch.zeros((6, 10)).t())
        elif bad == "out_shape":
            kernels.bucket_spmm(cols, vals, x, out=torch.zeros((8, 5)))
        else:
            kernels.gather_rows(x, torch.zeros(3, dtype=torch.int64))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build._nvcc()


# ---------------------------------------------------------------------------
# spmm through the operator, against the JAX package
# ---------------------------------------------------------------------------

def _ops(dense, layout, tier_size=None):
    """Port and JAX operators on one matrix. Binned plans get a narrow
    explicit ladder (heavy rows split into 8-wide chunks); tiered plans
    chunk runs to 256 whatever the ladder, so they keep the DP ladder and
    narrow tiers keep their buckets narrow."""
    ladder = "auto" if layout == "tiered" else (4, 8)
    kw = dict(ladder=ladder, layout=layout, tier_size=tier_size)
    return (make_operator(CSR.from_dense(dense), device="cpu", **kw),
            jmake_operator(JCSR.from_dense(dense), place=False, **kw))


def _rect_case():
    """Rectangular: not relabeled, so the binned finish is a pos gather."""
    dense = _dense(80, 120, 0.06, seed=23, heavy=(5,))
    x = np.random.default_rng(24).standard_normal((120, 20)).astype(np.float32)
    return dense, x, _ops(dense, "binned")


def _heavy_tiered_case():
    """Heavy rows split across tiers and chunks (finish extras)."""
    dense = _dense(96, 96, 0.06, seed=25, heavy=(5, 40))
    x = np.random.default_rng(26).standard_normal((96, 20)).astype(np.float32)
    return dense, x, _ops(dense, "tiered", tier_size=8)


_CASES = {"binned": _binned_case, "binned_rect": _rect_case, "tiered": _tiered_case,
          "tiered_heavy": _heavy_tiered_case}


@pytest.mark.parametrize("case,jimpl", [
    ("binned", "pallas"), ("binned", "xla"), ("binned_rect", "xla"),
    ("tiered", "pallas"), ("tiered", "xla"), ("tiered_heavy", "xla"),
])
def test_spmm_matches_jax(case, jimpl):
    dense, x, (op, jop) = _CASES[case]()
    assert isinstance(op.binned, TieredEll) == case.startswith("tiered")
    want = np.asarray(jax.jit(lambda xx: jspmm(jop, xx, impl=jimpl))(jnp.asarray(x)))
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain kernel versions
        with torch.no_grad():
            got = spmm(op, torch.from_numpy(x), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(want, dense @ x, rtol=RTOL, atol=1e-4)


def test_tiered_case_shape():
    """The tiered Pallas case exercises what it claims to."""
    _, _, (op, _) = _tiered_case()
    tiers = {t.tier: t for t in op.binned.tiers}
    assert -1 in tiers and len(tiers[-1].buckets) == 1 and len(tiers) > 2
    assert op.binned.finish.extra_rids.shape[0] == 0
    assert int(op.binned.finish.pos.max()) < op.binned.n_ell_rows


@pytest.mark.parametrize("scatter_bytes", [None, 1])
def test_tiered_empty_rows_match_xla(scatter_bytes):
    """Empty output rows hit the finish's sentinel and must come out zero."""
    dense = _dense(100, 100, 0.08, seed=31, heavy=(50,), empty=(0, 7, 99))
    op, jop = _ops(dense, "tiered", tier_size=8)
    assert int(op.binned.finish.pos[7]) == op.binned.n_ell_rows
    x = np.random.default_rng(32).standard_normal((100, 9)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xx: jspmm(jop, xx, impl="xla"))(jnp.asarray(x)))
    FLAGS.override("OFS_TIERED_SCATTER_BYTES", scatter_bytes)
    try:
        for impl in ("torch", "cuda"):
            got = spmm(op, torch.from_numpy(x), impl=impl)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
            assert not got[[0, 7, 99]].any()
    finally:
        FLAGS.override("OFS_TIERED_SCATTER_BYTES", None)


@pytest.mark.parametrize("layout", ["tiered", "auto"])
def test_tiered_empty_matrix_divergence(layout):
    """Where the port departs from the reference on purpose: the JAX
    package's tiered planner fails on a matrix without nonzeros (an
    IndexError on an empty chunk list); the port plans it with no tiers
    and its SpMM returns zeros. layout="auto" goes tiered here because
    n_cols > tier_size."""
    dense = np.zeros((50, 50), np.float32)
    with pytest.raises(IndexError):
        jmake_operator(JCSR.from_dense(dense), layout=layout, tier_size=16, place=False)
    op = make_operator(CSR.from_dense(dense), layout=layout, tier_size=16, device="cpu")
    assert isinstance(op.binned, TieredEll) and op.binned.tiers == ()
    x = torch.from_numpy(np.random.default_rng(27).standard_normal((50, 7)).astype(np.float32))
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain kernel versions
        y = spmm(op, x, impl=impl)
        assert y.shape == (50, 7) and not y.any()
        assert not spmm(op.T, x, impl=impl).any()


def test_transpose_operator_matches_dense():
    dense = _dense(70, 50, 0.1, seed=41)
    op = make_operator(CSR.from_dense(dense), layout="tiered", tier_size=16, device="cpu")
    g = np.random.default_rng(42).standard_normal((70, 5)).astype(np.float32)
    np.testing.assert_allclose((op.T @ torch.from_numpy(g)).numpy(), dense.T @ g,
                               rtol=RTOL, atol=1e-4)


def test_impl_selection_and_refusals():
    dense = _dense(30, 30, 0.2, seed=51)
    op = make_operator(CSR.from_dense(dense), device="cpu")
    x = torch.from_numpy(np.random.default_rng(52).standard_normal((30, 4)).astype(np.float32))
    np.testing.assert_allclose(spmm(op, x).numpy(), dense @ x.numpy(), rtol=RTOL, atol=1e-4)
    with pytest.raises(ValueError, match="impl"):
        spmm(op, x, impl="pallas")
    xg = x.clone().requires_grad_()
    spmm(op, xg).sum().backward()  # the backward: A^T @ ones
    np.testing.assert_allclose(xg.grad.numpy(), np.broadcast_to(dense.sum(0)[:, None], (30, 4)),
                               rtol=RTOL, atol=1e-4)
    with pytest.raises(ValueError, match="reorder"):  # only panels, fused and ranges reorder
        make_operator(CSR.from_dense(dense), reorder="bfs", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        make_operator(CSR.from_dense(dense), layout="blocked", device="cpu")
    before = dict(kernels.LAUNCHES)  # "auto" on CPU tensors picks the plain engine
    np.testing.assert_allclose(spmm(op, x, impl="torch").numpy(), spmm(op, x).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert kernels.LAUNCHES == before
