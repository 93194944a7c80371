"""The port's COO/CSR formats and plain oracles against the JAX package.

Same numpy-seeded inputs through of_spmm_tpu and of_spmm_tpu_torch: the
format arrays must be equal, the oracles must agree at rtol 1e-4 /
atol 1e-5 (bf16 inputs at bf16's own resolution).
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu import native as jnative
from of_spmm_tpu.data.graphs import GraphConfig as JGraphConfig
from of_spmm_tpu.data.graphs import synthetic_edges as jsynthetic_edges
from of_spmm_tpu.ops import reference as jref
from of_spmm_tpu.sparse.formats import COO as JCOO
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.ops import reference as ref
from of_spmm_tpu_torch.sparse import formats
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _random_dense(n, m, density, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)
    for r in zero_rows:
        d[r] = 0
    return d


def _powerlaw_edges(n=400, e=3000, seed=0):
    return jsynthetic_edges(JGraphConfig("pl", n, e, power_law=True), seed=seed)


def _assert_csr_equal(a: CSR, b: JCSR):
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.asarray(a.indptr), np.asarray(b.indptr))
    np.testing.assert_array_equal(a.cols, np.asarray(b.cols))
    np.testing.assert_array_equal(a.vals, np.asarray(b.vals))


def _matrices():
    """(name, dense or None, coo args) cases: random and power-law."""
    rng = np.random.default_rng(3)
    src, dst = _powerlaw_edges()
    vals = rng.standard_normal(src.shape[0]).astype(np.float32)
    return {
        "random": _random_dense(70, 90, 0.08, seed=1, zero_rows=(3, 69)),
        "powerlaw": (src, dst, vals, 400),
    }


@pytest.mark.parametrize("case", ["random", "powerlaw"])
def test_csr_arrays_equal(case):
    m = _matrices()[case]
    if case == "random":
        a, b = CSR.from_dense(m), JCSR.from_dense(m)
        np.testing.assert_array_equal(a.to_dense(), np.asarray(b.to_dense()))
    else:
        src, dst, vals, n = m
        a = CSR.from_coo(COO.from_edges(src, dst, n, vals))
        b = JCSR.from_coo(JCOO.from_edges(src, dst, n, vals))
    _assert_csr_equal(a, b)
    _assert_csr_equal(a.transpose(), b.transpose())
    ca, cb = a.to_coo(), b.to_coo()
    for x, y in ((ca.rows, cb.rows), (ca.cols, cb.cols), (ca.vals, cb.vals)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_native_sorts_equal():
    """The large-input native path (>= 2^18 nnz) of both packages: same
    C++ source, same arrays."""
    rng = np.random.default_rng(5)
    n, nnz = 5000, 300_000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    a = CSR.from_coo(COO.from_arrays(rows, cols, vals, (n, n)))
    b = JCSR.from_coo(JCOO.from_arrays(rows, cols, vals, (n, n)))
    _assert_csr_equal(a, b)
    _assert_csr_equal(a.transpose(), b.transpose())
    s, d = native.symmetrize_dedup(rows, cols, n)
    js, jd = jnative.symmetrize_dedup(rows, cols, n)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(d, jd)


def test_formats_doctests():
    results = doctest.testmod(formats, verbose=False)
    assert results.failed == 0 and results.attempted > 0


def test_validate_rejects_out_of_range():
    with pytest.raises(ValueError):
        COO.from_arrays([0, 5], [0, 1], [1.0, 1.0], (3, 3)).validate()
    with pytest.raises(ValueError):
        CSR.from_arrays([0, 1, 2], [0, 7], [1.0, 1.0], (2, 3)).validate()
    with pytest.raises(TypeError):
        COO.from_arrays([0.5], [0], [1.0], (1, 1))


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


def _close(a: torch.Tensor, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a.float().numpy(), np.asarray(b, dtype=np.float32),
                               rtol=rtol, atol=atol)


def test_gather_out_of_range_is_zero():
    rng = np.random.default_rng(0)
    params = rng.standard_normal((10, 6)).astype(np.float32)
    idx = np.array([0, 9, 10, -1, 4, 123, -7], np.int32)
    got = ref.gather(torch.from_numpy(params), torch.from_numpy(idx))
    want = np.asarray(jref.gather(jnp.asarray(params), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any() and not got[3].any() and not got[5].any()
    idx2 = np.array([[1, 11], [-2, 3]], np.int32)  # 2-D indices along axis 1
    got = ref.gather(torch.from_numpy(params), torch.from_numpy(idx2), axis=1)
    want = np.asarray(jref.gather(jnp.asarray(params), jnp.asarray(idx2), axis=1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_drops_out_of_range_ids():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((12, 5)).astype(np.float32)
    ids = np.array([0, 3, 3, 7, -1, 8, 2, 0, 11, 4, 4, 1], np.int32)
    got = ref.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 8)
    want = jref.segment_sum(jnp.asarray(data), jnp.asarray(ids), 8)
    _close(got, want)
    like = torch.zeros(6, 5, dtype=torch.float64)
    got = ref.segment_sum_like(torch.from_numpy(data), torch.from_numpy(ids), like)
    assert got.dtype == torch.float64 and got.shape == (6, 5)
    _close(got, jref.segment_sum(jnp.asarray(data), jnp.asarray(ids), 6))


@pytest.mark.parametrize("case", ["random", "powerlaw"])
def test_spmv_spmm_sddmm_match(case):
    m = _matrices()[case]
    if case == "random":
        a, b = CSR.from_dense(m), JCSR.from_dense(m)
    else:
        src, dst, vals, n = m
        a = CSR.from_coo(COO.from_edges(src, dst, n, vals))
        b = JCSR.from_coo(JCOO.from_edges(src, dst, n, vals))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((a.shape[1], 24)).astype(np.float32)
    v = rng.standard_normal(a.shape[1]).astype(np.float32)
    _close(ref.spmm(a, torch.from_numpy(x)), jref.spmm(b, jnp.asarray(x)))
    _close(ref.spmm(a.to_coo(), torch.from_numpy(x)), jref.spmm(b.to_coo(), jnp.asarray(x)))
    _close(ref.spmv(a, torch.from_numpy(v)), jref.spmv(b, jnp.asarray(v)))
    lhs = rng.standard_normal((a.shape[0], 8)).astype(np.float32)
    rhs = rng.standard_normal((a.shape[1], 8)).astype(np.float32)
    coo, jcoo = a.to_coo(), b.to_coo()
    _close(ref.sddmm(torch.from_numpy(lhs), torch.from_numpy(rhs), coo.rows, coo.cols),
           jref.sddmm(jnp.asarray(lhs), jnp.asarray(rhs), jcoo.rows, jcoo.cols))


def test_bf16_accumulates_in_fp32():
    dense = _random_dense(40, 50, 0.3, seed=9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ref.spmm(CSR.from_dense(dense), xb)
    want = jref.spmm(JCSR.from_dense(dense), jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # both accumulate in fp32 and round once to bf16 (8 mantissa bits)
    _close(got, np.asarray(want.astype(jnp.float32)), rtol=1e-2, atol=1e-2)
