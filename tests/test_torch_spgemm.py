"""The port's SpGEMM against the JAX package, on the CPU.

- ``reference.spgemm`` (host C = A @ B) with the native Gustavson kernel
  and with the numpy fallback (``_lib`` forced to None in both packages):
  the same CSR arrays as the JAX package's, and the dense product.
- The three symbolic phases (``spgemm_symbolic``, ``_padded``,
  ``_products``): plan arrays equal to the JAX package's, for the cases of
  tests/test_fused_plan.py (padded splits at max_width = 8, the products
  ladder (1, 2, 4, 8, 16, 32), big rows at (1, 4, 16, 64)) and for empty
  and zero-product matrices.
- The three numeric phases: values against JAX's numeric and, merged,
  the dense product; gradients in both value arrays against ``jax.grad``.
- ``spgemm_device``: plan reuse with new values; the registry's entry.

Tolerance: rtol 1e-4, atol 1e-5 * max|want| + 1e-5; plan arrays exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from of_spmm_tpu import native as jnative
from of_spmm_tpu.ops import autograd as jag
from of_spmm_tpu.ops import reference as jref
from of_spmm_tpu.ops import registry as jreg
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch import native
from of_spmm_tpu_torch.ops import autograd as ag
from of_spmm_tpu_torch.ops import reference as ref
from of_spmm_tpu_torch.ops import registry as reg
from of_spmm_tpu_torch.sparse.formats import CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * (np.abs(want).max() if want.size else 0) + ATOL)


def _rand(n, m, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density) * rng.standard_normal((n, m))).astype(np.float32)


def _big_rows(seed=11, n=300):
    """tests/test_fused_plan.py's big-row case: a random pattern plus one
    row of degree ~0.9 n, wider than a (1, 4, 16, 64) ladder's top."""
    rng = np.random.default_rng(seed)
    dense = rng.random((n, n)) < 0.01
    dense[7, :] |= rng.random(n) < 0.9
    a = sp.csr_matrix(dense.astype(np.float32))
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    return a.toarray()


def _zero_products():
    """A's nonzeros all land on rows of B without nonzeros."""
    a = np.zeros((6, 5), np.float32)
    a[[0, 2, 5], [1, 1, 3]] = [1.0, 2.0, 3.0]
    b = np.zeros((5, 4), np.float32)
    b[[0, 2, 4], [0, 3, 1]] = [4.0, 5.0, 6.0]
    return a, b


CASES = {
    "rect": lambda: (_rand(60, 50, 0.1, 0), _rand(50, 70, 0.1, 1)),
    "padded": lambda: (_rand(200, 160, 0.08, 5), _rand(160, 180, 0.08, 6)),
    "products": lambda: (_rand(150, 170, 0.09, 9), _rand(170, 140, 0.07, 10)),
    "big_rows": lambda: (_big_rows(), _big_rows()),
    "ones": lambda: (np.ones((4, 4), np.float32), np.ones((4, 4), np.float32)),
    "empty": lambda: (np.zeros((8, 5), np.float32), np.zeros((5, 6), np.float32)),
    "zero_products": _zero_products,
}


def _pairs(name):
    da, db = CASES[name]()
    return da, db, JCSR.from_dense(da), JCSR.from_dense(db), CSR.from_dense(da), CSR.from_dense(db)


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _merged(rows, cols, vals, shape):
    out = np.zeros(shape, np.float64)
    np.add.at(out, (np.asarray(rows, np.int64), np.asarray(cols, np.int64)),
              np.asarray(vals, np.float64))
    return out


@pytest.fixture(params=["native", "fallback"])
def native_mode(request, monkeypatch):
    """Both packages with their native library, or both without it."""
    if request.param == "fallback":
        monkeypatch.setattr(jnative, "_lib", lambda: None)
        monkeypatch.setattr(native, "_lib", lambda: None)
    assert native.available() == jnative.available()
    return request.param


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_spgemm_matches_jax(name, native_mode):
    da, db, ja, jb, ta, tb = _pairs(name)
    want = jref.spgemm(ja, jb)
    got = ref.spgemm(ta, tb)
    assert got.shape == want.shape == (da.shape[0], db.shape[1])
    assert got.indptr.dtype == np.int32  # the JAX package's cast
    for f in ("indptr", "cols"):
        _eq(getattr(got, f), getattr(want, f))
    _close(got.vals, np.asarray(want.vals))
    _close(got.to_dense(), da.astype(np.float64) @ db)


def test_host_spgemm_shape_mismatch():
    for mod, c in ((jref, JCSR.from_dense(np.eye(3, dtype=np.float32))),
                   (ref, CSR.from_dense(np.eye(3, dtype=np.float32)))):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.spgemm(c, type(c).from_dense(np.eye(4, dtype=np.float32)))


@pytest.mark.parametrize("name", ["rect", "padded", "big_rows", "empty", "zero_products"])
def test_symbolic_plan_matches_jax(name):
    _, _, ja, jb, ta, tb = _pairs(name)
    want, got = jag.spgemm_symbolic(ja, jb), ag.spgemm_symbolic(ta, tb)
    for f in ("a_pos", "b_pos", "out_slot", "indptr", "cols"):
        _eq(getattr(got, f), getattr(want, f))
    assert (got.shape, got.out_nnz) == (want.shape, want.out_nnz)


def _padded_eq(got, want):
    assert len(got.buckets) == len(want.buckets)
    for (w, pa, pb), (jw, jpa, jpb) in zip(got.buckets, want.buckets):
        assert w == jw
        _eq(pa, jpa)
        _eq(pb, jpb)
    _eq(got.rows, want.rows)
    _eq(got.cols, want.cols)
    assert (got.shape, got.out_nnz, got.n_products) == \
        (want.shape, want.out_nnz, want.n_products)


@pytest.mark.parametrize("name, max_width", [("padded", 8), ("padded", 512), ("big_rows", 8),
                                             ("big_rows", 64), ("empty", 8),
                                             ("zero_products", 4)])
def test_padded_plan_matches_jax(name, max_width):
    _, _, ja, jb, ta, tb = _pairs(name)
    _padded_eq(ag.spgemm_symbolic_padded(ta, tb, max_width=max_width),
               jag.spgemm_symbolic_padded(ja, jb, max_width=max_width))


def test_padded_max_width_must_be_a_power_of_two():
    _, _, ja, jb, ta, tb = _pairs("rect")
    for fn, a, b in ((jag.spgemm_symbolic_padded, ja, jb), (ag.spgemm_symbolic_padded, ta, tb)):
        with pytest.raises(ValueError, match="power of two"):
            fn(a, b, max_width=12)


def _products_eq(got, want):
    _eq(got.a_perm, want.a_perm)
    _eq(got.ell_idx, want.ell_idx)
    assert got.ell_ptr == want.ell_ptr
    assert len(got.buckets) == len(want.buckets)
    for (W, lo, hi, br), (jW, jlo, jhi, jbr) in zip(got.buckets, want.buckets):
        assert (W, lo, hi) == (jW, jlo, jhi)
        _eq(br, jbr)
    _eq(got.rows, want.rows)
    _eq(got.cols, want.cols)
    assert (got.shape, got.n_products, got.n_out) == (want.shape, want.n_products, want.n_out)


PRODUCT_CASES = [("products", (1, 2, 4, 8, 16, 32)), ("big_rows", (1, 4, 16, 64)),
                 ("ones", (1, 2)), ("padded", (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)),
                 ("empty", (1, 2, 4)), ("zero_products", (1, 2))]


@pytest.mark.parametrize("name, ladder", PRODUCT_CASES)
def test_products_plan_matches_jax(name, ladder):
    _, _, ja, jb, ta, tb = _pairs(name)
    _products_eq(ag.spgemm_symbolic_products(ta, tb, ladder=ladder),
                 jag.spgemm_symbolic_products(ja, jb, ladder=ladder))


def _vals(c, seed):
    """Seeded float32 values on c's pattern."""
    return np.random.default_rng(seed).standard_normal(c.nnz).astype(np.float32)


def _grads(fn_t, fn_j, a_vals, b_vals, n_out, seed):
    """Gradients of sum(numeric * w) in both value arrays: torch autograd
    and jax.grad."""
    w = np.random.default_rng(seed).standard_normal(n_out).astype(np.float32)
    at = torch.from_numpy(a_vals).requires_grad_()
    bt = torch.from_numpy(b_vals).requires_grad_()
    (fn_t(at, bt) * torch.from_numpy(w)).sum().backward()
    ga, gb = jax.grad(lambda a, b: jnp.sum(fn_j(a, b) * jnp.asarray(w)), argnums=(0, 1))(
        jnp.asarray(a_vals), jnp.asarray(b_vals))
    _close(at.grad.numpy(), np.asarray(ga))
    _close(bt.grad.numpy(), np.asarray(gb))


@pytest.mark.parametrize("name", ["rect", "padded", "big_rows", "empty", "zero_products"])
def test_numeric_matches_jax(name):
    da, db, ja, jb, ta, tb = _pairs(name)
    plan, jplan = ag.spgemm_symbolic(ta, tb), jag.spgemm_symbolic(ja, jb)
    av, bv = np.asarray(ta.vals), np.asarray(tb.vals)

    def fn_t(a, b):
        return ag.spgemm_numeric(plan.a_pos, plan.b_pos, plan.out_slot, a, b, plan.out_nnz)

    def fn_j(a, b):
        return jag.spgemm_numeric(jplan.a_pos, jplan.b_pos, jplan.out_slot, a, b,
                                  out_nnz=jplan.out_nnz)

    got = fn_t(torch.from_numpy(av), torch.from_numpy(bv)).numpy()
    assert got.shape == (plan.out_nnz,)
    _close(got, np.asarray(fn_j(jnp.asarray(av), jnp.asarray(bv))))
    c = CSR.from_arrays(plan.indptr, plan.cols, got, plan.shape)
    _close(c.to_dense(), da.astype(np.float64) @ db)
    _grads(fn_t, fn_j, av, bv, plan.out_nnz, seed=1)


@pytest.mark.parametrize("name, max_width", [("padded", 8), ("big_rows", 64), ("empty", 8),
                                             ("zero_products", 4)])
def test_numeric_padded_matches_jax(name, max_width):
    da, db, ja, jb, ta, tb = _pairs(name)
    plan = ag.spgemm_symbolic_padded(ta, tb, max_width=max_width)
    jplan = jag.spgemm_symbolic_padded(ja, jb, max_width=max_width)
    av, bv = np.asarray(ta.vals), np.asarray(tb.vals)

    def fn_t(a, b):
        return ag.spgemm_numeric_padded(plan.buckets, a, b)

    def fn_j(a, b):
        return jag.spgemm_numeric_padded(jplan.buckets, a, b)

    got = fn_t(torch.from_numpy(av), torch.from_numpy(bv)).numpy()
    assert got.shape == (plan.out_nnz,)
    _close(got, np.asarray(fn_j(jnp.asarray(av), jnp.asarray(bv))))
    _close(_merged(plan.rows, plan.cols, got, plan.shape), da.astype(np.float64) @ db)
    _grads(fn_t, fn_j, av, bv, plan.out_nnz, seed=2)


@pytest.mark.parametrize("name, ladder", PRODUCT_CASES)
def test_numeric_products_matches_jax(name, ladder):
    """Product order, duplicates and pad zeros unmerged: equal entry by
    entry to JAX's, and the dense product once merged."""
    da, db, ja, jb, ta, tb = _pairs(name)
    plan = ag.spgemm_symbolic_products(ta, tb, ladder=ladder)
    jplan = jag.spgemm_symbolic_products(ja, jb, ladder=ladder)
    av, bv = np.asarray(ta.vals), np.asarray(tb.vals)

    def fn_t(a, b):
        return ag.spgemm_numeric_products(plan, a, b)

    def fn_j(a, b):
        return jag.spgemm_numeric_products(jplan, a, b)

    got = fn_t(torch.from_numpy(av), torch.from_numpy(bv)).numpy()
    assert got.shape == (plan.n_out,)
    _close(got, np.asarray(fn_j(jnp.asarray(av), jnp.asarray(bv))))
    _close(_merged(plan.rows, plan.cols, got, plan.shape), da.astype(np.float64) @ db)
    _grads(fn_t, fn_j, av, bv, plan.n_out, seed=3)


@pytest.mark.parametrize("name", ["rect", "big_rows", "empty"])
def test_spgemm_device_and_plan_reuse(name):
    """spgemm_device on the CPU against the JAX package's and the host
    product; the returned plan, passed back with new A values, gives the
    new product and is not placed again."""
    _, _, ja, jb, ta, tb = _pairs(name)
    c, plan = ag.spgemm_device(ta, tb, device="cpu")
    jc, _ = jag.spgemm_device(ja, jb)
    host = ref.spgemm(ta, tb)
    assert isinstance(plan.a_pos, torch.Tensor) and plan.a_pos.device.type == "cpu"
    assert isinstance(c.vals, np.ndarray) and c.nnz == host.nnz == plan.out_nnz
    for f in ("indptr", "cols"):
        _eq(getattr(c, f), getattr(jc, f))
        _eq(getattr(c, f), getattr(host, f))
    _close(c.vals, np.asarray(jc.vals))
    _close(c.vals, host.vals)
    a2 = CSR(indptr=ta.indptr, cols=ta.cols, vals=_vals(ta, 4), shape=ta.shape)
    c2, plan2 = ag.spgemm_device(a2, tb, plan, device="cpu")
    assert plan2.a_pos is plan.a_pos
    _close(c2.vals, ref.spgemm(a2, tb).vals)


def test_spgemm_device_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: spgemm_device runs there")
    a = CSR.from_dense(np.eye(3, dtype=np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ag.spgemm_device(a, a)


def test_registry_entry():
    op, jop = reg.lookup("spgemm"), jreg.lookup("spgemm")
    assert op.oracle is ref.spgemm and op.impl("host") is ref.spgemm
    assert [(r.ins, r.outs) for r in op.sharding_rules] == \
        [(r.ins, r.outs) for r in jop.sharding_rules]
    _, _, ja, jb, ta, tb = _pairs("rect")
    got, want = op.impl("host")(ta, tb), jop.impl("host")(ja, jb)
    _eq(got.cols, want.cols)
    _close(got.vals, np.asarray(want.vals))
