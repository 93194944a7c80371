"""The SpMM backward on every layout, against float64 dense products.

``x.grad`` of ``(spmm(op, x) * w).sum()`` is A^T @ w: the backward runs
the forward engine on the transpose plan (``op.binned_t`` with
``op.work_t``). Each layout (binned relabeled, binned plain, tiered with
a cold tier, panels, fused, ranges, expansion), with ``impl="torch"``
and ``impl="cuda"`` on CPU tensors (the kernels' plain versions), on a
symmetric matrix (aliased transpose plan), a non-symmetric one (built
transpose plan) and a tall and a wide rectangular one. No JAX:

    python -m pytest --noconftest tests/test_torch_spmm_grad.py -q
"""

import functools

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.models import normalized_adjacency
from of_spmm_tpu_torch.ops import autograd as ag
from of_spmm_tpu_torch.ops import make_operator, spmm, spmm_internal
from of_spmm_tpu_torch.ops.cuda import spmm as kernels
from of_spmm_tpu_torch.sparse.formats import COO, CSR
from of_spmm_tpu_torch.sparse.tiled import TieredEll

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

# the reference parity bar (tests/conftest.py; this file runs without it)
RTOL, ATOL = 1e-4, 1e-5

LAYOUTS = {
    "binned_relabeled": dict(layout="binned"),
    "binned_plain": dict(layout="binned", relabel=False),
    "tiered_cold": dict(layout="tiered", tier_size=32),
    "panels": dict(layout="panels"),
    "fused": dict(layout="fused"),
    "ranges": dict(layout="ranges"),
    "expansion": dict(layout="expansion"),
}


def _random_graph(n: int, m: int, e: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, m, e), rng


@functools.lru_cache(maxsize=None)
def _matrix(kind: str) -> CSR:
    """symmetric: a normalized adjacency (symmetric values); general: a
    square matrix with values uniform in [-1, 1]; tall / wide:
    rectangular, with values k / 64. Each non-symmetric one has a heavy
    row and an empty one.

    The one-hot engines (fused, ranges, expansion) carry each value as a
    bf16 hi / lo pair, about 2^-17 relative (a reference quirk, ROADMAP.md
    Queue 3), and tests compare against the float64 product of the plan's
    values: k / 64 is one bf16, so there the plan's values are A's; the
    symmetric and general matrices keep values the split rounds."""
    if kind == "symmetric":
        src, dst, _ = _random_graph(150, 150, 700, 1)
        a = CSR.from_coo(COO.from_edges(np.r_[src, dst], np.r_[dst, src], 150))
        return normalized_adjacency(a)
    shape = {"general": (140, 140), "tall": (170, 90), "wide": (80, 190)}[kind]
    rows, cols, rng = _random_graph(*shape, 800, {"general": 2, "tall": 3, "wide": 4}[kind])
    rows = np.r_[rows, np.full(shape[1], 5)]  # a heavy row
    cols = np.r_[cols, np.arange(shape[1])]
    keep = rows != 9  # an empty row
    vals = rng.uniform(-1.0, 1.0, keep.sum()).astype(np.float32)
    if kind != "general":
        vals = np.round(vals * 64) / np.float32(64)
    coo = COO.from_arrays(rows[keep], cols[keep], vals, shape)
    dense = coo.to_dense()  # duplicates summed, as CSR.from_coo does
    return CSR.from_dense(dense)


@functools.lru_cache(maxsize=None)
def _operator(layout: str, kind: str):
    return make_operator(_matrix(kind), device="cpu", **LAYOUTS[layout])


CASES = [(layout, kind) for layout in LAYOUTS for kind in ("symmetric", "general", "tall", "wide")
         if not (layout == "binned_relabeled" and kind in ("tall", "wide"))]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("layout,kind", CASES)
def test_backward_is_transpose_product(layout, kind, impl):
    a = _matrix(kind)
    op = _operator(layout, kind)
    # the plain binned plan builds its transpose whatever A is, as the JAX
    # package's does
    assert op.transpose_aliased == (kind == "symmetric" and layout != "binned_plain")
    if layout == "tiered_cold":
        assert isinstance(op.binned, TieredEll) and op.binned.tiers[0].tier == -1
    assert op.relabeled == (layout == "binned_relabeled")
    rng = np.random.default_rng(7)
    n, m = a.shape
    x = torch.from_numpy(rng.standard_normal((m, 12)).astype(np.float32)).requires_grad_()
    w = rng.standard_normal((n, 12)).astype(np.float32)
    y = spmm(op, x, impl=impl)
    assert y.grad_fn is not None and y.shape == (n, 12)
    (y * torch.from_numpy(w)).sum().backward()
    dense = a.to_dense().astype(np.float64)
    np.testing.assert_allclose(y.detach().numpy(), dense @ x.detach().numpy().astype(np.float64),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), dense.T @ w.astype(np.float64),
                               rtol=RTOL, atol=ATOL)


def test_no_backward_spmm_without_input_grad(monkeypatch):
    """x that needs no grad: one SpMM (the forward), none in the backward,
    though the loss's graph goes through the SpMM's output; x that does:
    the backward's SpMM runs on the transpose plan with its work list."""
    op = _operator("tiered_cold", "general")
    calls = []

    def counted(plan, x, impl, work=None):
        calls.append((plan, work))
        return impl_fn(plan, x, impl, work)

    impl_fn = ag._spmm_impl
    monkeypatch.setattr(ag, "_spmm_impl", counted)
    x = torch.ones((140, 3))
    w = torch.ones((3, 2), requires_grad=True)
    (spmm(op, x) @ w).sum().backward()
    assert [c[0] for c in calls] == [op.binned] and w.grad is not None
    calls.clear()
    (spmm(op, x.clone().requires_grad_()) @ w).sum().backward()
    assert [c[0] for c in calls] == [op.binned, op.binned_t]
    assert calls[1][1] is op.work_t
    calls.clear()
    with torch.no_grad():
        spmm_internal(op, x.clone().requires_grad_())
    assert len(calls) == 1


def test_forward_with_grad_enabled_records_a_graph():
    op = _operator("binned_relabeled", "symmetric")
    x = torch.ones((150, 4), requires_grad=True)
    y = spmm(op, x)
    assert y.requires_grad and y.grad_fn is not None
    before = dict(kernels.LAUNCHES)  # CPU tensors: plain versions, no launches counted
    y.sum().backward()
    assert kernels.LAUNCHES == before and x.grad.shape == (150, 4)


def test_double_backward_is_refused():
    op = _operator("tiered_cold", "symmetric")
    x = torch.ones((150, 2), requires_grad=True)
    w = torch.ones((150, 2), requires_grad=True)  # a cotangent that needs grad
    (g,) = torch.autograd.grad((spmm(op, x) * w).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_coo_pattern_and_keep_coo(layout):
    """The operator keeps A's COO pattern in node space and CSR order
    (``.T`` swaps rows and columns); with keep_coo=False the edge-list ops
    raise ValueError on every layout."""
    a = _matrix("general")
    op = _operator(layout, "general")
    coo = a.to_coo()
    assert np.array_equal(op.coo_rows.numpy(), coo.rows)
    assert np.array_equal(op.coo_cols.numpy(), coo.cols)
    assert np.array_equal(op.coo_vals.numpy(), coo.vals)
    assert op.T.coo_rows is op.coo_cols and op.T.coo_cols is op.coo_rows
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(140).astype(np.float32))
    np.testing.assert_allclose(ag.spmv(op, x).numpy(), a.to_dense() @ x.numpy(), rtol=RTOL,
                               atol=ATOL)
    bare = make_operator(a, device="cpu", keep_coo=False, **LAYOUTS[layout])
    assert bare.coo_rows.shape == (0,)
    for fn in (lambda: ag.spmv(bare, x), lambda: ag.sddmm(bare, x[:, None], x[:, None])):
        with pytest.raises(ValueError, match="keep_coo=False"):
            fn()
    empty = make_operator(CSR.from_dense(np.zeros((6, 6), np.float32)), device="cpu",
                          keep_coo=False, layout="tiered")
    assert ag.spmv(empty, torch.ones(6)).shape == (6,)  # no nonzeros: nothing to need
