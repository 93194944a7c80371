"""Rank-1 value detection (the JAX package's sparse/expansion2.py keeps
it beside the expansion-v2 plan; the port has only ``factor_rank1``, which
the panel plan needs, until the expansion2 engine is ported)."""

from __future__ import annotations

import numpy as np

from of_spmm_tpu_torch.sparse.formats import CSR


def factor_rank1(csr: CSR, rtol: float = 1e-6):
    """Try to factor vals[e] = r[row[e]] * c[col[e]] (degree-normalized
    adjacencies are exactly this form). Returns (r, c) float64 numpy
    arrays or None.

    Tests the candidates that cover the package's normalizations:
    c_j = f(deg_j) with r_i = g(deg_i): sym (f=g=deg^-1/2), row (r=deg^-1,
    c=1), col (r=1, c=deg^-1), unweighted (r=c=1), and for square matrices
    the same row-degree (or column-degree) scaling on both sides.
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    vals = np.asarray(csr.vals, dtype=np.float64)
    if vals.size == 0:
        return np.ones(n), np.ones(m)
    deg_out = np.diff(indptr).astype(np.float64)
    deg_in = np.bincount(cols, minlength=m).astype(np.float64)
    with np.errstate(divide="ignore"):
        inv_out = np.where(deg_out > 0, 1.0 / deg_out, 0.0)
        inv_in = np.where(deg_in > 0, 1.0 / deg_in, 0.0)
        rs_out = np.where(deg_out > 0, deg_out ** -0.5, 0.0)
        rs_in = np.where(deg_in > 0, deg_in ** -0.5, 0.0)
    candidates = [
        (np.ones(n), np.ones(m)),                # unweighted
        (rs_out, rs_in),                         # sym normalized
        (inv_out, np.ones(m)),                   # row normalized
        (np.ones(n), inv_in),                    # col normalized
    ]
    if n == m:
        # GCN normalization of a directed square graph applies the row
        # degrees on both sides (models/gcn.py normalized_adjacency); its
        # transpose factors with the column degrees on both sides
        candidates.append((rs_out, rs_out))
        candidates.append((inv_out, inv_out))
        candidates.append((rs_in, rs_in))
        candidates.append((inv_in, inv_in))
    # screen the candidates on a random edge sample, then verify the
    # survivor on a capped subsample (4M edges)
    nnz = vals.shape[0]
    rng0 = np.random.default_rng(0)

    def row_of(idx):
        return np.searchsorted(indptr, idx, side="right") - 1

    if nnz > 1 << 20:
        sample = rng0.integers(0, nnz, 1 << 16)
        rs, cs, vs = row_of(sample), cols[sample], vals[sample]
    else:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        rs, cs, vs = rows, cols, vals
    for r, c in candidates:
        if not np.allclose(r[rs] * c[cs], vs, rtol=rtol, atol=0):
            continue
        if nnz > rs.shape[0]:
            ver = rng0.integers(0, nnz, min(nnz, 1 << 22))
            if not np.allclose(r[row_of(ver)] * c[cols[ver]], vals[ver],
                               rtol=rtol, atol=0):
                continue
        return r, c
    return None
