"""Core sparse formats: COO and CSR over host numpy arrays.

Sparse aggregation is an edge list driving a row gather and a segment sum:
COO is that edge list, and CSR adds the row pointers the row-binned plans
are built from. Both are immutable dataclasses of numpy arrays: they are
plan-time data, built and binned on the host, and never placed on the card
themselves (the plans built from them are, by ``ops.place_operator``).

Numerics contract: out-of-range indices contribute zeros (see
``ops.reference.gather``); comparisons use rtol=1e-4 / atol=1e-5.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Shape2 = Tuple[int, int]

# Below this many nonzeros numpy's lexsort is as fast as the native sort.
_NATIVE_MIN_NNZ = 1 << 18


def _as_index_array(x) -> np.ndarray:
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.integer):
        raise TypeError(f"index array must be integer, got {x.dtype}")
    return x.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix: (rows, cols, vals) triples.

    ``rows`` are the segment ids of the segment sum and ``cols`` the
    gather indices.

    >>> coo = COO.from_arrays([0, 1], [1, 0], [2.0, 1.0], (2, 2))
    >>> coo.nnz
    2
    >>> CSR.from_coo(coo).to_dense().tolist()
    [[0.0, 2.0], [1.0, 0.0]]
    """

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float
    shape: Shape2  # (n_rows, n_cols)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_arrays(cls, rows, cols, vals, shape: Shape2) -> "COO":
        rows = _as_index_array(rows)
        cols = _as_index_array(cols)
        vals = np.asarray(vals)
        if rows.shape != cols.shape or rows.shape != vals.shape:
            raise ValueError(
                f"rows/cols/vals must have equal shapes, got "
                f"{rows.shape}/{cols.shape}/{vals.shape}"
            )
        return cls(rows=rows, cols=cols, vals=vals, shape=tuple(shape))

    @classmethod
    def from_dense(cls, dense) -> "COO":
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError("COO.from_dense expects a 2-D matrix")
        r, c = np.nonzero(dense)
        return cls.from_arrays(r, c, dense[r, c], dense.shape)

    @classmethod
    def from_edges(cls, src, dst, n_nodes: int, vals=None) -> "COO":
        """Adjacency matrix A[dst, src] = val from a directed edge list.

        Row i of A holds the in-neighbourhood of node i, so ``A @ X``
        aggregates neighbour features into each destination node.
        """
        src = np.asarray(src)
        dst = np.asarray(dst)
        if vals is None:
            vals = np.ones(src.shape[0], dtype=np.float32)
        return cls.from_arrays(dst, src, vals, (n_nodes, n_nodes))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def sort_by_row(self) -> "COO":
        """Sort triples by (row, col)."""
        order = np.lexsort((self.cols, self.rows))
        return COO.from_arrays(self.rows[order], self.cols[order],
                               self.vals[order], self.shape)

    def transpose(self) -> "COO":
        return COO(rows=self.cols, cols=self.rows, vals=self.vals,
                   shape=(self.shape[1], self.shape[0]))

    def validate(self) -> None:
        n, m = self.shape
        if self.rows.size and (self.rows.min() < 0 or self.rows.max() >= n):
            raise ValueError(f"row indices out of range [0, {n})")
        if self.cols.size and (self.cols.min() < 0 or self.cols.max() >= m):
            raise ValueError(f"col indices out of range [0, {m})")


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix: (indptr, cols, vals).

    ``indptr`` has length n_rows + 1; row i owns the nnz slice
    [indptr[i], indptr[i+1]). Columns within a row are ascending by
    construction (from_coo sorts).

    >>> csr = CSR.from_dense(np.array([[0., 2.], [1., 0.]], np.float32))
    >>> csr.nnz, csr.shape
    (2, (2, 2))
    >>> csr.transpose().to_dense().tolist()
    [[0.0, 1.0], [2.0, 0.0]]
    """

    indptr: np.ndarray  # (n_rows + 1,) int
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float
    shape: Shape2

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_coo(cls, coo: COO) -> "CSR":
        """Sort a COO into CSR: the native parallel counting sort for
        large float32 inputs, numpy lexsort otherwise."""
        n = coo.shape[0]
        if coo.vals.dtype == np.float32 and coo.nnz >= _NATIVE_MIN_NNZ:
            from of_spmm_tpu_torch import native

            if native.available():
                indptr, out_cols, out_vals = native.coo_to_csr(
                    coo.rows, coo.cols, coo.vals, n)
                return cls(indptr=indptr, cols=out_cols, vals=out_vals,
                           shape=coo.shape)
        s = coo.sort_by_row()
        counts = np.bincount(s.rows, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, cols=s.cols, vals=s.vals, shape=coo.shape)

    @classmethod
    def from_dense(cls, dense) -> "CSR":
        return cls.from_coo(COO.from_dense(dense))

    @classmethod
    def from_arrays(cls, indptr, cols, vals, shape: Shape2) -> "CSR":
        indptr = _as_index_array(indptr)
        cols = _as_index_array(cols)
        vals = np.asarray(vals)
        if indptr.shape[0] != shape[0] + 1:
            raise ValueError(f"indptr length {indptr.shape[0]} != n_rows+1 ({shape[0] + 1})")
        return cls(indptr=indptr, cols=cols, vals=vals, shape=tuple(shape))

    def to_coo(self) -> COO:
        counts = np.diff(self.indptr)
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int32), counts)
        return COO.from_arrays(rows, self.cols, self.vals, self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def transpose(self) -> "CSR":
        """A^T in CSR: the operand of the backward SpMM."""
        if self.vals.dtype == np.float32 and self.nnz >= _NATIVE_MIN_NNZ:
            from of_spmm_tpu_torch import native

            if native.available():
                ip, c, v = native.csr_transpose(self.indptr, self.cols,
                                                self.vals, self.shape)
                return CSR(indptr=ip, cols=c, vals=v,
                           shape=(self.shape[1], self.shape[0]))
        return CSR.from_coo(self.to_coo().transpose())

    def row_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def validate(self) -> None:
        if self.indptr[0] != 0 or self.indptr[-1] != self.nnz:
            raise ValueError("indptr must start at 0 and end at nnz")
        if (np.diff(self.indptr) < 0).any():
            raise ValueError("indptr must be non-decreasing")
        if self.cols.size and (self.cols.min() < 0 or self.cols.max() >= self.shape[1]):
            raise ValueError(f"col indices out of range [0, {self.shape[1]})")
