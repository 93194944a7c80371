"""Column-tiered binned-ELL: the large-graph SpMM layout.

The column space is split into tiers of ``tier_size`` columns; each row's
nonzeros inside one tier form a contiguous run (CSR columns are sorted),
runs are chunked to <= the widest ladder width, and each chunk becomes an
ELL row of bucket (tier, width) whose column indices are tier-local.
Runs shorter than ``min_run`` are diverted to per-row cold chunks under
tier -1 that index the full X. One pos-gather (``Finish``) assembles the
output rows from the concatenated bucket results, and a sorted scatter-add
folds in rows split across tiers or chunks.

The tiering answers a TPU gather-table-size cliff; the H100 has no such
cliff. It is kept because ``make_operator(layout="auto")`` picks it for
every graph wider than one tier, and the same plan must give the same
numbers in both packages: the arrays here equal those of
``of_spmm_tpu.sparse.tiled`` on the same CSR.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.binned import (
    SUBLANES,
    EllBucket,
    Finish,
    _build_finish,
    _ell_slots,
    _padded_rows,
    ladder_from_hist,
)
from of_spmm_tpu_torch.sparse.formats import CSR

DEFAULT_TIER_SIZE = 131072


@dataclasses.dataclass(frozen=True)
class TierBlock:
    """All width-buckets of one column tier; cols are tier-local
    (tier -1: full-table column indices)."""

    tier: int  # column range [tier*tier_size, (tier+1)*tier_size)
    buckets: Tuple[EllBucket, ...]


@dataclasses.dataclass(frozen=True)
class TieredEll:
    """Column-tiered ELL plan for Y = A @ X."""

    tiers: Tuple[TierBlock, ...]
    finish: Finish
    shape: Tuple[int, int]  # logical (n_rows, n_cols)
    tier_size: int

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_padded(self) -> int:
        return sum(b.n_ell_rows * b.width for t in self.tiers for b in t.buckets)

    @property
    def n_ell_rows(self) -> int:
        return sum(b.n_ell_rows for t in self.tiers for b in t.buckets)

    def padding_efficiency(self, true_nnz: int) -> float:
        p = self.nnz_padded
        return float(true_nnz) / p if p else 1.0


def bin_rows_tiered(
    csr: CSR,
    tier_size: int = DEFAULT_TIER_SIZE,
    ladder="auto",
    sublanes: int = SUBLANES,
    max_buckets: int = 8,
    max_width: int = 256,
    min_run: int = 4,
) -> TieredEll:
    """Build the tiered plan (host-side numpy; see the module docstring).

    ``min_run``: runs shorter than this (a row's stray nonzeros in a
    foreign tier) go to per-row cold chunks under tier -1. Without that,
    stray single-nnz runs multiply the ELL row count and the finish's
    scatter work.
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols).astype(np.int64)
    vals = np.asarray(csr.vals)
    nnz = cols.shape[0]
    n_tiers = max(-(-m // tier_size), 1)

    # split every row into (row, tier) runs: boundaries where the tier of
    # consecutive nnz changes or a row starts
    tier_of = cols // tier_size
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    if nnz:
        new_run = np.ones(nnz, dtype=bool)
        new_run[1:] = (tier_of[1:] != tier_of[:-1]) | (row_of[1:] != row_of[:-1])
        run_start = np.nonzero(new_run)[0]
        run_end = np.concatenate([run_start[1:], [nnz]])
        run_len = run_end - run_start
        run_row = row_of[run_start]
        run_tier = tier_of[run_start]
    else:
        run_start = run_len = run_row = run_tier = np.zeros(0, np.int64)

    # divert short runs to per-row cold chunks (tier -1)
    cold_idx = np.zeros(0, np.int64)
    c_run_start_c = c_run_len = c_run_row = np.zeros(0, np.int64)
    if min_run > 1 and n_tiers > 1 and run_start.shape[0]:
        cold_run = run_len < min_run
        if cold_run.any():
            cold_nnz = np.zeros(nnz, dtype=bool)
            c_starts = run_start[cold_run]
            c_lens = run_len[cold_run]
            pos = np.repeat(c_starts, c_lens) + (
                np.arange(int(c_lens.sum()), dtype=np.int64)
                - np.repeat(np.cumsum(np.concatenate([[0], c_lens[:-1]])), c_lens)
            )
            cold_nnz[pos] = True
            run_start = run_start[~cold_run]
            run_len = run_len[~cold_run]
            run_row = run_row[~cold_run]
            run_tier = run_tier[~cold_run]
            # one cold run per row, in a compacted nnz space (cold_idx maps
            # it back to original nnz positions)
            cold_idx = np.nonzero(cold_nnz)[0]
            cold_rows = row_of[cold_idx]
            boundary = np.ones(cold_idx.shape[0], dtype=bool)
            boundary[1:] = cold_rows[1:] != cold_rows[:-1]
            c_run_start_c = np.nonzero(boundary)[0]
            c_run_end_c = np.concatenate([c_run_start_c[1:], [cold_idx.shape[0]]])
            c_run_len = c_run_end_c - c_run_start_c
            c_run_row = cold_rows[c_run_start_c]

    def chunkify(starts, lens, rows, tiers):
        n_chunks = -(-lens // max_width)
        chunk_run = np.repeat(np.arange(starts.shape[0], dtype=np.int64), n_chunks)
        total = chunk_run.shape[0]
        first = np.zeros(starts.shape[0] + 1, dtype=np.int64)
        np.cumsum(n_chunks, out=first[1:])
        in_run = np.arange(total, dtype=np.int64) - np.repeat(first[:-1], n_chunks)
        c_start = starts[chunk_run] + in_run * max_width
        c_len = np.minimum(max_width, lens[chunk_run] - in_run * max_width)
        return c_start, c_len, rows[chunk_run], tiers[chunk_run]

    chunk_start, chunk_len, chunk_row, chunk_tier = chunkify(
        run_start, run_len, run_row, run_tier
    )
    if c_run_row.shape[0]:
        cc_start, cc_len, cc_row, cc_tier = chunkify(
            c_run_start_c, c_run_len, c_run_row,
            np.full(c_run_row.shape[0], -1, dtype=np.int64),
        )
        chunk_start = np.concatenate([chunk_start, cc_start])
        chunk_len = np.concatenate([chunk_len, cc_len])
        chunk_row = np.concatenate([chunk_row, cc_row])
        chunk_tier = np.concatenate([chunk_tier, cc_tier])

    # one global ladder from the chunk-length histogram
    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        hist = np.bincount(
            np.minimum(chunk_len, max_width), minlength=max_width + 1
        ).astype(np.int64)
        hist[0] = 0
        ladder = ladder_from_hist(hist, max_buckets=max_buckets, max_width=max_width)
    ladder = tuple(sorted(set(int(w) for w in ladder)))
    ladder_arr = np.asarray(ladder, dtype=np.int64)
    width_idx = np.searchsorted(ladder_arr, chunk_len, side="left")

    # per-(tier, width) buckets, tier -1 first; one lexsort groups chunks
    # by (tier, width) so each bucket is a contiguous slice
    order = np.lexsort((width_idx, chunk_tier))
    s_tier = chunk_tier[order]
    s_width = width_idx[order]
    group_key = (s_tier + 1) * (len(ladder) + 1) + s_width
    g_bounds = np.nonzero(
        np.concatenate([[True], group_key[1:] != group_key[:-1]])
    )[0]
    g_ends = np.concatenate([g_bounds[1:], [order.shape[0]]])

    tier_blocks = []
    real_rids = []  # per emitted bucket (concat order): real row ids
    bucket_totals = []
    groups_by_tier: dict = {}
    # a matrix without nonzeros has no chunks and is planned with no tiers
    # (spmm then returns zeros); the JAX package raises IndexError here
    for lo, hi in zip(g_bounds, g_ends) if order.shape[0] else ():
        groups_by_tier.setdefault(int(s_tier[lo]), []).append(
            (int(s_width[lo]), order[lo:hi])
        )
    for t in [-1] + list(range(n_tiers)):
        if t not in groups_by_tier:
            continue
        buckets = []
        for wi, sel in groups_by_tier[t]:
            w = ladder[wi]
            nsel = sel.shape[0]
            if nsel == 0:
                continue
            rids = chunk_row[sel]
            total = nsel + (-nsel % sublanes)
            b_cols = np.zeros((total, w), dtype=np.int32)
            b_vals = np.zeros((total, w), dtype=vals.dtype)
            dst_row, intra, src = _ell_slots(chunk_start[sel], chunk_len[sel])
            if t < 0:
                src = cold_idx[src]  # compacted cold space -> original nnz
                b_cols[dst_row, intra] = cols[src]  # full-table indices
            else:
                b_cols[dst_row, intra] = cols[src] - t * tier_size  # tier-local
            b_vals[dst_row, intra] = vals[src]
            buckets.append(EllBucket(row_ids=_padded_rows(rids, total),
                                     cols=b_cols, vals=b_vals))
            real_rids.append(rids)
            bucket_totals.append(total)
        tier_blocks.append(TierBlock(tier=t, buckets=tuple(buckets)))

    finish = _build_finish(real_rids, bucket_totals, n)
    return TieredEll(
        tiers=tuple(tier_blocks),
        finish=finish,
        shape=csr.shape,
        tier_size=tier_size,
    )
