"""Row-binned padded-ELL format: the load-balanced kernel-facing layout.

Load balance is built at plan time, host-side:

- rows are binned by nnz into buckets whose widths come from a ladder
  (by default the DP-optimal one for the graph's degree histogram), and
  each row is padded with val=0, col=0 entries up to its bucket width;
- rows wider than the widest bucket are split into several ELL rows whose
  partial results are summed by the finish;
- each bucket's row count is padded to a multiple of 8 with zero-valued
  dummy rows.

The plan arrays are the same, array for array, as those of the JAX
package's ``of_spmm_tpu.sparse.binned`` on the same CSR, so a kernel of
either package can be checked plan for plan against the other.

Binning returns numpy arrays; ``ops.place_operator`` moves a finished plan
to a device as torch tensors. Field types are therefore ``Array``: numpy
before placement, torch after.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.formats import CSR

Array = Any  # np.ndarray (plan time) or torch.Tensor (placed)

DEFAULT_LADDER: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256)
SUBLANES = 8  # bucket row counts are padded to a multiple of this


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One padded-ELL bucket: R rows of exactly K (padded) nonzeros."""

    row_ids: Array  # (R,) int32: output row each ELL row adds into
    cols: Array  # (R, K) int32: padded with 0 (val 0 masks it)
    vals: Array  # (R, K) float: padding entries are exactly 0

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def n_ell_rows(self) -> int:
        return int(self.cols.shape[0])


@dataclasses.dataclass(frozen=True)
class Finish:
    """Plan-time permutation that turns bucket-ordered partial results into
    output rows with one gather instead of per-bucket scatters.

    ``pos[r]`` is the index (into the concatenation of all buckets' ELL
    rows) of the first ELL row writing output row r, or the sentinel
    ``total ELL rows`` for an empty row: a gather with out-of-range -> 0
    semantics turns it into a zero row. ``extra_*`` lists the remaining
    ELL rows of split rows; a sorted scatter-add over those finishes.
    """

    pos: Array  # (n_rows,) int32; sentinel = total ELL rows
    extra_rids: Array  # (E,) int32, ascending
    extra_idx: Array  # (E,) int32


@dataclasses.dataclass(frozen=True)
class BucketExtras:
    """Per-bucket split-row leftovers for the relabeled (slice-concat) finish.

    rids[b] are output rows (ascending) receiving contrib rows idx[b] of
    bucket b beyond each row's first chunk.
    """

    rids: Tuple[Array, ...]
    idx: Tuple[Array, ...]


@dataclasses.dataclass(frozen=True)
class BinnedEll:
    """A CSR matrix re-laid-out as a tuple of padded-ELL buckets.

    ``slice_counts``, when set, marks the relabeled layout: the first
    slice_counts[b] ELL rows of bucket b write output rows contiguously in
    bucket-concat order (see bin_rows_relabeled), so the finish is slicing
    and concatenation instead of a gather.
    """

    buckets: Tuple[EllBucket, ...]
    shape: Tuple[int, int]  # logical (n_rows, n_cols)
    has_split_rows: bool  # True if any row was split across ELL rows
    finish: Optional[Any] = None  # Finish | BucketExtras
    slice_counts: Optional[Tuple[int, ...]] = None

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_padded(self) -> int:
        return sum(b.n_ell_rows * b.width for b in self.buckets)

    def padding_efficiency(self, true_nnz: int) -> float:
        """Fraction of padded slots holding real nonzeros (1.0 = no waste)."""
        p = self.nnz_padded
        return float(true_nnz) / p if p else 1.0


def optimal_ladder(
    csr: CSR,
    max_buckets: int = 10,
    max_width: int = 256,
) -> Tuple[int, ...]:
    """Bucket widths minimizing the padded-slot count for this graph.

    Breakpoint DP over the (clipped) degree histogram: up to
    ``max_buckets`` widths w1 < ... < wB = max_width. Rows wider than
    max_width are pre-split into chunks <= max_width, as bin_rows splits
    them.
    """
    degs = np.diff(np.asarray(csr.indptr))
    degs = degs[degs > 0]
    if degs.size == 0:
        return (max_width,)
    n_full = (degs // max_width).sum()
    rem = degs % max_width
    rem = rem[rem > 0]
    hist = np.bincount(rem, minlength=max_width + 1).astype(np.int64)
    hist[max_width] += n_full
    return ladder_from_hist(hist, max_buckets=max_buckets, max_width=max_width)


def ladder_from_hist(
    hist: np.ndarray, max_buckets: int = 10, max_width: int = 256
) -> Tuple[int, ...]:
    """Breakpoint DP over a chunk-length histogram (see optimal_ladder)."""
    W = max_width
    # cost(a, b) = padded slots if chunk lengths (a, b] all map to width b
    csum = np.zeros(W + 1, dtype=np.int64)
    wsum = np.zeros(W + 1, dtype=np.int64)
    np.cumsum(hist, out=csum)  # csum[w] = #chunks with len <= w
    np.cumsum(hist * np.arange(W + 1), out=wsum)

    def cost(a: int, b: int) -> int:
        return b * (csum[b] - csum[a]) - (wsum[b] - wsum[a])

    B = max_buckets
    INF = 1 << 62
    # dp[j][w]: min padding using j buckets covering lengths (0, w]
    dp = np.full((B + 1, W + 1), INF, dtype=np.int64)
    choice = np.zeros((B + 1, W + 1), dtype=np.int32)
    dp[0, 0] = 0
    lens = np.nonzero(hist[1:])[0] + 1  # candidate breakpoints: present lens
    cands = sorted(set(lens.tolist()) | {W})
    for j in range(1, B + 1):
        for w in cands:
            best, arg = INF, 0
            for a in [0] + [c for c in cands if c < w]:
                if dp[j - 1, a] >= INF:
                    continue
                v = dp[j - 1, a] + cost(a, w)
                if v < best:
                    best, arg = v, a
            dp[j, w], choice[j, w] = best, arg
    j_best = min(range(1, B + 1), key=lambda j: dp[j, W])
    widths = []
    w, j = W, j_best
    while w > 0 and j > 0:
        widths.append(w)
        w = int(choice[j, w])
        j -= 1
    return tuple(sorted(widths))


def _resolve_ladder(csr: CSR, ladder, max_buckets: int, max_width: int) -> Tuple[int, ...]:
    if isinstance(ladder, str):
        if ladder != "auto":
            raise ValueError(f"ladder must be a sequence or 'auto', got {ladder!r}")
        ladder = optimal_ladder(csr, max_buckets=max_buckets, max_width=max_width)
    ladder = tuple(sorted(set(int(w) for w in ladder)))
    if not ladder:
        raise ValueError("ladder must be non-empty")
    return ladder


def _ell_slots(starts, lens):
    """Flat scatter of chunks into ELL rows: chunk c occupies slots
    (c, 0:lens[c]) and reads source nnz starts[c] : starts[c]+lens[c].
    Returns (dst_row, intra, src), one entry per nonzero."""
    n = lens.shape[0]
    dst_row = np.repeat(np.arange(n, dtype=np.int64), lens)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=cum[1:])
    intra = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(cum[:-1], lens)
    return dst_row, intra, np.repeat(starts, lens) + intra


def _padded_rows(rids, padded: int) -> np.ndarray:
    """Bucket row ids; padding rows repeat the last (max) id so row_ids
    stay ascending."""
    b_rows = np.zeros(padded, dtype=np.int32)
    b_rows[:rids.shape[0]] = rids
    b_rows[rids.shape[0]:] = rids[-1]
    return b_rows


def bin_rows(
    csr: CSR,
    ladder="auto",
    sublanes: int = SUBLANES,
    max_buckets: int = 10,
    max_width: int = 256,
) -> BinnedEll:
    """Bin CSR rows by degree into padded-ELL buckets (host-side, plan time).

    ``ladder="auto"`` runs the breakpoint DP (optimal_ladder). Rows with
    degree > max(ladder) are split into ceil(deg / max_width) ELL rows
    sharing one output row id; the finish sums them.

    Bucket row_ids are ascending (padding rows repeat the last row id with
    zero values).
    """
    ladder = _resolve_ladder(csr, ladder, max_buckets, max_width)
    max_w = ladder[-1]

    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols)
    vals = np.asarray(csr.vals)
    degs = np.diff(indptr)
    n_rows = csr.shape[0]

    # 1) chunk every row into pieces of length <= max_w
    n_chunks_per_row = -(-degs // max_w)  # 0 for empty rows
    has_split = bool((n_chunks_per_row > 1).any())
    chunk_row = np.repeat(np.arange(n_rows, dtype=np.int64), n_chunks_per_row)
    total_chunks = chunk_row.shape[0]
    if total_chunks == 0:
        return BinnedEll(buckets=(), shape=csr.shape, has_split_rows=False)
    row_first_chunk = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=row_first_chunk[1:])
    chunk_in_row = np.arange(total_chunks, dtype=np.int64) - np.repeat(
        row_first_chunk[:-1], n_chunks_per_row
    )
    chunk_start = indptr[chunk_row] + chunk_in_row * max_w
    chunk_len = np.minimum(max_w, degs[chunk_row] - chunk_in_row * max_w)

    # 2) each chunk goes to the smallest ladder width that fits it
    ladder_arr = np.asarray(ladder, dtype=np.int64)
    width_idx = np.searchsorted(ladder_arr, chunk_len, side="left")

    buckets = []
    real_rids = []  # per bucket: real (non-padding) row ids
    real_counts = []
    for wi, w in enumerate(ladder):
        sel = np.nonzero(width_idx == wi)[0]
        n = sel.shape[0]
        if n == 0:
            continue
        rids = chunk_row[sel]
        total = n + (-n % sublanes)
        b_cols = np.zeros((total, w), dtype=np.int32)
        b_vals = np.zeros((total, w), dtype=vals.dtype)
        dst_row, intra, src = _ell_slots(chunk_start[sel], chunk_len[sel])
        b_cols[dst_row, intra] = cols[src]
        b_vals[dst_row, intra] = vals[src]
        buckets.append(EllBucket(row_ids=_padded_rows(rids, total),
                                 cols=b_cols, vals=b_vals))
        real_rids.append(rids.astype(np.int64))
        real_counts.append(total)

    finish = _build_finish(real_rids, real_counts, n_rows)
    return BinnedEll(buckets=tuple(buckets), shape=csr.shape,
                     has_split_rows=has_split, finish=finish)


def _build_finish(real_rids, bucket_totals, n_rows: int) -> Finish:
    """pos/extras for the permutation finish (see Finish)."""
    offsets = []
    off = 0
    for total in bucket_totals:
        offsets.append(off)
        off += total
    total_rows = off
    if real_rids:
        all_rids = np.concatenate(real_rids)
        all_idx = np.concatenate(
            [o + np.arange(r.shape[0], dtype=np.int64)
             for o, r in zip(offsets, real_rids)]
        )
    else:
        all_rids = np.zeros(0, np.int64)
        all_idx = np.zeros(0, np.int64)
    order = np.argsort(all_rids, kind="stable")
    s_rids = all_rids[order]
    s_idx = all_idx[order]
    first = np.ones(s_rids.shape[0], dtype=bool)
    first[1:] = s_rids[1:] != s_rids[:-1]
    pos = np.full(n_rows, total_rows, dtype=np.int32)  # sentinel -> zeros
    pos[s_rids[first]] = s_idx[first]
    extra = ~first
    return Finish(
        pos=pos,
        extra_rids=s_rids[extra].astype(np.int32),
        extra_idx=s_idx[extra].astype(np.int32),
    )


def bin_rows_relabeled(
    csr: CSR,
    ladder="auto",
    sublanes: int = SUBLANES,
    max_buckets: int = 10,
    max_width: int = 256,
):
    """Bin a square matrix with plan-time node relabeling for a slice finish.

    Rows are renumbered so that output row order == bucket-concat order of
    each row's first chunk (empty rows last). Column indices are remapped
    through the same permutation, so the operator acts on the relabeled
    graph: inputs and outputs live in the internal (relabeled) space, and
    the finish is slicing plus concatenation; only split-row leftovers need
    a scatter.

    Returns (binned, old_from_new, new_from_old): int32 permutations with
    x_internal = x[old_from_new] and y = y_internal[new_from_old].
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(f"relabeling requires a square matrix, got {csr.shape}")
    ladder = _resolve_ladder(csr, ladder, max_buckets, max_width)
    max_w = ladder[-1]
    ladder_arr = np.asarray(ladder, dtype=np.int64)

    indptr = np.asarray(csr.indptr).astype(np.int64)
    cols = np.asarray(csr.cols).astype(np.int64)
    vals = np.asarray(csr.vals)
    degs = np.diff(indptr)

    # the permutation follows each row's first chunk width
    first_w = np.minimum(degs, max_w)  # 0 for empty rows
    first_bucket = np.searchsorted(ladder_arr, first_w, side="left")
    # sort key: (bucket of first chunk, old id); empty rows sort last
    key = np.where(degs > 0, first_bucket, len(ladder))
    old_from_new = np.argsort(key, kind="stable").astype(np.int64)
    new_from_old = np.empty(n, dtype=np.int64)
    new_from_old[old_from_new] = np.arange(n, dtype=np.int64)

    # chunk in new row order (ascending new id == bucket order)
    o_degs = degs[old_from_new]
    n_chunks_per_row = -(-o_degs // max_w)
    has_split = bool((n_chunks_per_row > 1).any())
    chunk_row = np.repeat(np.arange(n, dtype=np.int64), n_chunks_per_row)  # new ids
    total_chunks = chunk_row.shape[0]
    row_first_chunk = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=row_first_chunk[1:])
    chunk_in_row = np.arange(total_chunks, dtype=np.int64) - np.repeat(
        row_first_chunk[:-1], n_chunks_per_row
    )
    old_rows = old_from_new[chunk_row]
    chunk_start = indptr[old_rows] + chunk_in_row * max_w
    chunk_len = np.minimum(max_w, degs[old_rows] - chunk_in_row * max_w)
    width_idx = np.searchsorted(ladder_arr, chunk_len, side="left")
    is_first = chunk_in_row == 0

    buckets = []
    extras_rids = []
    extras_idx = []
    slice_counts = []
    next_first_expected = 0
    for wi, w in enumerate(ladder):
        sel_first = np.nonzero((width_idx == wi) & is_first)[0]
        sel_extra = np.nonzero((width_idx == wi) & ~is_first)[0]
        nf, ne = sel_first.shape[0], sel_extra.shape[0]
        if nf + ne == 0:
            continue
        # firsts' new row ids must be one contiguous ascending run
        rids_first = chunk_row[sel_first]
        if nf:
            if not (rids_first[0] == next_first_expected
                    and (np.diff(rids_first) == 1).all()):
                raise AssertionError("relabeled firsts not contiguous (internal invariant)")
            next_first_expected = int(rids_first[-1]) + 1
        order = np.concatenate([sel_first, sel_extra])
        total = nf + ne
        padded = total + (-total % sublanes)
        b_cols = np.zeros((padded, w), dtype=np.int32)
        b_vals = np.zeros((padded, w), dtype=vals.dtype)
        dst_row, intra, src = _ell_slots(chunk_start[order], chunk_len[order])
        b_cols[dst_row, intra] = new_from_old[cols[src]]  # relabel columns
        b_vals[dst_row, intra] = vals[src]
        buckets.append(EllBucket(row_ids=_padded_rows(chunk_row[order], padded),
                                 cols=b_cols, vals=b_vals))
        slice_counts.append(nf)
        e_order = np.argsort(chunk_row[sel_extra], kind="stable")
        extras_rids.append(chunk_row[sel_extra][e_order].astype(np.int32))
        extras_idx.append((nf + e_order).astype(np.int32))

    finish = BucketExtras(rids=tuple(extras_rids), idx=tuple(extras_idx))
    binned = BinnedEll(
        buckets=tuple(buckets),
        shape=csr.shape,
        has_split_rows=has_split,
        finish=finish,
        slice_counts=tuple(slice_counts),
    )
    return binned, old_from_new.astype(np.int32), new_from_old.astype(np.int32)
