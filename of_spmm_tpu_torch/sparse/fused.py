"""Plan helpers shared by the staging engines.

The JAX package's sparse/fused.py builds the fused engine's plan around
these; the port has only the helpers the panel plan imports
(sparse/panels.py) until the fused engine is ported: the hot-column
choice, duplicate coalescing, rank-1 detection and the device-memory
budget.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from of_spmm_tpu_torch.sparse.formats import CSR

_L = 128
DEFAULT_T = 1024         # lanes per step (G = T/128 groups)
_BIG_T_NNZ = 8_000_000   # graphs at or above this nnz take the big-T default

# The plan-time memory budget: a plan must fit _BUDGET_FRACTION of the
# device's memory.
_H100_HBM = 80 * 10**9   # NVIDIA H100 SXM5: 80 GB HBM3
_BUDGET_FRACTION = 0.80


def device_hbm_bytes(device=None) -> int:
    """Device memory bytes for the plan budget: OFS_HBM_BYTES when set,
    else the card's total memory, else (a host without a card, building
    a plan for one) the H100's 80 GB."""
    from of_spmm_tpu_torch.utils.config import FLAGS

    flag = int(FLAGS.get("OFS_HBM_BYTES"))
    if flag:
        return flag
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        if dev.type == "cuda":
            return int(torch.cuda.get_device_properties(dev).total_memory)
    return _H100_HBM


def _nbytes(a) -> int:
    return 0 if a is None else int(np.asarray(a).size) * a.dtype.itemsize


def choose_hot(csr: CSR, R: int, hot_budget: int, min_run: int,
               touch: Optional[np.ndarray] = None) -> np.ndarray:
    """Pick hot columns: sort by tile-touch count, keep 128-blocks while the
    average lanes-per-tile-per-block stays >= min_run.

    Returns global col ids, sorted. The tile-touch count (how many R-row
    tiles reference the column) is what the column would otherwise cost in
    staged rows; pass it precomputed (a bincount of the native pass-1
    per-tile unique lists) to skip the unique over every (tile, col) key.
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    n_tiles = max(-(-n // R), 1)
    if touch is None:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        tiles = rows // R
        key = tiles * m + cols
        uniq_key = np.unique(key)
        touch = np.bincount((uniq_key % m).astype(np.int64), minlength=m)
    # in-reference count per column (lanes a hot block would serve)
    refs = np.bincount(cols, minlength=m)
    order = np.argsort(-touch, kind="stable")
    max_hot = min(hot_budget, m) // _L * _L
    if max_hot == 0:
        return np.zeros(0, np.int64)
    cand = order[:max_hot]
    keep = 0
    for b in range(max_hot // _L):
        blk_refs = refs[cand[b * _L:(b + 1) * _L]].sum()
        if blk_refs / n_tiles < min_run:
            break
        keep = b + 1
    # sorted by node id: on community-contiguous orderings hubs of one
    # community then share a hot 128-block
    return np.sort(cand[: keep * _L])


def coalesce_duplicates(csr: CSR) -> CSR:
    """Merge duplicate (row, col) entries by summing values (a mask bit has
    no multiplicity)."""
    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols_all = np.asarray(csr.cols, dtype=np.int64)
    vals_all = np.asarray(csr.vals, dtype=np.float32)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    key = rows_all * m + cols_all
    if key.shape[0] and bool(np.all(key[1:] >= key[:-1])):
        vals_s, ks = vals_all, key  # row-sorted cols: no sort needed
    elif key.shape[0]:
        order = np.argsort(key, kind="stable")
        ks = key[order]
        vals_s = vals_all[order]
    else:
        vals_s, ks = vals_all, key
    if not (ks.shape[0] and int((ks[1:] == ks[:-1]).sum())):
        return csr
    keep = np.concatenate([[True], ks[1:] != ks[:-1]])
    seg_id = np.cumsum(keep) - 1
    vals_c = np.zeros(int(seg_id[-1]) + 1, np.float32)
    np.add.at(vals_c, seg_id, vals_s)
    ku = ks[keep]
    rows_u = ku // m
    cols_u = ku - rows_u * m
    indptr2 = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows_u, minlength=n), out=indptr2[1:])
    return CSR(indptr=indptr2, cols=cols_u.astype(np.int32),
               vals=vals_c, shape=csr.shape)


def factor_rank1(csr: CSR, rtol: float = 1e-6):
    """vals[e] = r[row[e]] * c[col[e]] detection (sparse/expansion2.py)."""
    from of_spmm_tpu_torch.sparse.expansion2 import factor_rank1 as _f

    return _f(csr, rtol=rtol)
