"""Range-window helpers the panel plan uses (the JAX package's
sparse/ranges.py builds the ranges engine around them; that engine waits
for a later slice)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.fused import _L

RMAX_CAP = 16  # range chunk copies per step


def _best_window(cold_cols: np.ndarray, counts: np.ndarray, m: int,
                 rc: int) -> Tuple[int, int]:
    """(lo, mass) of the densest rc-row window over weighted cold cols.

    Sparse two-pointer over the sorted distinct cols, O(k) per tile."""
    if cold_cols.shape[0] == 0:
        return 0, 0
    pref = np.zeros(cold_cols.shape[0] + 1, np.int64)
    np.cumsum(counts, out=pref[1:])
    # a window starting at col c covers cols in [c, c+rc); the densest
    # window starts at a distinct col
    hi = np.searchsorted(cold_cols, cold_cols + rc, side="left")
    mass = pref[hi] - pref[np.arange(cold_cols.shape[0])]
    j = int(np.argmax(mass))
    lo = int(cold_cols[j])
    # snap to 128 and clamp so [lo, lo+rc) stays in [0, m)
    lo = min(max(lo // _L * _L, 0), max((m - rc) // _L * _L, 0))
    # the mass of the snapped window
    a = np.searchsorted(cold_cols, lo, side="left")
    b = np.searchsorted(cold_cols, lo + rc, side="left")
    return lo, int(pref[b] - pref[a])
