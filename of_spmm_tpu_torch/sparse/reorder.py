"""Locality reordering: a row / column relabeling that recovers clusters.

The panel, fused and ranges engines stage the X rows each output tile
references; they are fast when those columns fall in a few contiguous id
bands, so that a tile's window covers them. Real graphs have that
structure (communities), but only if node ids are laid out
cluster-contiguously, and raw dataset ids usually are not. This pass
recovers the layout: a permutation that places each vertex next to its
neighbors, so that clusters land in contiguous id ranges.

The relabeled matrix is P A P^T; ``make_operator(reorder=...)`` plans it
and carries the permutation on the operator (``old_from_new`` /
``new_from_old``), so callers stay in node space.

Counterpart of the JAX package's ``sparse/reorder.py``: the same
permutations on the same CSR, the native matching pass
(``native.hem_order``, csrc/planner.cpp) first and the numpy matching
second.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.formats import COO, CSR


def bfs_order(csr: CSR, seed_by: str = "min_degree") -> np.ndarray:
    """Cuthill-McKee-style BFS permutation.

    Returns ``old_from_new``: position k holds the old id placed at new
    id k. Frontier expansion runs in numpy per level (O(E) in all); each
    connected component is seeded by its minimum-degree vertex, since a
    low-degree periphery first keeps each BFS shell, and so each id
    band, tight.
    """
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # seeds in degree order (argsort once; visited ones are skipped)
    if seed_by == "min_degree":
        seed_seq = np.argsort(deg, kind="stable")
    else:
        seed_seq = np.arange(n)
    seed_ptr = 0
    while pos < n:
        while seed_ptr < n and visited[seed_seq[seed_ptr]]:
            seed_ptr += 1
        if seed_ptr >= n:
            # append any stragglers
            rest = np.nonzero(~visited)[0]
            order[pos:pos + rest.shape[0]] = rest
            visited[rest] = True
            pos += rest.shape[0]
            break
        frontier = np.asarray([seed_seq[seed_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.shape[0]:
            # place this shell in degree order (the Cuthill-McKee rule)
            shell = frontier[np.argsort(deg[frontier], kind="stable")]
            order[pos:pos + shell.shape[0]] = shell
            pos += shell.shape[0]
            # expand: all neighbors of the shell at once
            starts = indptr[shell]
            lens = deg[shell]
            total = int(lens.sum())
            if total == 0:
                break
            base = np.repeat(starts - np.concatenate(
                [[0], np.cumsum(lens)[:-1]]), lens)
            nbr = cols[base + np.arange(total)]
            nbr = nbr[~visited[nbr]]
            if nbr.shape[0] == 0:
                break
            frontier = np.unique(nbr)
            visited[frontier] = True
    return order


def label_prop_order(csr: CSR, iters: int = 8, seed: int = 0) -> np.ndarray:
    """Community-recovering permutation by label propagation.

    Each round every vertex adopts the most common label among its
    neighbors (ties go to the smaller label); labels converge to
    communities in a few rounds on modular graphs. The permutation sorts
    by (final label, vertex id), so every recovered community is a
    contiguous id range. One lexsort and a segment argmax per round,
    O(E log E). ``seed`` is unused, as in the JAX package.
    """
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    labels = np.arange(n, dtype=np.int64)
    for _ in range(iters):
        lab = labels[cols]
        order = np.lexsort((lab, rows))
        r_s, l_s = rows[order], lab[order]
        # runs of equal (row, label)
        new_run = np.empty(r_s.shape[0], dtype=bool)
        if r_s.shape[0] == 0:
            break
        new_run[0] = True
        new_run[1:] = (r_s[1:] != r_s[:-1]) | (l_s[1:] != l_s[:-1])
        run_id = np.cumsum(new_run) - 1
        run_len = np.bincount(run_id)
        run_row = r_s[new_run]
        run_lab = l_s[new_run]
        # per row: the label of the longest run (lexsort put smaller
        # labels first, so the first maximal run breaks ties toward them)
        improve = np.zeros(n, dtype=np.int64)
        np.maximum.at(improve, run_row, run_len)
        is_best = run_len == improve[run_row]
        idx = np.nonzero(is_best)[0]
        rr = run_row[idx]
        keep = np.concatenate([[True], rr[1:] != rr[:-1]])
        sel = idx[keep]
        new_labels = labels.copy()
        new_labels[run_row[sel]] = run_lab[sel]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return np.lexsort((np.arange(n), labels)).astype(np.int64)


def matching_order(csr: CSR, coarse_n: int = 2048, max_levels: int = 48) -> np.ndarray:
    """Multilevel heavy-edge-matching permutation (METIS-style coarsening
    without refinement).

    Each level matches vertices with their heaviest neighbor and
    contracts the pairs; parallel edges sum, so communities coalesce into
    supernodes within a few levels. The coarsest level is ordered, and
    the ordering is expanded back down the contraction tree, so every
    community (at every scale) lands in a contiguous id range.

    Two algorithms, as in the JAX package. The native path
    (csrc/planner.cpp ``hem_order``) weighs level-0 edges by Jaccard
    common-neighbor similarity (hub-capped at degree 256), matches
    greedily, periphery first, and orders the coarsest graph by a
    heavy-edge chain. This numpy fallback matches mutually on the raw
    contracted values and orders the coarsest graph by BFS. The two give
    different permutations on the same graph.
    """
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    from of_spmm_tpu_torch import native

    nat = native.hem_order(indptr, np.asarray(csr.cols),
                           np.asarray(csr.vals, np.float32), coarse_n, max_levels)
    if nat is not None:
        return nat
    cols = np.asarray(csr.cols, dtype=np.int64)
    vals = np.asarray(csr.vals, dtype=np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    # self loops are never matchable
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    children = []  # per level: (first_child, second_child or -1)
    cur_n = n
    for _ in range(max_levels):
        if cur_n <= coarse_n or rows.shape[0] == 0:
            break
        # heaviest neighbor per vertex (ties to the smaller id); rows stay
        # sorted after contraction, so segment reductions use reduceat
        counts = np.bincount(rows, minlength=cur_n)
        ip = np.zeros(cur_n + 1, np.int64)
        np.cumsum(counts, out=ip[1:])
        nz = counts > 0
        starts = ip[:-1][nz]
        best_w = np.zeros(cur_n)
        best_w[nz] = np.maximum.reduceat(vals, starts)
        is_best = vals >= best_w[rows] - 1e-300
        h = np.full(cur_n, cur_n, dtype=np.int64)
        h[nz] = np.minimum.reduceat(np.where(is_best, cols, cur_n), starts)
        # mutual matches only
        hh = np.where(h < cur_n, h, 0)
        mutual = (h < cur_n) & (h[hh] == np.arange(cur_n)) & (np.arange(cur_n) != h)
        mate = np.where(mutual, h, np.arange(cur_n))
        # parent = min(u, mate), ids compressed
        parent = np.minimum(np.arange(cur_n), mate)
        uniq, new_of = np.unique(parent, return_inverse=True)
        nxt_n = uniq.shape[0]
        if nxt_n >= cur_n:  # no progress
            break
        c1 = uniq
        c2 = np.where(mate[uniq] != uniq, mate[uniq], -1)
        children.append((c1, c2))
        # contract the edges
        pr = new_of[parent[rows]]
        pc = new_of[parent[cols]]
        ek = pr * nxt_n + pc
        keep = pr != pc
        ek = ek[keep]
        vv = vals[keep]
        uk, inv = np.unique(ek, return_inverse=True)
        vals = np.bincount(inv, weights=vv)
        rows = uk // nxt_n
        cols = uk - rows * nxt_n
        cur_n = nxt_n

    # coarse ordering: BFS over the coarse graph keeps sibling
    # communities adjacent
    if rows.shape[0]:
        order = np.argsort(rows * cur_n + cols, kind="stable")
        counts = np.bincount(rows, minlength=cur_n)
        cp = np.zeros(cur_n + 1, np.int64)
        np.cumsum(counts, out=cp[1:])
        coarse = CSR.from_arrays(cp, cols[order].astype(np.int32),
                                 vals[order].astype(np.float32), (cur_n, cur_n))
        cur_order = bfs_order(coarse)
    else:
        cur_order = np.arange(cur_n, dtype=np.int64)

    # expand back down the contraction tree
    for c1, c2 in reversed(children):
        both = np.empty((cur_order.shape[0], 2), np.int64)
        both[:, 0] = c1[cur_order]
        both[:, 1] = c2[cur_order]
        flat = both.ravel()
        cur_order = flat[flat >= 0]
    return cur_order.astype(np.int64)


def reorder_locality(csr: CSR, method="lp") -> Tuple[CSR, np.ndarray, np.ndarray]:
    """(relabeled P A P^T, old_from_new, new_from_old).

    Square matrices only: rows and columns are the same vertex set, and
    the permutation applies to both. ``method``: "match" (also "hem" and
    True), "lp" (also "bfs+lp"), "bfs" or "identity".
    """
    n, m = csr.shape
    if n != m:
        raise ValueError(f"reorder_locality needs a square adjacency, got {csr.shape}")
    if method in ("match", "hem", True):
        old_from_new = matching_order(csr)
    elif method in ("lp", "bfs+lp"):
        old_from_new = label_prop_order(csr)
    elif method == "bfs":
        old_from_new = bfs_order(csr)
    elif method == "identity":
        old_from_new = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown reorder method {method!r} (want match|lp|bfs|identity)")
    new_from_old = np.empty(n, dtype=np.int64)
    new_from_old[old_from_new] = np.arange(n, dtype=np.int64)

    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    vals = np.asarray(csr.vals, dtype=np.float32)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    relabeled = CSR.from_coo(COO.from_arrays(
        new_from_old[rows].astype(np.int32), new_from_old[cols].astype(np.int32),
        vals, csr.shape))
    return relabeled, old_from_new, new_from_old


def locality_stats(csr: CSR, R: int = 128, window: int = 12288) -> dict:
    """How much of each R-row tile's column mass the densest
    ``window``-row band captures (``band_coverage``, 0 to 1).

    A plan-free proxy for the ranges plan's quality (sparse/ranges.py
    picks the same windows), to measure a reordering without building a
    plan."""
    from of_spmm_tpu_torch.sparse.ranges import _best_window

    n, m = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.cols, dtype=np.int64)
    n_tiles = max(-(-n // R), 1)
    covered = 0
    total = 0
    w = min(window, m)
    for t in range(n_tiles):
        lo, hi = indptr[t * R], indptr[min((t + 1) * R, n)]
        c = np.sort(cols[lo:hi])
        u, cnt = np.unique(c, return_counts=True)
        _, mass = _best_window(u, cnt, m, w)
        covered += mass
        total += c.shape[0]
    return {"tiles": n_tiles, "window": w, "band_coverage": covered / max(total, 1)}
