"""The benchmark's graphs: a frozen copy of the synthetic generator, and a
cache of each generated graph inside the checkout.

The generator is a copy of ``of_spmm_tpu_torch/data/graphs.py``
(``_powerlaw_degrees``, and ``synthetic_edges``' power-law branch) as it
stood when the benchmark was defined, so that a change to the program
cannot change the benchmark's data. A configuration's ``graph`` block
names the node count, the number of directed edges to draw and the seed;
the pattern is the union of the drawn edges with their transpose
(duplicates removed), as OGB's ``to_symmetric`` makes it.

The graph is an adjacency pattern in CSR form: ``indptr`` (int64) and
``cols`` (int32, ascending in each row). Values are implicit ones.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Tuple

import numpy as np

# bump when the generator or the stored form changes
GENERATOR_VERSION = 2
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache", "graphs")


def _powerlaw_degrees(n: int, e: int, dmax: int, rng) -> np.ndarray:
    """Degree sequence deg_i ∝ (i + q)^-s truncated at dmax, scaled by
    bisection so sum == e (Zipf–Mandelbrot)."""
    i = np.arange(n, dtype=np.float64)
    s, q = 0.85, max(n * 1e-4, 10.0)
    base = (i + q) ** -s
    lo, hi = 1.0, 1e18
    for _ in range(80):
        mid = np.sqrt(lo * hi)
        tot = np.minimum(base * mid, dmax).sum()
        if tot < e:
            lo = mid
        else:
            hi = mid
    deg = np.minimum(base * lo, dmax)
    deg_int = np.floor(deg).astype(np.int64)
    frac = deg - deg_int
    deg_int += (rng.random(n) < frac).astype(np.int64)
    deg_int = np.maximum(deg_int, 1)
    diff = int(deg_int.sum() - e)
    if diff > 0:
        adjustable = np.nonzero(deg_int > 1)[0]
        take = rng.choice(adjustable, size=min(diff, adjustable.size), replace=False)
        deg_int[take] -= 1
    elif diff < 0:
        take = rng.choice(n, size=-diff, replace=True)
        np.add.at(deg_int, take, 1)
    return deg_int


def synthetic_edges(n: int, e: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edge list (src, dst) of ``e`` edges over ``n`` nodes.

    A configuration model over a Zipf–Mandelbrot in-degree sequence, with
    power-law-sized communities on contiguous id ranges; 75% of each
    node's edges stay inside its community, most of the rest land a
    power-law distance away in community-id space, and a 15% tail is
    global. Self loops and duplicates are removed and topped up to the
    exact edge count.
    """
    rng = np.random.default_rng(seed)
    dmax = max(64, min(n // 8, int(8 * e / max(np.sqrt(n), 1))))
    deg = _powerlaw_degrees(n, e, dmax, rng)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)

    intra_frac = 0.75
    avg_comm = max(int(np.sqrt(n)), 64)
    n_comm = max(n // avg_comm, 1)
    sizes = _powerlaw_degrees(n_comm, n, max(4 * avg_comm, 256), rng)
    bounds = np.zeros(n_comm + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    bounds = np.minimum(bounds, n)
    bounds[-1] = n
    comm_of = np.searchsorted(bounds, np.arange(n), side="right") - 1
    comm_lo = bounds[comm_of]
    comm_sz = np.maximum(bounds[comm_of + 1] - comm_lo, 1)

    m = dst.shape[0]
    intra = rng.random(m) < intra_frac
    src = np.empty(m, dtype=np.int64)
    src[intra] = comm_lo[dst[intra]] + rng.integers(
        0, 1 << 62, size=int(intra.sum())
    ) % comm_sz[dst[intra]]
    inter_idx = np.nonzero(~intra)[0]
    n_inter = inter_idx.shape[0]
    far = rng.random(n_inter) < 0.15
    near = inter_idx[~far]
    dist = rng.zipf(1.7, size=near.shape[0]).astype(np.int64)
    sign = rng.integers(0, 2, size=near.shape[0]) * 2 - 1
    tgt_comm = (comm_of[dst[near]] + sign * dist) % n_comm
    t_lo = bounds[tgt_comm]
    t_sz = np.maximum(bounds[tgt_comm + 1] - t_lo, 1)
    src[near] = t_lo + rng.integers(0, 1 << 62, size=near.shape[0]) % t_sz
    far_idx = inter_idx[far]
    src[far_idx] = dst[rng.integers(0, m, size=far_idx.shape[0])]

    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    src, dst = src[idx], dst[idx]
    short = e - src.shape[0]
    while short > 0:
        s2 = rng.integers(0, n, size=int(short * 1.5) + 16, dtype=np.int64)
        d2 = rng.integers(0, n, size=s2.shape[0], dtype=np.int64)
        ok = s2 != d2
        s2, d2 = s2[ok], d2[ok]
        src = np.concatenate([src, s2])
        dst = np.concatenate([dst, d2])
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
        short = e - src.shape[0]
    order = rng.permutation(src.shape[0])[:e]
    return src[order], dst[order]


def edges_to_csr(src: np.ndarray, dst: np.ndarray, n: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The symmetric pattern of the edges and their transpose: A[dst, src]
    = A[src, dst] = 1; duplicates removed, columns ascending."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    key = np.unique(np.concatenate([dst * n + src, src * n + dst]))
    rows = key // n
    cols = (key - rows * n).astype(np.int32)
    del key
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols


def graph_key(graph: dict) -> str:
    blob = json.dumps({"graph": graph, "version": GENERATOR_VERSION}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_graph(graph: dict) -> Tuple[np.ndarray, np.ndarray]:
    n = int(graph["nodes"])
    src, dst = synthetic_edges(n, int(graph["edges"]), int(graph["seed"]))
    return edges_to_csr(src, dst, n)


def load_graph(name: str, graph: dict) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(indptr, cols, hit) of a configuration's graph: read from
    ``CACHE_DIR`` when it was built before in this checkout, else built
    and written there (a directory made under a temporary name, then
    renamed into place)."""
    path = os.path.join(CACHE_DIR, f"{name}-{graph_key(graph)}")
    try:
        return (np.load(os.path.join(path, "indptr.npy")),
                np.load(os.path.join(path, "cols.npy")), True)
    except (OSError, ValueError):
        pass
    indptr, cols = build_graph(graph)
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "indptr.npy"), indptr)
    np.save(os.path.join(tmp, "cols.npy"), cols)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return indptr, cols, False
