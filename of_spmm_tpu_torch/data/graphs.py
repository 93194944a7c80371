"""Graph workloads: named configs and seeded synthetic generators.

Each named config is served by a synthetic generator that reproduces the
dataset's node count, edge count and degree-distribution shape (power-law
skew where the real graph is skewed); if the real edge list exists on
disk (``OFS_DATA_DIR``), it is loaded instead.

The generators draw from numpy in the same order as the JAX package's
``of_spmm_tpu.data.graphs``, so one seed gives the same edges in both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from of_spmm_tpu_torch.sparse.formats import COO, CSR


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    name: str
    n_nodes: int
    n_edges: int  # directed edge count (nnz of adjacency)
    power_law: bool  # heavy-tailed degree distribution
    feature_dim: int = 128
    n_classes: int = 16


# Node and edge counts of the public datasets.
NAMED_CONFIGS = {
    "cora": GraphConfig("cora", 2_708, 10_556, power_law=False, n_classes=7),
    "citeseer": GraphConfig("citeseer", 3_327, 9_104, power_law=False, n_classes=6),
    "ogbn-arxiv": GraphConfig("ogbn-arxiv", 169_343, 1_166_243, power_law=True, n_classes=40),
    "reddit": GraphConfig("reddit", 232_965, 114_615_892, power_law=True, n_classes=41),
    "ogbn-products": GraphConfig(
        "ogbn-products", 2_449_029, 123_718_280, power_law=True, n_classes=47
    ),
    # scaled-down stand-ins for fast iteration
    "reddit-small": GraphConfig("reddit-small", 23_296, 1_146_158, power_law=True, n_classes=41),
    "products-small": GraphConfig(
        "products-small", 244_902, 12_371_828, power_law=True, n_classes=47
    ),
}


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
    # round stochastically to integers summing ~e, min degree 1
    deg_int = np.floor(deg).astype(np.int64)
    frac = deg - deg_int
    deg_int += (rng.random(n) < frac).astype(np.int64)
    deg_int = np.maximum(deg_int, 1)
    # trim/pad to exactly e by adjusting the light tail
    diff = int(deg_int.sum() - e)
    if diff > 0:
        adjustable = np.nonzero(deg_int > 1)[0]
        take = rng.choice(adjustable, size=min(diff, adjustable.size), replace=False)
        deg_int[take] -= 1
    elif diff < 0:
        take = rng.choice(n, size=-diff, replace=True)
        np.add.at(deg_int, take, 1)
    return deg_int


def synthetic_edges(cfg: GraphConfig, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edge list (src, dst) matching cfg's size and skew.

    Power-law graphs: a configuration model over a Zipf–Mandelbrot
    in-degree sequence, with power-law-sized communities on contiguous id
    ranges; 75% of each node's edges stay inside its community, most of
    the rest land a power-law distance away in community-id space, and a
    15% tail is global. Uniform graphs are Erdos–Renyi. Self loops and
    duplicates are removed and topped up to the exact edge count.
    """
    rng = np.random.default_rng(seed)
    n, e = cfg.n_nodes, cfg.n_edges
    if not cfg.power_law:
        src = rng.integers(0, n, size=int(e * 1.05), dtype=np.int64)
        dst = rng.integers(0, n, size=int(e * 1.05), dtype=np.int64)
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        idx = np.sort(idx)[:e]  # tiny graphs may keep slightly fewer
        return src[idx], dst[idx]

    dmax = max(64, min(n // 8, int(8 * e / max(np.sqrt(n), 1))))
    deg = _powerlaw_degrees(n, e, dmax, rng)  # in-degree per node
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)

    # communities: power-law sizes, contiguous id ranges
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
    # intra-community: uniform within the dst's community
    src[intra] = comm_lo[dst[intra]] + rng.integers(
        0, 1 << 62, size=int(intra.sum())
    ) % comm_sz[dst[intra]]
    # inter-community: the target community sits a power-law distance away
    # in community-id space; a small global tail is degree-biased
    inter_idx = np.nonzero(~intra)[0]
    n_inter = inter_idx.shape[0]
    far = rng.random(n_inter) < 0.15  # global tail
    near = inter_idx[~far]
    dist = rng.zipf(1.7, size=near.shape[0]).astype(np.int64)
    sign = rng.integers(0, 2, size=near.shape[0]) * 2 - 1
    tgt_comm = (comm_of[dst[near]] + sign * dist) % n_comm
    t_lo = bounds[tgt_comm]
    t_sz = np.maximum(bounds[tgt_comm + 1] - t_lo, 1)
    src[near] = t_lo + rng.integers(0, 1 << 62, size=near.shape[0]) % t_sz
    far_idx = inter_idx[far]
    src[far_idx] = dst[rng.integers(0, m, size=far_idx.shape[0])]

    # drop self loops and duplicates; top up with uniform edges if short
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


def load_graph(name: str, seed: int = 0, symmetrize: bool = False) -> Tuple[CSR, GraphConfig]:
    """Adjacency CSR for a named config (disk if present, else synthetic).

    On-disk format (``$OFS_DATA_DIR/<name>/edges.npy``): int64 array
    (2, E) of (src, dst) pairs. ``symmetrize`` adds reverse edges
    (A := A union A^T), the standard GCN preprocessing; it also makes the
    normalized adjacency symmetric, so the transpose plan aliases the
    forward plan.
    """
    if name not in NAMED_CONFIGS:
        raise KeyError(
            f"unknown graph {name!r}; available: {sorted(NAMED_CONFIGS)}"
        )
    cfg = NAMED_CONFIGS[name]
    data_dir = os.environ.get("OFS_DATA_DIR", "")
    path = os.path.join(data_dir, name, "edges.npy") if data_dir else ""

    def build() -> CSR:
        if path and os.path.exists(path):
            edges = np.load(path)
            src, dst = edges[0], edges[1]
        else:
            # published edge counts already count both directions: generate
            # half and let symmetrization restore the advertised nnz (up to
            # reciprocal-edge overlap)
            gen_cfg = cfg
            if symmetrize:
                gen_cfg = dataclasses.replace(cfg, n_edges=cfg.n_edges // 2)
            src, dst = synthetic_edges(gen_cfg, seed=seed)
        if symmetrize:
            from of_spmm_tpu_torch import native

            src, dst = native.symmetrize_dedup(src, dst, cfg.n_nodes)
        return CSR.from_coo(COO.from_edges(src, dst, cfg.n_nodes))

    if cfg.n_edges >= 10_000_000:  # big graphs: cache the built CSR on disk
        from of_spmm_tpu_torch.data.cache import cached

        return cached("csr", f"{name}|seed{seed}|sym{int(symmetrize)}|v3", build), cfg
    return build(), cfg


def random_features(
    cfg: GraphConfig, seed: int = 0, dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """(features (n, d), labels (n,)) for a config, as numpy arrays."""
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((cfg.n_nodes, cfg.feature_dim)).astype(dtype)
    y = rng.integers(0, cfg.n_classes, size=cfg.n_nodes).astype(np.int32)
    return x, y
