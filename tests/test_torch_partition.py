"""The port's row partition against the JAX package's, on the CPU.

``partition_rows`` must give the JAX package's plan array for array (every
bucket stack, send list, hub index, ragged offset list, pack map and panel
stack, padded the same way) on the same seeded matrices: S = 2, 4, 8,
uniform and refined cuts, K = 0, 8 and "auto", padded and ragged halos,
split plans, the binned and panels engines (shards with unequal step
counts among them), with and without the transpose. Also ``comm_stats``,
the fingerprint, and the ValueErrors the JAX package raises.
"""

import dataclasses

import numpy as np
import pytest

from of_spmm_tpu.parallel import partition_rows as jpartition_rows
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch.parallel import partition_rows, plan_fingerprint
from of_spmm_tpu_torch.parallel.partition import PANEL_LEAVES
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.panels import _expand_masks_np, compact_masks


def _normalized(n, density, seed, m=None):
    """Sym-normalized binary adjacency (rank-1 values: the panel engine)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, m or n)) < density).astype(np.float32)
    dr, dc = dense.sum(1), dense.sum(0)
    with np.errstate(divide="ignore"):
        r = np.where(dr > 0, dr ** -0.5, 0.0).astype(np.float32)
        c = np.where(dc > 0, dc ** -0.5, 0.0).astype(np.float32)
    return dense * r[:, None] * c[None, :]


def _blocky(n, seed):
    """SBM with irregular blocks smaller than a shard, real values: uniform
    cuts straddle blocks, so refinement has edges to snap to."""
    rng = np.random.default_rng(seed)
    bounds = np.concatenate([[0], np.cumsum(rng.integers(8, 41, n))])
    bounds = np.concatenate([bounds[bounds < n], [n]])
    comm = np.searchsorted(bounds, np.arange(n), side="right") - 1
    dense = (rng.random((n, n)) < 0.004).astype(np.float32)
    same = comm[:, None] == comm[None, :]
    dense[same] = (rng.random(int(same.sum())) < 0.3).astype(np.float32)
    return (dense * rng.standard_normal((n, n))).astype(np.float32)


def _hubby(n, seed):
    """Sparse random values plus a dozen dense columns spread over the shards."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < 0.008).astype(np.float32)
    hubs = np.arange(0, n, n // 12)[:12]
    dense[:, hubs] = (rng.random((n, 12)) < 0.5).astype(np.float32)
    return (dense * rng.random((n, n))).astype(np.float32)


def _wide(n, seed=0):
    """Rank-1 values on a band, and the first 128 rows touching about 48
    columns each all over the matrix: at 640 rows a shard, shard 0's panel
    plan takes more steps than shard 1's, so the stack pads."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for o in (-1, 0, 1):
        d[i, (i + o) % n] = 1
    d[:128][rng.random((128, n)) < 48 / n] = 1
    r, c = d.sum(1) ** -0.5, d.sum(0) ** -0.5
    return (d * r[:, None] * c[None, :]).astype(np.float32)


MATRICES = {
    "normalized": lambda S: _normalized(64 * S + 5, 0.06, S),
    "blocky": lambda S: _blocky(64 * S, 17 + S),
    "hubby": lambda S: _hubby(64 * S, S),
    "rect": lambda S: _normalized(48 * S + 3, 0.08, S, m=64 * S + 9),
    "wide": lambda S: _wide(640 * S, S),
}

# (matrix, S, options)
CASES = [
    ("normalized", 2, {}),
    ("normalized", 4, {}),
    ("normalized", 8, {}),
    ("rect", 4, {}),
    ("blocky", 4, dict(refine_slack=0.2)),
    ("blocky", 8, dict(ragged=True, refine_slack=0.2)),
    ("blocky", 2, dict(ragged=True)),
    ("blocky", 8, dict(ragged=True, with_transpose=False)),
    ("hubby", 4, dict(replicate_hubs=8)),
    ("hubby", 4, dict(ragged=True, replicate_hubs=8)),
    ("hubby", 8, dict(replicate_hubs="auto")),
    ("blocky", 8, dict(ragged=True, refine_slack=0.2, replicate_hubs="auto")),
    ("normalized", 4, dict(split_boundary=True)),
    ("blocky", 4, dict(split_boundary=True, ragged=True, refine_slack=0.2)),
    ("hubby", 4, dict(split_boundary=True, replicate_hubs="auto")),
    ("normalized", 2, dict(local_engine="panels")),
    ("normalized", 4, dict(local_engine="panels", ragged=True)),
    ("normalized", 8, dict(local_engine="panels")),
    ("rect", 2, dict(local_engine="panels")),
    ("wide", 2, dict(local_engine="panels")),
    ("normalized", 4, dict(local_engine="panels", split_boundary=True, ragged=True,
                           replicate_hubs=8)),
    ("normalized", 8, dict(local_engine="panels", split_boundary=True, replicate_hubs="auto")),
    ("normalized", 4, dict(local_engine="panels", with_transpose=False)),
]


def _ids(case):
    name, S, kw = case
    return f"{name}-S{S}-" + "-".join(f"{k}={v}" for k, v in kw.items())


def _both(name, S, **kw):
    dense = MATRICES[name](S)
    return (partition_rows(CSR.from_dense(dense), S, **kw),
            jpartition_rows(JCSR.from_dense(dense), S, **kw))


def _assert_same(got, want, path="plan"):
    """Field by field, leaf by leaf: arrays equal in shape, dtype and value."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif want is None or isinstance(want, (bool, int, float, str)):
        assert got == want, (path, got, want)
    else:
        assert isinstance(got, np.ndarray), (path, type(got))
        w = np.asarray(want)
        assert got.shape == w.shape and got.dtype == w.dtype, (path, got.shape, w.shape,
                                                               got.dtype, w.dtype)
        np.testing.assert_array_equal(got, w, err_msg=path)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plan_equals_jax(case):
    name, S, kw = case
    got, want = _both(name, S, **kw)
    _assert_same(got, want)
    assert (got.split, got.ragged, got.n_hubs, got.halo_rows_total) == (
        want.split, want.ragged, want.n_hubs, want.halo_rows_total)
    assert got.halo_fraction == want.halo_fraction
    assert sum(got.shard_rows(p) for p in range(S)) == got.shape[0]


def test_stacked_panels_pad_unequal_steps():
    """The wide case's shards differ in step count: the stack appends
    no-op steps to the shorter one (tile -1, nothing staged, no mask bits,
    tile_of the last tile), as the JAX package's does."""
    got, _ = _both("wide", 2, local_engine="panels")
    aux = got.panel_aux[0]
    ctrl, masks, tile_of = (got.panel_fwd[PANEL_LEAVES.index(k)]
                            for k in ("ctrl", "masks", "tile_of"))
    G = aux["T"] // 128
    live = [np.nonzero(ctrl[p, :, 0, 0] >= 0)[0].max() + 1 for p in range(2)]
    assert live[0] == aux["n_steps"] > live[1]
    tail = slice(live[1], aux["n_steps"])
    assert (ctrl[1, tail, 0, 0] == -1).all() and not ctrl[1, tail, 0, 1:].any()
    assert (tile_of[1, tail] == aux["n_tiles"] - 1).all()
    assert not masks[1, live[1] * G:].any()


def test_compact_masks_inverts_the_expansion():
    """Each shard's stacked dense masks (pad steps included) back to
    compact edges, one per mask bit, and expanded again unchanged."""
    got, _ = _both("wide", 2, local_engine="panels")
    for stack in (got.panel_fwd, got.panel_bwd):
        for masks in stack[PANEL_LEAVES.index("masks")]:
            edges, counts = compact_masks(masks)
            bits = np.unpackbits(masks.view(np.uint8)).sum()
            assert edges.shape == (bits,) and counts.sum() == bits
            np.testing.assert_array_equal(_expand_masks_np(edges, counts), masks)


@pytest.mark.parametrize("case", [CASES[1], CASES[5], CASES[9], CASES[10], CASES[20]],
                         ids=lambda c: _ids(c))
@pytest.mark.parametrize("d,bytes_per", [(128, 4), (7, 2)])
def test_comm_stats_match_jax(case, d, bytes_per):
    name, S, kw = case
    got, want = _both(name, S, with_transpose=False, **kw)
    assert got.comm_stats(d, bytes_per) == want.comm_stats(d, bytes_per)


def test_hubs_and_ragged_shrink_the_exchange():
    """Hubs cut the padded halo on a hub-heavy graph; ragged and refined
    halos each beat the one before on a clustered graph (the JAX
    package's invariants, on the port's plans)."""
    csr = CSR.from_dense(_hubby(256, 11))
    plain = partition_rows(csr, 4, with_transpose=False)
    hubby = partition_rows(csr, 4, with_transpose=False, replicate_hubs=12)
    s_p, s_h = plain.comm_stats(), hubby.comm_stats()
    assert hubby.halo_size < plain.halo_size
    assert s_h["halo_bytes"] + s_h["hub_bytes"] < s_p["halo_bytes"]
    csr = CSR.from_dense(_blocky(512, 17))
    uni, rag, ref = (partition_rows(csr, 8, with_transpose=False, **kw).comm_stats()
                     for kw in ({}, dict(ragged=True), dict(ragged=True, refine_slack=0.2)))
    assert ref["halo_bytes"] < rag["halo_bytes"] < uni["halo_bytes"]


def test_fingerprint_stable_and_shape_sensitive():
    csr = CSR.from_dense(_normalized(261, 0.06, 4))
    a = partition_rows(csr, 4, ragged=True, local_engine="panels")
    b = partition_rows(csr, 4, ragged=True, local_engine="panels")
    assert plan_fingerprint(a) == plan_fingerprint(b)
    assert len(plan_fingerprint(a)) == 64
    bigger = partition_rows(CSR.from_dense(_normalized(269, 0.06, 4)), 4, ragged=True,
                            local_engine="panels")
    assert plan_fingerprint(bigger) != plan_fingerprint(a)
    assert plan_fingerprint(partition_rows(csr, 4, ragged=True)) != plan_fingerprint(a)
    assert plan_fingerprint(partition_rows(csr, 2, ragged=True, local_engine="panels")) \
        != plan_fingerprint(a)


@pytest.mark.parametrize("what,kw,match", [
    ("engine", dict(local_engine="ell"), "local_engine"),
    ("ladder", dict(ladder="optimal"), "ladder"),
    ("panels_not_rank1", dict(local_engine="panels"), "rank-1"),
    ("split_binned_hubs", dict(split_boundary=True, replicate_hubs=16), "hub"),
    ("refine_rectangular", dict(refine_slack=0.2), "square"),
])
def test_value_errors_as_jax(what, kw, match):
    dense = (_hubby(128, 3) if what != "refine_rectangular"
             else _normalized(96, 0.1, 3, m=128))
    if what == "panels_not_rank1":
        dense = dense * np.random.default_rng(5).random(dense.shape).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        jpartition_rows(JCSR.from_dense(dense), 4, **kw)
    with pytest.raises(ValueError, match=match):
        partition_rows(CSR.from_dense(dense), 4, **kw)
