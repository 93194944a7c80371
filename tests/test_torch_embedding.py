"""The port's embedding path against the JAX package's: the tiered store
(``embedding/one_embedding.py``: PersistentTable, CachedEmbedding,
MultiTableEmbedding), ``models.Embedding`` and ``models.ShardedEmbedding``.

The host state is held exactly: the table's files byte for byte (and each
package opens the other's), the cache's slots and meta step for step,
LRU ties included, and the errors' texts. Float state (the cache, the
flushed rows, losses, lookups and grads) at rtol 1e-4 / atol 1e-5. JAX
calls that take arrays are jitted (an eager ``shard_map`` takes seconds).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from of_spmm_tpu.embedding import CachedEmbedding as JCached
from of_spmm_tpu.embedding import MultiTableEmbedding as JMulti
from of_spmm_tpu.embedding import PersistentTable as JTable
from of_spmm_tpu.models.embedding import Embedding as JEmbedding
from of_spmm_tpu.models.sharded_embedding import ShardedEmbedding as JSharded
from of_spmm_tpu_torch import parallel as par
from of_spmm_tpu_torch.embedding import CachedEmbedding, MultiTableEmbedding, PersistentTable
from of_spmm_tpu_torch.interop import (
    cached_embedding_state_from_numpy, embedding_params_from_numpy,
    sharded_embedding_params_from_numpy)
from of_spmm_tpu_torch.models import Embedding, ShardedEmbedding
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k] == fb[k], k


def _same_meta(got, want):
    for k in ("slot_ids", "last_used", "dirty"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.clock == want.clock and got.index == want.index


def _tables(tmp_path, dim, capacity, **kw):
    return (PersistentTable(str(tmp_path / "p"), dim, capacity, **kw),
            JTable(str(tmp_path / "j"), dim, capacity, **kw))


# -- PersistentTable -------------------------------------------------------------

TABLE_OPS = [("get", [5, 9, 5, 2]), ("put", [9, 40, 41, 40]), ("get", [41, 7, 2, 8, 7]),
             ("put", [5]), ("get", [])]


@pytest.mark.parametrize("initializer", ["normal", "zeros"])
def test_persistent_table_files_byte_equal_and_cross_open(tmp_path, initializer):
    tables = _tables(tmp_path, 6, 32, initializer=initializer, seed=4)
    rng = np.random.default_rng(0)
    for op, ids in TABLE_OPS:
        ids = np.asarray(ids, np.int64)
        if op == "get":
            got, want = (t.get(ids) for t in tables)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        else:
            rows = rng.standard_normal((len(ids), 6)).astype(np.float32)
            for t in tables:
                t.put(ids, rows)
        assert tables[0].n_rows == tables[1].n_rows
    for t in tables:
        assert t.save_snapshot("s1").endswith("s1")
    _same_files(tmp_path / "p", tmp_path / "j")
    # each package opens the other's table and reads the same rows
    ids = np.asarray([2, 5, 7, 8, 9, 40, 41], np.int64)
    want = tables[1].get(ids)
    np.testing.assert_array_equal(PersistentTable(str(tmp_path / "j"), 6).get(ids), want)
    np.testing.assert_array_equal(JTable(str(tmp_path / "p"), 6).get(ids), want)
    for cls in (PersistentTable, JTable):
        with pytest.raises(ValueError, match=r"has dim 6, want 3"):
            cls(str(tmp_path / "p"), 3)


def test_persistent_table_snapshot_round_trip(tmp_path):
    tables = _tables(tmp_path, 3, 16, seed=1)
    for t in tables:
        t.get(np.arange(5))
        t.save_snapshot("a")
        t.put(np.asarray([1, 12]), np.full((2, 3), 9.0, np.float32))
        t.load_snapshot("a")
    for t in tables:
        assert t.n_rows == 5
    np.testing.assert_array_equal(tables[0].get(np.arange(6)), tables[1].get(np.arange(6)))
    _same_files(tmp_path / "p", tmp_path / "j")


@pytest.mark.parametrize("op", ["get", "put"])
def test_persistent_table_full_errors_and_state_match_jax(tmp_path, op):
    tables = _tables(tmp_path, 2, 4, seed=2)
    ids = np.asarray([1, 2, 1, 3, 4, 5, 6], np.int64)
    rows = np.arange(14, dtype=np.float32).reshape(7, 2)
    msgs = []
    for t in tables:
        with pytest.raises(RuntimeError, match="full") as err:
            t.get(ids) if op == "get" else t.put(ids, rows)
        msgs.append(str(err.value))
        t.save_snapshot()
    assert msgs[0].replace(str(tmp_path / "p"), "") == msgs[1].replace(str(tmp_path / "j"), "")
    _same_files(tmp_path / "p", tmp_path / "j")


def test_reopen_without_snapshot_forgets_ids_and_redraws_rows(tmp_path):
    """The reference's quirk, kept: ids.npy is written by save_snapshot
    only, so a reopened table forgets its ids, and its generator restarts
    at ``seed``: the first id touched again gets the first row again."""
    firsts, again = [], []
    for cls, d in ((PersistentTable, "p"), (JTable, "j")):
        t = cls(str(tmp_path / d), 4, 8, seed=5)
        firsts.append(t.get(np.asarray([3, 4])))
        t2 = cls(str(tmp_path / d), 4, 8, seed=5)
        assert t2.n_rows == 0
        again.append(t2.get(np.asarray([4])))
    np.testing.assert_array_equal(firsts[0], firsts[1])
    np.testing.assert_array_equal(again[0], again[1])
    np.testing.assert_array_equal(again[0][0], firsts[0][0])  # id 4 now holds id 3's old row
    _same_files(tmp_path / "p", tmp_path / "j")


# -- CachedEmbedding ---------------------------------------------------------------

def _caches(tmp_path, dim, capacity, table_capacity=4096, **kw):
    pt, jt = _tables(tmp_path, dim, table_capacity, **kw)
    return CachedEmbedding(pt, capacity, device="cpu"), JCached(jt, capacity)


def _power_law_ids(rng, n, n_ids, a=1.05):
    u = rng.random(n)
    return (np.floor(((n_ids ** (1 - a) - 1) * u + 1) ** (1 / (1 - a))) - 1).astype(np.int64)


def _tie_sensitive(meta, uniq, need):
    """Whether the LRU victims of a prepare needing ``need`` slots differ
    between numpy's default argsort and a stable one (slots that share a
    clock tie)."""
    def victims(kind):
        order = np.argsort(meta.last_used, kind=kind)
        sid = meta.slot_ids[order]
        return set(order[(sid >= 0) & ~np.isin(sid, uniq)][:need].tolist())
    return victims(None) != victims("stable")


def test_cached_embedding_steps_match_jax_with_lru_ties(tmp_path):
    """Twelve steps of prepare / lookup / apply_grad on a 48-slot cache over
    power-law ids: slots, meta and the cache equal to JAX's every step,
    with evictions, dirty write-backs and at least one eviction whose
    victims depend on how argsort orders the tied clocks; then flush and
    the table's files."""
    emb, jemb = _caches(tmp_path, 4, 48)
    cache, meta = emb.init_cache()
    jcache, jmeta = jemb.init_cache()
    apply = jax.jit(lambda c, s, g: c.at[s].add(-0.3 * g))
    rng = np.random.default_rng(7)
    tie_steps = evicting = 0
    for step in range(12):
        ids = _power_law_ids(rng, 40, 300)
        uniq = np.unique(ids)
        need = sum(int(x) not in jmeta.index for x in uniq)
        if need > int((jmeta.slot_ids < 0).sum()):
            evicting += 1
            tie_steps += _tie_sensitive(jmeta, uniq, need - int((jmeta.slot_ids < 0).sum()))
        slots, cache = emb.prepare(ids, cache, meta)
        jslots, jcache = jemb.prepare(ids, jcache, jmeta)
        assert slots.dtype == jslots.dtype
        np.testing.assert_array_equal(slots, jslots)
        _same_meta(meta, jmeta)
        _close(emb.lookup(cache, slots), jemb.lookup(jcache, jslots))
        g = rng.standard_normal((len(ids), 4)).astype(np.float32)
        cache = emb.apply_grad(cache, slots, torch.from_numpy(g), meta, lr=0.3)
        jcache = apply(jcache, jnp.asarray(jslots), jnp.asarray(g))
        jmeta.dirty[np.unique(jslots)] = True  # what JAX apply_grad marks
        _same_meta(meta, jmeta)
        _close(cache, jcache)
    assert evicting >= 3 and tie_steps >= 1
    emb.flush(cache, meta)
    jemb.flush(jcache, jmeta)
    _same_meta(meta, jmeta)
    for t in (emb.table, jemb.table):
        t.save_snapshot()
    ids = np.arange(300)
    have = ids[[int(i) in jemb.table._index for i in ids]]
    _close(emb.table.get(have), jemb.table.get(have))


def test_cached_embedding_jax_apply_grad_is_the_port_update(tmp_path):
    """The JAX package's own apply_grad (duplicate slots) against the
    port's, from a JAX cache carried over by interop."""
    emb, jemb = _caches(tmp_path, 3, 8)
    jcache, jmeta = jemb.init_cache()
    ids = np.asarray([3, 3, 11, 42, 3])
    jslots, jcache = jemb.prepare(ids, jcache, jmeta)
    emb.table.get(np.unique(ids))  # the port's table as JAX's prepare left its own
    cache, meta = cached_embedding_state_from_numpy(np.asarray(jcache), jmeta)
    _same_meta(meta, jmeta)
    assert meta.index is not jmeta.index and meta.slot_ids is not jmeta.slot_ids
    g = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    jcache = jemb.apply_grad(jcache, jslots, jnp.asarray(g), jmeta, lr=0.5)
    cache = emb.apply_grad(cache, jslots, torch.from_numpy(g), meta, lr=0.5)
    _same_meta(meta, jmeta)
    _close(cache, jcache)
    slots, cache = emb.prepare(np.asarray([11, 5]), cache, meta)
    jslots, jcache = jemb.prepare(np.asarray([11, 5]), jcache, jmeta)
    np.testing.assert_array_equal(slots, jslots)
    _close(cache, jcache)


def test_cache_too_small_raises_as_jax(tmp_path):
    emb, jemb = _caches(tmp_path, 2, 2, table_capacity=100)
    msgs = []
    for e in (emb, jemb):
        cache, meta = e.init_cache()
        with pytest.raises(RuntimeError, match="cache too small") as err:
            e.prepare(np.arange(5), cache, meta)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_multi_table_matches_jax(tmp_path):
    specs = {"user": (2, 4), "item": (3, 4)}
    mt = MultiTableEmbedding({k: CachedEmbedding(PersistentTable(str(tmp_path / "p" / k), dim, 10),
                                                 cap, device="cpu")
                              for k, (dim, cap) in specs.items()})
    jmt = JMulti({k: JCached(JTable(str(tmp_path / "j" / k), dim, 10), cap)
                  for k, (dim, cap) in specs.items()})
    caches, jcaches = mt.init_caches(), jmt.init_caches()
    assert set(caches) == set(jcaches) == set(specs)
    for k, (dim, cap) in specs.items():
        assert tuple(caches[k][0].shape) == tuple(jcaches[k][0].shape) == (cap, dim)
        ids = np.asarray([1, 4, 1])
        s, _ = mt.tables[k].prepare(ids, *caches[k])
        js, _ = jmt.tables[k].prepare(ids, *jcaches[k])
        np.testing.assert_array_equal(s, js)
    mt.save_snapshot("s")
    jmt.save_snapshot("s")
    mt.load_snapshot("s")
    jmt.load_snapshot("s")
    _same_files(tmp_path / "p", tmp_path / "j")


def test_training_loop_losses_match_jax(tmp_path):
    """tests/test_one_embedding.py's loop (lookup, MSE, the rows' grad,
    apply_grad) in both packages: losses, cache and flushed rows."""
    emb, jemb = _caches(tmp_path, 4, 16, table_capacity=1000)
    cache, meta = emb.init_cache()
    jcache, jmeta = jemb.init_cache()
    tgt = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)

    @jax.jit
    def jstep(c, s, t):
        return jax.value_and_grad(lambda r: jnp.mean((r - t) ** 2))(jnp.take(c, s, axis=0))

    losses, jlosses = [], []
    for _ in range(8):
        ids = np.asarray([10, 20, 10])
        slots, cache = emb.prepare(ids, cache, meta)
        rows = emb.lookup(cache, slots).requires_grad_()
        loss = ((rows - torch.from_numpy(tgt)) ** 2).mean()
        loss.backward()
        cache = emb.apply_grad(cache, slots, rows.grad, meta, lr=1.0)
        losses.append(float(loss.detach()))
        jslots, jcache = jemb.prepare(ids, jcache, jmeta)
        jl, jg = jstep(jcache, jnp.asarray(jslots), jnp.asarray(tgt))
        jcache = jemb.apply_grad(jcache, jslots, jg, jmeta, lr=1.0)
        jlosses.append(float(jl))
    _close(np.asarray(losses), np.asarray(jlosses))
    assert losses[-1] < losses[0]
    _close(cache, jcache)
    emb.flush(cache, meta)
    jemb.flush(jcache, jmeta)
    _close(emb.table.get(np.asarray([10, 20])), jemb.table.get(np.asarray([10, 20])))


def test_lookup_is_differentiable_into_the_cache():
    cache = torch.zeros((4, 2), requires_grad=True)
    CachedEmbedding.lookup(cache, np.asarray([1, 1, 3], np.int32)).sum().backward()
    np.testing.assert_array_equal(cache.grad.numpy(), [[0, 0], [2, 2], [0, 0], [1, 1]])


# -- Embedding ----------------------------------------------------------------------

def test_embedding_forward_and_grads_match_jax():
    """Duplicate ids, the padding row, and ids outside [0, N) (zero rows,
    no grad), forward and the weight's grad."""
    jm = JEmbedding(10, 6, padding_idx=2)
    params = jm.init(jax.random.key(0))
    ids = np.asarray([[1, 2, 1], [9, -1, 10], [2, 3, 1]], np.int32)
    w = np.random.default_rng(0).standard_normal((3, 3, 6)).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(ids))
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(ids)) * w)))(params)
    mod = Embedding(10, 6, padding_idx=2, device="cpu")
    mod.load_state_dict(embedding_params_from_numpy(jax.tree.map(np.asarray, params)))
    got = mod(torch.from_numpy(ids))
    _close(got, want)
    assert not got[1, 1].any() and not got[1, 2].any()
    (got * torch.from_numpy(w)).sum().backward()
    _close(mod.weight.grad, jgrad["weight"])
    np.testing.assert_array_equal(Embedding(10, 6, padding_idx=2, device="cpu").weight[2]
                                  .detach().numpy(), 0.0)


# -- ShardedEmbedding ---------------------------------------------------------------

def _sharded(mesh8, n_emb, dim, ids, seed):
    """(port apply on 8 CPU shards, its params, JAX output, JAX grad of
    sum(out * w))."""
    jemb = JSharded(n_emb, dim)
    params = jemb.init(jax.random.key(seed), mesh8)
    w = np.random.default_rng(seed).standard_normal((len(ids), dim)).astype(np.float32)
    ids_j = jnp.asarray(ids, jnp.int32)
    want = jax.jit(lambda p: jemb.apply(p, ids_j, mesh8))(params)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jemb.apply(p, ids_j, mesh8) * w)))(params)
    mesh = par.ShardMesh(["cpu"] * 8)
    p = sharded_embedding_params_from_numpy({"weight": np.asarray(params["weight"])}, mesh)
    return ShardedEmbedding(n_emb, dim), p, mesh, w, np.asarray(want), np.asarray(jgrad["weight"])


SHARDED_CASES = {
    "padded": (100, 16, lambda r: r.integers(0, 100, 64)),
    "dups_and_out_of_range": (32, 4, lambda r: np.asarray([3, 3, 17, 31, 0, 3, 17, 8, -1, 1000,
                                                           -7, 5, 31, 40, 2, 3])),
}


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_embedding_forward_and_grads_match_jax(mesh8, case):
    """8 shards; ids drawn outside the padding band [N, padded_rows), where
    the JAX package returns padding rows (the divergence test below)."""
    n_emb, dim, draw = SHARDED_CASES[case]
    ids = draw(np.random.default_rng(1)).astype(np.int64)
    emb, p, mesh, w, want, jgrad = _sharded(mesh8, n_emb, dim, ids, 3)
    assert p["weight"].local.shape == (8, emb.padded_rows(8) // 8, dim)
    got = emb.apply(p, torch.from_numpy(ids), mesh)
    _close(got, want)
    (got * torch.from_numpy(w)).sum().backward()
    _close(p["weight"].local.grad.reshape(-1, dim), jgrad)


def test_sharded_embedding_padding_rows_are_zero_unlike_jax(mesh8):
    """The reference's docstring says ids >= num_embeddings return zero
    rows; with a padded table an id in [N, padded_rows) returns the last
    shard's padding row in the JAX package (and the row gets a grad). The
    port returns zeros for every id outside [0, N)."""
    mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("x",))
    jemb = JSharded(10, 3)
    params = jemb.init(jax.random.key(0), mesh4)
    assert params["weight"].shape == (12, 3)
    ids = np.asarray([10, 11, -1, 4], np.int64)
    want = np.asarray(jax.jit(lambda p: jemb.apply(p, jnp.asarray(ids, jnp.int32), mesh4))(params))
    wj = np.asarray(params["weight"])
    np.testing.assert_array_equal(want[:2], wj[10:12])  # the JAX package's padding rows
    assert np.abs(want[:2]).min() > 0
    mesh = par.ShardMesh(["cpu"] * 4)
    p = sharded_embedding_params_from_numpy({"weight": wj}, mesh)
    got = ShardedEmbedding(10, 3).apply(p, torch.from_numpy(ids), mesh)
    np.testing.assert_array_equal(got[:3].detach().numpy(), 0.0)
    _close(got[3], wj[4])
    got.sum().backward()
    assert not p["weight"].local.grad.reshape(12, 3)[10:].any()


def test_sharded_embedding_errors_match_jax(mesh8):
    jemb, emb = JSharded(16, 4), ShardedEmbedding(16, 4)
    params = jemb.init(jax.random.key(3), mesh8)
    mesh = par.ShardMesh(["cpu"] * 8)
    p = emb.init(torch.Generator().manual_seed(0), mesh)
    for ids in (np.zeros(7, np.int32), np.zeros((2, 8), np.int32)):
        with pytest.raises(ValueError) as want:
            jemb.apply(params, jnp.asarray(ids), mesh8)
        with pytest.raises(ValueError) as got:
            emb.apply(p, torch.from_numpy(ids), mesh)
        assert str(got.value) == str(want.value)


def test_sharded_embedding_init_is_s0_and_seeded():
    """init draws each shard's block on the mesh's device from a generator
    of its own (the same blocks on the shard mesh and on ranks): the
    blocks N(0, 1 / D), reproducible from the caller's generator."""
    mesh = par.ShardMesh(["cpu"] * 4)
    emb = ShardedEmbedding(1000, 64)
    a = emb.init(torch.Generator().manual_seed(5), mesh)["weight"]
    b = emb.init(torch.Generator().manual_seed(5), mesh)["weight"]
    assert a.sbp == ("S0",) and a.shape == (1000, 64) and a.local.requires_grad
    assert torch.equal(a.local, b.local) and not torch.equal(a.local[0], a.local[1])
    assert abs(float(a.local.detach().std()) * 8 - 1) < 0.05
    ids = torch.arange(-8, 1008)
    out = emb.apply({"weight": a}, ids, mesh)
    assert torch.equal(out[8:1008], a.local.detach().reshape(-1, 64)[:1000])
    assert not out[:8].any() and not out[1008:].any()
