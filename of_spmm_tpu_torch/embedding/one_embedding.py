"""Tiered embedding storage: persistent host table + a row cache on the card.

The counterpart of the JAX package's ``embedding/one_embedding.py``. The
host owns the id -> slot map and the LRU policy (numpy, as in the JAX
package: the same slots, clocks and victims for the same ids); the card
owns one dense (capacity, dim) float32 cache tensor indexed with the
host's slots.

Training loop contract (the JAX package's signatures):

    emb = CachedEmbedding(table, capacity=65536)
    cache, meta = emb.init_cache()                       # on the card
    slots, cache = emb.prepare(ids, cache, meta)         # host: dedup, miss fill
    rows = emb.lookup(cache, slots)                      # differentiable gather
    ...
    cache = emb.apply_grad(cache, slots, g_rows, meta, lr)   # sparse row update
    emb.flush(cache, meta)                               # write dirty rows back

The cache tensor is updated in place (``index_copy_`` when ``prepare``
installs fetched rows, ``index_add_`` in ``apply_grad``) and the same
tensor is returned, so a loop written for the JAX package's functional
form reads the same here.

``PersistentTable`` writes the JAX package's files (``meta.json``, the
float32 ``values.dat`` memmap, ``ids.npy`` and the snapshot directory),
so a table written by one package opens in the other. Its host loops are
vectorised, with the same results: rows of first-touched ids are drawn
in one ``standard_normal((k, dim))`` call in first-touch order, which
gives the numbers of k one-row draws.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.ops.autograd import gather
from of_spmm_tpu_torch.utils.device import resolve_device


def _first_seen(ids, known: dict) -> list:
    """The ids of ``ids`` (a list) not in ``known``, once each, in order
    of first appearance."""
    return list(dict.fromkeys(x for x in ids if x not in known))


class PersistentTable:
    """Host-side persistent KV table: int64 ids -> float32 rows.

    File-backed (np.memmap) fixed-capacity store with an in-memory
    id -> index dict (rebuilt from ``ids.npy`` on open; that file is
    written by ``save_snapshot`` only, so a table reopened without a
    snapshot forgets its ids and its generator restarts at ``seed``).
    Rows for never-seen ids are initialized by ``initializer`` on first
    touch.
    """

    def __init__(
        self,
        path: str,
        dim: int,
        capacity: int = 1 << 20,
        initializer: str = "normal",
        init_scale: float = 0.05,
        seed: int = 0,
    ):
        self.path = path
        self.dim = dim
        self.capacity = capacity
        self.initializer = initializer
        self.init_scale = init_scale
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)
        self._meta_file = os.path.join(path, "meta.json")
        self._ids_file = os.path.join(path, "ids.npy")
        self._vals_file = os.path.join(path, "values.dat")
        if os.path.exists(self._meta_file):
            self._open()
        else:
            self._create()

    def _create(self):
        with open(self._meta_file, "w") as f:
            json.dump({"dim": self.dim, "capacity": self.capacity, "n": 0}, f)
        self._ids = np.full(self.capacity, -1, np.int64)
        self._vals = np.memmap(self._vals_file, np.float32, "w+",
                               shape=(self.capacity, self.dim))
        self._index: Dict[int, int] = {}
        self._n = 0

    def _open(self):
        with open(self._meta_file) as f:
            meta = json.load(f)
        if meta["dim"] != self.dim:
            raise ValueError(
                f"table at {self.path} has dim {meta['dim']}, want {self.dim}")
        self.capacity = meta["capacity"]
        self._ids = np.load(self._ids_file) if os.path.exists(self._ids_file) \
            else np.full(self.capacity, -1, np.int64)
        self._vals = np.memmap(self._vals_file, np.float32, "r+",
                               shape=(self.capacity, self.dim))
        live = np.nonzero(self._ids >= 0)[0]
        self._index = dict(zip(self._ids[live].tolist(), live.tolist()))
        self._n = len(live)

    def _init_rows(self, k: int) -> np.ndarray:
        if self.initializer == "zeros":
            return np.zeros((k, self.dim), np.float32)
        return (self._rng.standard_normal((k, self.dim)) *
                self.init_scale).astype(np.float32)

    def _admit(self, new: list) -> int:
        """Give the ids ``new`` the next free rows, as many as fit; how many
        did."""
        take = new[: self.capacity - self._n]
        if take:
            slots = np.arange(self._n, self._n + len(take))
            self._index.update(zip(take, slots.tolist()))
            self._ids[slots] = take
            self._n += len(take)
        return len(take)

    def get(self, ids: np.ndarray) -> np.ndarray:
        """Fetch rows (first touch initializes)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        id_list = ids.tolist()
        with self._lock:
            new = _first_seen(id_list, self._index)
            start = self._n
            fit = self._admit(new)
            if fit:
                self._vals[start:self._n] = self._init_rows(fit)
            if fit < len(new):
                raise RuntimeError(
                    f"PersistentTable at {self.path} full ({self.capacity} rows)")
            slots = np.fromiter((self._index[x] for x in id_list), np.int64, len(id_list))
            return np.asarray(self._vals[slots])

    def put(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        id_list = ids.tolist()
        with self._lock:
            new = _first_seen(id_list, self._index)
            fit = self._admit(new)
            # the rows before the first id that found no room are written,
            # as one id at a time would; a repeated id keeps its last row
            stop = len(id_list) if fit == len(new) else id_list.index(new[fit])
            slots = np.fromiter((self._index[x] for x in id_list[:stop]), np.int64, stop)
            _, last = np.unique(slots[::-1], return_index=True)
            keep = stop - 1 - last
            self._vals[slots[keep]] = np.asarray(rows)[:stop][keep]
            if fit < len(new):
                raise RuntimeError("table full")

    @property
    def n_rows(self) -> int:
        return self._n

    def save_snapshot(self, name: str = "snapshot") -> str:
        """Durable snapshot (reference: Embedding.save_snapshot)."""
        with self._lock:
            self._vals.flush()
            np.save(self._ids_file, self._ids)
            snap_dir = os.path.join(self.path, name)
            os.makedirs(snap_dir, exist_ok=True)
            np.save(os.path.join(snap_dir, "ids.npy"), self._ids)
            live = self._ids >= 0
            np.save(os.path.join(snap_dir, "values.npy"),
                    np.asarray(self._vals)[: self.capacity][live])
            np.save(os.path.join(snap_dir, "live.npy"), np.nonzero(live)[0])
        return snap_dir

    def load_snapshot(self, name: str = "snapshot") -> None:
        snap_dir = os.path.join(self.path, name)
        ids = np.load(os.path.join(snap_dir, "ids.npy"))
        vals = np.load(os.path.join(snap_dir, "values.npy"))
        slots = np.load(os.path.join(snap_dir, "live.npy"))
        with self._lock:
            self._ids[:] = -1
            self._vals[slots] = vals
            self._ids[slots] = ids[slots]
            self._index = dict(zip(self._ids[slots].tolist(), slots.tolist()))
            self._n = len(slots)


@dataclasses.dataclass
class _CacheMeta:
    """Host-side cache bookkeeping (slot -> id, LRU clock, dirty bits)."""

    slot_ids: np.ndarray  # (capacity,) int64, -1 = empty
    last_used: np.ndarray  # (capacity,) int64 LRU stamps
    dirty: np.ndarray  # (capacity,) bool — updated on device since fetch
    clock: int = 0
    index: Dict[int, int] = dataclasses.field(default_factory=dict)


def _on(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64)).to(device)


class CachedEmbedding:
    """A row cache on the card over a PersistentTable.

    The device state is one dense (capacity, dim) float32 tensor on
    ``device`` (the card unless the caller names another); the host
    decides which table rows live in which cache slots. ``prepare`` is
    the per-step host phase (dedup, miss fetch, LRU evict + write-back).
    """

    def __init__(self, table: PersistentTable, capacity: int = 65536, device=None):
        self.table = table
        self.capacity = capacity
        self.dim = table.dim
        self.device = device

    def init_cache(self) -> Tuple[torch.Tensor, _CacheMeta]:
        cache = torch.zeros((self.capacity, self.dim), dtype=torch.float32,
                            device=resolve_device(self.device))
        meta = _CacheMeta(
            slot_ids=np.full(self.capacity, -1, np.int64),
            last_used=np.zeros(self.capacity, np.int64),
            dirty=np.zeros(self.capacity, bool),
        )
        return cache, meta

    def prepare(
        self, ids: np.ndarray, cache: torch.Tensor, meta: _CacheMeta
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Host phase: ensure every id is cached; return per-id slots.

        Evicts least-recently-used slots when full, writing dirty rows
        back to the persistent table first. Victims: empty slots first,
        then ``np.argsort(meta.last_used)``'s order (the default sort, as
        the JAX package's: slots of one step tie) among slots whose id is
        not requested.
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        uniq, inverse = np.unique(ids, return_inverse=True)
        meta.clock += 1
        index = meta.index
        missing = [x for x in uniq.tolist() if x not in index]
        if missing:
            need = len(missing)
            victims = np.nonzero(meta.slot_ids < 0)[0][:need]
            if len(victims) < need:
                order = np.argsort(meta.last_used)
                sid = meta.slot_ids[order]
                lru = order[(sid >= 0) & ~np.isin(sid, uniq)]
                victims = np.concatenate([victims, lru[: need - len(victims)]])
                if len(victims) < need:
                    raise RuntimeError(
                        f"cache too small: need {need} slots, "
                        f"capacity {self.capacity}")
            victims = victims.astype(np.int64)
            dirty_v = victims[meta.dirty[victims]]
            if len(dirty_v):
                with torch.no_grad():
                    rows = cache[_on(dirty_v, cache.device)].cpu().numpy()
                self.table.put(meta.slot_ids[dirty_v], rows)
                meta.dirty[dirty_v] = False
            for sid in meta.slot_ids[victims].tolist():
                if sid >= 0:
                    del index[sid]
            fresh = self.table.get(np.asarray(missing, np.int64))
            with torch.no_grad():
                cache.index_copy_(0, _on(victims, cache.device),
                                  torch.from_numpy(fresh).to(cache.device))
            index.update(zip(missing, victims.tolist()))
            meta.slot_ids[victims] = missing
        used = np.fromiter((index[x] for x in uniq.tolist()), np.int64, len(uniq))
        meta.last_used[used] = meta.clock
        return used[inverse].astype(np.int32), cache

    @staticmethod
    def lookup(cache: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
        """Device gather (differentiable: its backward is a segment sum
        into the cache)."""
        return gather(cache, torch.as_tensor(np.asarray(slots)).to(cache.device))

    def apply_grad(
        self, cache: torch.Tensor, slots: np.ndarray, g_rows: torch.Tensor,
        meta: _CacheMeta, lr: float = 0.1,
    ) -> torch.Tensor:
        """Sparse SGD on cached rows, in place (duplicate slots add up);
        marks touched slots dirty."""
        with torch.no_grad():
            cache.index_add_(0, _on(slots, cache.device),
                             torch.as_tensor(g_rows).to(cache.device, cache.dtype), alpha=-lr)
        meta.dirty[np.unique(np.asarray(slots))] = True
        return cache

    def flush(self, cache: torch.Tensor, meta: _CacheMeta) -> None:
        """Write all dirty cached rows back to the persistent table."""
        dirty = np.nonzero(meta.dirty)[0]
        if len(dirty) == 0:
            return
        with torch.no_grad():
            rows = cache[_on(dirty, cache.device)].cpu().numpy()
        self.table.put(meta.slot_ids[dirty], rows)
        meta.dirty[dirty] = False


class MultiTableEmbedding:
    """Named tables sharing one API (reference MultiTableEmbedding)."""

    def __init__(self, tables: Dict[str, CachedEmbedding]):
        self.tables = tables

    def init_caches(self):
        return {k: v.init_cache() for k, v in self.tables.items()}

    def save_snapshot(self, name: str = "snapshot"):
        for emb in self.tables.values():
            emb.table.save_snapshot(name)

    def load_snapshot(self, name: str = "snapshot"):
        for emb in self.tables.values():
            emb.table.load_snapshot(name)
