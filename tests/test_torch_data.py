"""The port's data/dataset.py against the JAX package's (host numpy, no
JAX), on the CPU: ``TensorDataset``, ``TokenDataset`` (an array, a
``.npy`` file, a raw ``.bin`` file, a stride), ``ShardedDataset`` and the
``DataLoader`` (``drop_last``, the seeded shuffle per epoch, the prefetch
thread, ``num_workers=2``, a worker's error) yield the same batches in
the same order, the port's as CPU tensors."""

import numpy as np
import pytest
import torch

from of_spmm_tpu.data import dataset as jds
from of_spmm_tpu_torch.data import (
    DataLoader, Dataset, ShardedDataset, TensorDataset, TokenDataset, shard_dataset)

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (g, w) if isinstance(w, tuple) else ((g,), (w,))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)


def _xy(n=103):
    return (np.arange(n * 3, dtype=np.float32).reshape(n, 3), np.arange(n, dtype=np.int64))


@pytest.mark.parametrize("kw", [dict(batch_size=8), dict(batch_size=8, drop_last=True),
                                dict(batch_size=10, shuffle=True, seed=7),
                                dict(batch_size=10, shuffle=True, seed=7, prefetch=0)],
                         ids=["plain", "drop_last", "shuffle_prefetch", "shuffle_sync"])
def test_tensor_dataset_loader_matches_jax(kw):
    x, y = _xy()
    loader, jloader = DataLoader(TensorDataset(x, y), **kw), jds.DataLoader(
        jds.TensorDataset(x, y), **kw)
    assert len(loader) == len(jloader)
    for epoch in (0, 1):  # set_epoch reshuffles, as the reference sampler
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        _same_batches(list(loader), list(jloader))
    if kw.get("shuffle"):
        loader.set_epoch(0)
        first = [b[1] for b in loader]
        loader.set_epoch(1)
        assert not all(torch.equal(a, b) for a, b in zip(first, [b[1] for b in loader]))


def test_tensor_dataset_of_tensors_and_errors():
    x, y = _xy(20)
    ds = TensorDataset(torch.from_numpy(x), torch.from_numpy(y))
    _same_batches(list(DataLoader(ds, batch_size=6)),
                  list(jds.DataLoader(jds.TensorDataset(x, y), batch_size=6)))
    with pytest.raises(ValueError, match="leading dim"):
        TensorDataset(x, y[:5])
    with pytest.raises(ValueError, match="batch_size"):
        DataLoader(ds, batch_size=0)


@pytest.mark.parametrize("source", ["array", "npy", "bin"])
@pytest.mark.parametrize("stride", [None, 3])
def test_token_dataset_matches_jax(tmp_path, source, stride):
    tokens = np.random.default_rng(0).integers(0, 500, 101).astype(np.int32)
    src = tokens
    if source == "npy":
        src = str(tmp_path / "tok.npy")
        np.save(src, tokens)
    elif source == "bin":
        src = str(tmp_path / "tok.bin")
        tokens.tofile(src)
    ds, jd = TokenDataset(src, 8, stride=stride), jds.TokenDataset(src, 8, stride=stride)
    assert len(ds) == len(jd) > 0
    for i in (0, len(ds) - 1):
        for a, b in zip(ds[i], jd[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        ds[len(ds)]
    _same_batches(list(DataLoader(ds, batch_size=4, shuffle=True, seed=3)),
                  list(jds.DataLoader(jd, batch_size=4, shuffle=True, seed=3)))


def test_sharded_dataset_matches_jax():
    x, y = _xy(23)
    for world in (2, 3):
        for rank in range(world):
            s, js = shard_dataset(TensorDataset(x, y), rank, world), jds.shard_dataset(
                jds.TensorDataset(x, y), rank, world)
            assert isinstance(s, ShardedDataset) and len(s) == len(js)
            _same_batches(list(DataLoader(s, batch_size=4)),
                          list(jds.DataLoader(js, batch_size=4)))
    with pytest.raises(ValueError, match="outside world"):
        ShardedDataset(TensorDataset(x), 2, 2)


def test_loader_num_workers_matches_jax():
    x, y = _xy()
    kw = dict(batch_size=8, shuffle=True, seed=7)
    got = list(DataLoader(TensorDataset(x, y), num_workers=2, **kw))
    assert len(got) == 13
    _same_batches(got, list(jds.DataLoader(jds.TensorDataset(x, y), num_workers=0, **kw)))


def test_loader_worker_error_surfaces():
    class Bad(Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("boom")
            return np.zeros(2, np.float32)

    with pytest.raises(RuntimeError, match="worker failed.*boom"):
        list(DataLoader(Bad(), batch_size=2, num_workers=2))
    with pytest.raises(ValueError, match="boom"):  # the prefetch thread re-raises
        list(DataLoader(Bad(), batch_size=2))
