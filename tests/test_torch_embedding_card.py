"""The embedding path and the profiler on the card against the same calls
on the CPU. No JAX; on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_embedding_card.py

(--noconftest: tests/conftest.py imports JAX, which the card's machine
has not). Without a card the tests skip.
"""

import json
import os

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.embedding import CachedEmbedding, PersistentTable
from of_spmm_tpu_torch.models import Embedding, ShardedEmbedding
from of_spmm_tpu_torch.parallel import GlobalTensor, ShardMesh
from of_spmm_tpu_torch.utils import profiler

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _close(got, want):
    """|k - p| <= 1e-5 + 1e-4 |p| (the card's index_add_ sums duplicates in
    another order)."""
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cached_embedding_on_the_card_matches_the_cpu(card, tmp_path):
    """Eight steps with evictions: slots and meta equal, cache, losses and
    the flushed rows within tolerance."""
    runs = []
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, 400, 96) for _ in range(8)]
    for dev in (card, torch.device("cpu")):
        emb = CachedEmbedding(PersistentTable(str(tmp_path / dev.type), 8, 1000, seed=1), 128,
                              device=dev)
        cache, meta = emb.init_cache()
        assert cache.device.type == dev.type
        out = []
        for ids in steps:
            slots, cache = emb.prepare(ids, cache, meta)
            rows = emb.lookup(cache, slots).requires_grad_()
            loss = (rows ** 2).sum(1).mean()
            loss.backward()
            emb.apply_grad(cache, slots, rows.grad, meta, lr=0.5)
            out.append((slots, loss.detach().cpu()))
        emb.flush(cache, meta)
        runs.append((out, cache.cpu(), meta, emb.table.get(np.arange(400))))
    (got, gcache, gmeta, grows), (want, wcache, wmeta, wrows) = runs
    for (s, l), (ws, wl) in zip(got, want):
        np.testing.assert_array_equal(s, ws)
        _close(l, wl)
    for k in ("slot_ids", "last_used", "dirty"):
        np.testing.assert_array_equal(getattr(gmeta, k), getattr(wmeta, k))
    assert gmeta.index == wmeta.index and gmeta.clock == wmeta.clock
    assert len(gmeta.index) == 128  # full: the later steps evicted
    _close(gcache, wcache)
    _close(torch.from_numpy(grows), torch.from_numpy(wrows))


@pytest.mark.cuda
def test_sharded_embedding_on_the_card_matches_the_cpu(card):
    """Four shards of the card against four of the CPU on the CPU's seeded
    table: the forward bit for bit, the table's grad; init on the card
    places the blocks there."""
    emb = ShardedEmbedding(1001, 16)
    ids = torch.from_numpy(np.random.default_rng(0).integers(-5, 1010, 256))
    cot = torch.randn((256, 16), generator=torch.Generator().manual_seed(1))
    host = ShardMesh(["cpu"] * 4)
    p = emb.init(torch.Generator().manual_seed(2), host)
    want = emb.apply(p, ids, host)
    (want * cot).sum().backward()
    mesh = ShardMesh([str(card)] * 4)
    assert emb.init(None, mesh)["weight"].local.is_cuda
    w = GlobalTensor(p["weight"].local.detach().to(card).requires_grad_(), ("S0",), mesh)
    got = emb.apply({"weight": w}, ids, mesh)
    assert torch.equal(got.cpu(), want.detach())
    (got * cot.to(card)).sum().backward()
    _close(w.local.grad, p["weight"].local.grad)
    assert w.local.shape == (4, 251, 16)


@pytest.mark.cuda
def test_embedding_module_on_the_card_matches_the_cpu(card):
    host = Embedding(50, 8, padding_idx=3, device="cpu",
                     generator=torch.Generator().manual_seed(4))
    dev = Embedding(50, 8, padding_idx=3, device=card)
    dev.load_state_dict(host.state_dict())
    ids = torch.tensor([[1, 3, 1, 49], [50, -1, 7, 1]])
    outs = [m(ids.to(m.weight.device)) for m in (host, dev)]
    assert torch.equal(outs[1].cpu(), outs[0])
    for m, o in zip((host, dev), outs):
        (o * torch.arange(8.0, device=o.device)).sum().backward()
    _close(dev.weight.grad, host.weight.grad)


@pytest.mark.cuda
def test_profiler_on_the_card(card, tmp_path):
    """memory_analysis from the caching allocator, and a trace that holds
    the card's kernels beside the range."""
    a = torch.randn((64, 64), device=card)
    m = profiler.memory_analysis(lambda x: (x @ x).sum(0), a)
    assert (m["argument"], m["output"], m["generated_code_size"]) == (16384, 256, 0)
    assert m["temp"] >= 16384 and m["peak"] == m["argument"] + m["output"] + m["temp"]
    with profiler.trace(str(tmp_path)):
        with profiler.record("card_range"):
            (a @ a).sum()
            torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    assert any(e.get("name") == "card_range" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
