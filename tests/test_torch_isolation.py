"""The port stands alone: importing every module of of_spmm_tpu_torch
(the parallel strategies, the training stack, the examples, the vision
models and the embedding path among them) loads neither JAX nor the JAX
package, and its entry points run on the card unless the caller names
another device."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.embedding import CachedEmbedding, PersistentTable
from of_spmm_tpu_torch.examples import train_bert, train_dist, train_gcn
from of_spmm_tpu_torch.models import GCN, Embedding, ShardedEmbedding, resnet50, vgg16
from of_spmm_tpu_torch.ops import make_operator
from of_spmm_tpu_torch.parallel import (
    MoELayer, RingAttention, SequenceParallelAttention, default_mesh, init_tp_mlp)
from of_spmm_tpu_torch.sparse.formats import CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import of_spmm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "of_spmm_tpu" or m.startswith("of_spmm_tpu."))
print(len(names), bad, ",".join(names))
"""

# the modules of the distribution layer and its example that must be among them
PARALLEL = ["parallel." + m for m in ("mesh", "global_view", "tp", "sp", "ring", "ep",
                                      "pipeline", "ddp", "auto_sharding")]
PARALLEL += ["examples.train_dist", "utils.errors"]
# the training stack and its examples
PARALLEL += ["optim.optimizers", "optim.indexed_slices", "optim.lr_scheduler", "amp", "graph",
             "utils.checkpoint", "utils.tree", "data.dataset", "nn.losses",
             "examples.train_bert", "examples.train_gcn"]
# the rest of nn/ and the vision models
PARALLEL += ["nn.conv", "nn.volumetric", "nn.rnn", "nn.extras", "nn.module", "models.resnet",
             "models.vision"]
# the embedding path, records and image transforms, profiler and summary
PARALLEL += ["embedding.one_embedding", "models.embedding", "models.sharded_embedding",
             "data.records", "data.vision", "utils.profiler", "utils.summary"]


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": _REPO})
    assert out.returncode == 0, out.stderr
    n, bad, names = out.stdout.strip().split(" ", 2)
    assert int(n) >= 15 and bad == "[]", out.stdout
    assert {f"of_spmm_tpu_torch.{m}" for m in PARALLEL} <= set(names.split(","))


def test_entry_points_default_to_the_card():
    csr = CSR.from_dense(np.eye(3, dtype=np.float32))
    if torch.cuda.is_available():
        op = make_operator(csr)
        assert op.binned.buckets[0].cols.is_cuda
        assert next(GCN((2, 2)).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_operator(csr)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GCN((2, 2))


def test_parallel_entry_points_default_to_the_card():
    makers = [lambda: init_tp_mlp(4, 8), lambda: MoELayer(4, 2, 8),
              lambda: SequenceParallelAttention(4, 2), lambda: RingAttention(4, 2)]
    if torch.cuda.is_available():
        assert init_tp_mlp(4, 8)["w_in"].is_cuda
        assert all(next(m().parameters()).is_cuda for m in makers[1:])
    else:
        for make in makers:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_dist.main(["--steps", "1"])


def test_example_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert next(train_bert.make_model(64, 16, 32, 4, 1, 64).parameters()).is_cuda
        return
    for main in (train_gcn.main, train_bert.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"] if main is train_bert.main else ["--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bert.make_model(64, 16, 32, 4, 1, 64)


def test_vision_models_default_to_the_card():
    if torch.cuda.is_available():
        assert next(resnet50().parameters()).is_cuda and next(resnet50().buffers()).is_cuda
        assert next(vgg16().parameters()).is_cuda
        return
    for make in (resnet50, vgg16):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_embedding_entry_points_default_to_the_card(tmp_path):
    emb = CachedEmbedding(PersistentTable(str(tmp_path / "t"), 4, 16), capacity=8)
    if torch.cuda.is_available():
        assert emb.init_cache()[0].is_cuda and Embedding(5, 3).weight.is_cuda
        assert ShardedEmbedding(8, 2).init(None, default_mesh(1))["weight"].local.is_cuda
        return
    for make in (emb.init_cache, lambda: Embedding(5, 3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        ShardedEmbedding(8, 2).init(None, default_mesh())
