"""The distributed training example (of_spmm_tpu_torch/examples/
train_dist.py) against the JAX package's.

Its loop runs 3 SGD steps on cora (symmetrized, normalized, partitioned
into 2 row shards) on ``ShardMesh(["cpu"] * 2)``, from the JAX example's
GCN weights (carried with ``gcn_params_from_numpy``); the losses equal
the JAX ``make_dist_train_step``'s on 2 simulated devices within rtol
1e-4 / atol 1e-5. Then ``main()`` runs through the port's launcher as 2
gloo ranks, each holding its padded block, and its printed losses equal
the shard mesh's from the same seeded weights; and ``--shards`` without
``--device`` goes to the card.
"""

import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from of_spmm_tpu.data import load_graph as jload_graph
from of_spmm_tpu.data import random_features as jrandom_features
from of_spmm_tpu.models import GCN as JGCN
from of_spmm_tpu.models import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.parallel import partition_rows as jpartition_rows
from of_spmm_tpu.train import make_dist_train_step as jmake_dist_train_step
from of_spmm_tpu_torch.data import load_graph, random_features
from of_spmm_tpu_torch.examples import train_dist
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.parallel import ShardMesh, partition_rows
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SHARDS = 3, 2


def _cora():
    csr, cfg = load_graph("cora", symmetrize=True)
    x, y = random_features(cfg)
    return partition_rows(normalized_adjacency(csr), SHARDS), cfg, x, y


def _mesh_losses(model):
    plan, _, x, y = _cora()
    return train_dist.train(model, plan, ShardMesh(["cpu"] * SHARDS), torch.from_numpy(x),
                            torch.from_numpy(y).long(), STEPS, log_every=0)


def test_loop_on_a_shard_mesh_matches_jax():
    csr, cfg = jload_graph("cora", symmetrize=True)
    jplan = jpartition_rows(jnormalized_adjacency(csr), SHARDS)
    jmodel = JGCN(feature_dims=(cfg.feature_dim, train_dist.HIDDEN, cfg.n_classes))
    params = jmodel.init(jax.random.key(0))
    weights = gcn_params_from_numpy(jax.tree.map(np.asarray, params))
    x, y = map(jnp.asarray, jrandom_features(cfg))
    step = jmake_dist_train_step(jmodel, jplan, Mesh(np.asarray(jax.devices()[:SHARDS]), ("x",)),
                                 lr=train_dist.LR)
    want = []
    for _ in range(STEPS):
        loss, params = step(params, x, y)
        want.append(float(loss))

    model = GCN((cfg.feature_dim, train_dist.HIDDEN, cfg.n_classes), device="cpu")
    model.load_state_dict(weights)
    np.testing.assert_allclose(_mesh_losses(model).numpy(), want, rtol=RTOL, atol=ATOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_through_the_launcher_matches_the_shard_mesh(tmp_path):
    cmd = [sys.executable, "-m", "of_spmm_tpu_torch.distributed.launch", "--nproc_per_node",
           str(SHARDS), "--master_port", str(_free_port()), "-m",
           "of_spmm_tpu_torch.examples.train_dist", "--graph", "cora", "--device", "cpu",
           "--steps", str(STEPS)]
    env = {**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = {int(i): float(v) for i, v in re.findall(r"step\s+(\d+)\s+loss ([0-9.]+)", proc.stdout)}
    assert sorted(got) == [0, STEPS - 1], proc.stdout
    assert proc.stdout.count("halo fraction") == SHARDS

    _, cfg, _, _ = _cora()
    model = GCN((cfg.feature_dim, train_dist.HIDDEN, cfg.n_classes), device="cpu",
                generator=torch.Generator().manual_seed(0))
    want = _mesh_losses(model).numpy()
    for i, v in got.items():  # printed to 6 decimals
        assert abs(v - want[i]) <= ATOL + RTOL * abs(want[i]) + 5e-7


def test_shards_without_device_go_to_the_card(monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def fake_mesh(devices):
        seen.extend(devices)
        raise Stop

    monkeypatch.setattr(train_dist, "ShardMesh", fake_mesh)
    monkeypatch.setattr(train_dist.distributed, "env_spec", lambda: {})
    if torch.cuda.is_available():
        with pytest.raises(Stop):
            train_dist.main(["--shards", "2"])
        assert [d.type for d in seen] == ["cuda", "cuda"]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_dist.main(["--shards", "2"])
        assert seen == []
