"""The port's entry points (of_spmm_tpu_torch/entry.py) against
the repository's ``__graft_entry__.py`` for the JAX package, on the CPU.

- ``entry(device="cpu", canary_graph="cora")``: finite (2708, 7) logits,
  through the fused, bucket and flash ops, and the bf16 residual canary;
- ``dryrun_multichip(4, device="cpu")``: its first distributed training
  step's loss against the JAX ``make_dist_train_step`` on the same inputs
  (the JAX dry run's graph and data) and carried parameters, within
  rtol 1e-4 / atol 1e-5; every strategy's result finite;
- the new modules (export, testing, autoprof, entry, the op library)
  import neither JAX nor the JAX package, and the entry points go to the
  card unless the caller names the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from of_spmm_tpu.models import GCN as JGCN
from of_spmm_tpu.models import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.parallel.partition import partition_rows as jpartition_rows
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu.train import make_dist_train_step as jmake_dist_train_step
from of_spmm_tpu_torch import entry as port_entry
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from tests.conftest import ATOL, RTOL
from tests.test_torch_isolation import _PROBE, _REPO

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

NEW_MODULES = ["export", "autoprof", "testing", "testing.autotest", "entry", "ops.cuda.library"]


class OpCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "ofs":
            self.names.add(func._schema.name.split("::")[1])
        return func(*args, **(kwargs or {}))


def test_entry_gives_finite_cora_logits():
    fn, args = port_entry.entry(device="cpu", canary_graph="cora")
    with OpCalls() as calls, torch.no_grad():
        out = fn(*args)
    assert tuple(out.shape) == (2708, 7) and bool(torch.isfinite(out).all())
    assert {"fused_spmm", "bucket_spmm", "flash_attention"} <= calls.names
    with torch.no_grad():
        logits = fn.model(fn.op, args[0])
    np.testing.assert_allclose(out.numpy(), logits.numpy(), rtol=1e-6, atol=1e-6)


def test_excess_precision_canary():
    assert port_entry.excess_precision_canary("cpu") == 2.0 ** -20


def _jax_first_loss(n_devices: int):
    """The JAX dry run's first step (its graph, data and GCN), and its
    initial parameters."""
    rng = np.random.default_rng(0)
    n, d, h, c = 8 * n_devices, 16, 8, 4
    dense = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(dense, 0)
    csr = jnormalized_adjacency(JCSR.from_dense(dense))
    model = JGCN(feature_dims=(d, h, c))
    params = model.init(jax.random.key(0))
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, c, n).astype(np.int32))
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("x",))
    loss, _ = jmake_dist_train_step(model, jpartition_rows(csr, n_devices), mesh)(
        params, x, labels)
    return float(loss), params


def test_dryrun_multichip_first_loss_matches_jax():
    want, params = _jax_first_loss(4)
    res = port_entry.dryrun_multichip(
        4, device="cpu", gcn_params=gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    np.testing.assert_allclose(res["loss"], want, rtol=RTOL, atol=ATOL)
    for key in ("y_ragged", "y_panels", "g_panels", "y_split_panels", "g_split_panels",
                "y_tp", "y_sp", "y_ring"):
        assert bool(torch.isfinite(res[key]).all()), key
    assert res["y_ragged"].shape == (32, 16) and res["y_tp"].shape == (32, 16)
    assert all(np.isfinite(res[k]) for k in ("pp_loss", "loss_1f1b", "moe_loss"))


def test_main_on_the_cpu(capsys):
    port_entry.main(["--device", "cpu", "--canary-graph", "cora", "--shards", "2"])
    out = capsys.readouterr().out
    assert "entry ok: (2708, 7) finite: True" in out and "dryrun_multichip(2) ok" in out


def test_new_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": _REPO})
    assert out.returncode == 0, out.stderr
    _n, bad, names = out.stdout.strip().split(" ", 2)
    assert bad == "[]", out.stdout
    assert {f"of_spmm_tpu_torch.{m}" for m in NEW_MODULES} <= set(names.split(","))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)
