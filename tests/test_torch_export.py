"""The port's export (of_spmm_tpu_torch/export.py) and its kernels as
``torch.library`` ops (ops/cuda/library.py), against the JAX package's
export (of_spmm_tpu/export.py), on the CPU.

- ``torch.library.opcheck`` on each ``ofs::`` op (schema, fake and CPU
  implementation), with the arguments two seeded small cases pass it;
- ``export_model`` -> ``load_model`` of ``nn.Linear(8, 4)`` against the
  JAX package's round trip of the same weights;
- the GCN (6 -> 8 -> 3) on a 24-node graph through each operator layout,
  under the default ``impl="auto"`` and under ``impl="cuda"`` (on the CPU
  both run the engine layouts through the ops' CPU implementations), and
  ``spmm_expansion2``, exported, saved, reloaded and held against the JAX
  package's exported and reloaded forward (``impl="xla"``) with the same
  weights; the eager forward under ``"auto"`` and under ``"torch"`` (the
  plain versions inline) at the same bar;
- ``ir_stats`` shows one ``ofs.*`` node per op call of the eager forward;
- ``load_params`` round trip.

Tolerances are the JAX export test's: rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from of_spmm_tpu import nn as jnn
from of_spmm_tpu.export import export_model as jexport_model
from of_spmm_tpu.export import load_model as jload_model
from of_spmm_tpu.models import GCN as JGCN
from of_spmm_tpu.models import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.ops.autograd import spmm as jspmm
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch import nn
from of_spmm_tpu_torch.export import (
    export_graph_text, export_model, ir_stats, load_model, load_params)
from of_spmm_tpu_torch.interop import gcn_params_from_numpy, identity_params_from_numpy
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import place_plan, spmm_expansion2
from of_spmm_tpu_torch.ops.autograd import make_operator, spmm
from of_spmm_tpu_torch.ops.cuda import library
from of_spmm_tpu_torch.ops.flash_attention import flash_attention
from of_spmm_tpu_torch.sparse.expansion2 import build_expansion2_plan
from of_spmm_tpu_torch.sparse.formats import CSR

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6  # tests/test_export.py's bar
LAYOUTS = ("tiered", "binned", "panels", "fused", "ranges", "expansion")
N = 24


class Capture(TorchDispatchMode):
    """Records every ``ofs`` op call: (op, args, kwargs)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == library.NAMESPACE:
            self.calls.append((func, args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def _dense(seed: int, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(dense, 0)
    return dense


def _operator(layout: str, dense: np.ndarray):
    kw = {"tier_size": 8} if layout == "tiered" else {}
    return make_operator(normalized_adjacency(CSR.from_dense(dense)), layout=layout,
                         device="cpu", **kw)


def _x(seed: int, d: int, n: int = N) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d))
                            .astype(np.float32))


def _op_cases(name: str, seed: int) -> list:
    """The calls of ``ofs::<name>`` that one seeded small case makes."""
    with Capture() as cap:
        if name == "flash_attention":
            g = torch.Generator().manual_seed(seed)
            q, k, v = (torch.randn((2, 2, 8 + seed, 8), generator=g) for _ in range(3))
            flash_attention(q, k, v, is_causal=bool(seed % 2))
        elif name == "expansion2_spmm":
            a = normalized_adjacency(CSR.from_dense(_dense(seed)))
            spmm_expansion2(place_plan(build_expansion2_plan(a), "cpu"), _x(seed, 5))
        else:
            layout = {"bucket_spmm": "tiered", "gather_rows": "tiered", "panel_spmm": "panels",
                      "fused_spmm": "fused", "ranges_spmm": "ranges",
                      "expansion_spmm": "expansion"}[name]
            spmm(_operator(layout, _dense(seed)), _x(seed, 5), impl="cuda")
    calls = [(f, a, k) for f, a, k in cap.calls if f._schema.name == f"ofs::{name}"]
    assert calls, f"the case made no ofs::{name} call"
    return calls


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sorted(library.OPS))
def test_opcheck(name, seed):
    func, args, kwargs = _op_cases(name, seed)[0]
    torch.library.opcheck(func, args, kwargs)
    # the CPU implementation: the plain version on the same arguments
    out = func(*args, **kwargs)
    assert out is None or bool(torch.isfinite(out).all())


def test_linear_round_trip_matches_jax(tmp_path):
    jmodel = jnn.Linear(8, 4)
    params = jmodel.init(jax.random.key(0))
    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)

    def fwd(p, xx):
        return jmodel.apply(p, xx)

    jpath = jexport_model(fwd, (params, jnp.asarray(x)), str(tmp_path / "jax"), params=params)
    want = np.asarray(jload_model(jpath)(params, jnp.asarray(x)))

    model = nn.Linear(8, 4, device="cpu")
    model.load_state_dict(identity_params_from_numpy(jax.tree.map(np.asarray, params)))
    path = export_model(model, (torch.from_numpy(x),), str(tmp_path / "port"),
                        params=model.state_dict(), name="linear")
    got = load_model(path)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    assert (tmp_path / "port" / "meta.json").exists()
    import json

    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["name"] == "linear" and meta["in_avals"] == ["float32[2,8]"]
    assert meta["out_avals"] == ["float32[2,4]"] and meta["platforms"] == ["cpu"]


@pytest.fixture(scope="module")
def jax_gcn(tmp_path_factory):
    """The JAX package's GCN forward (impl="xla") on the 24-node graph,
    exported and reloaded: (params, x, served output)."""
    dense = _dense(0)
    op = jmake_operator(jnormalized_adjacency(JCSR.from_dense(dense)), place=False)
    model = JGCN(feature_dims=(6, 8, 3))
    params = model.init(jax.random.key(1))
    x = jnp.asarray(_x(0, 6).numpy())

    def fwd(p, xx):
        return model.apply(p, op, xx, impl="xla")

    path = jexport_model(fwd, (params, x), str(tmp_path_factory.mktemp("jax_gcn")))
    return params, np.array(x), np.asarray(jload_model(path)(params, x))


class _Forward(torch.nn.Module):
    def __init__(self, model, op, impl="cuda"):
        super().__init__()
        self.model, self.op, self.impl = model, op, impl

    def forward(self, x):
        return self.model(self.op, x, impl=self.impl)


@pytest.mark.parametrize("impl", ["auto", "cuda"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_gcn_round_trip_matches_jax(layout, impl, jax_gcn, tmp_path):
    params, x, want = jax_gcn
    model = GCN((6, 8, 3), device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    op = _operator(layout, _dense(0))
    if impl == "auto":  # eager: the default route and the plain versions inline
        with torch.no_grad():
            for eager in ("auto", "torch"):
                np.testing.assert_allclose(model(op, torch.from_numpy(x), impl=eager).numpy(),
                                           want, rtol=RTOL, atol=ATOL, err_msg=eager)
    path = export_model(_Forward(model, op, impl), (torch.from_numpy(x),),
                        str(tmp_path / layout))
    got = load_model(path)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_spmm_expansion2_round_trip_matches_jax(tmp_path):
    dense = _dense(3)
    x = _x(3, 6)
    jop = jmake_operator(jnormalized_adjacency(JCSR.from_dense(dense)), place=False)

    def jfwd(xx):
        return jspmm(jop, xx, impl="xla")

    jpath = jexport_model(jfwd, (jnp.asarray(x.numpy()),), str(tmp_path / "jax"))
    want = np.asarray(jload_model(jpath)(jnp.asarray(x.numpy())))
    plan = place_plan(build_expansion2_plan(normalized_adjacency(CSR.from_dense(dense))), "cpu")
    path = export_model(lambda xx: spmm_expansion2(plan, xx), (x,), str(tmp_path / "port"))
    np.testing.assert_allclose(load_model(path)(x).detach().numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ir_stats_counts_one_node_per_op_call(layout):
    model = GCN((6, 8, 3), device="cpu", generator=torch.Generator().manual_seed(0))
    fn = _Forward(model, _operator(layout, _dense(0)))
    x = _x(0, 6)
    with Capture() as cap, torch.no_grad():
        fn(x)
    calls = {}
    for f, _a, _k in cap.calls:
        key = "ofs." + f._schema.name.split("::")[1]
        calls[key] = calls.get(key, 0) + 1
    stats = ir_stats(fn, (x,))
    assert {k: n for k, n in stats["ops"].items() if k.startswith("ofs.")} == calls
    assert sum(calls.values()) >= 2 and stats["n_lines"] > 0
    assert "torch.ops.ofs." in export_graph_text(fn, (x,))


def test_load_params_round_trip(tmp_path):
    model = GCN((6, 8, 3), device="cpu", generator=torch.Generator().manual_seed(2))
    fn = _Forward(model, _operator("binned", _dense(0)))
    path = export_model(fn, (_x(0, 6),), str(tmp_path / "m"), params=model.state_dict())
    like = GCN((6, 8, 3), device="cpu").state_dict()
    got = load_params(path, like)
    assert list(got) == list(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v) and got[k].dtype == like[k].dtype
    with pytest.raises(KeyError):
        load_params(path, {"w": torch.zeros(1)})


def test_saved_program_holds_no_address_table(tmp_path):
    """The bucket kernel's address table is built by the op from its own
    arguments: no constant of the program is an int64 table of them."""
    op = _operator("tiered", _dense(0))
    model = GCN((6, 8, 3), device="cpu", generator=torch.Generator().manual_seed(0))
    from of_spmm_tpu_torch.export import export_program

    ep = export_program(_Forward(model, op), (_x(0, 6),))
    ptrs = {p for p in op.work.ptrs}
    for t in ep.constants.values():
        if isinstance(t, torch.Tensor) and t.dtype == torch.int64:
            assert not (set(t.reshape(-1).tolist()) & ptrs)
    assert not any(isinstance(t, torch.Tensor) and t is op.work.table
                   for t in ep.constants.values())
