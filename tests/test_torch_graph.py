"""The port's graph/, amp/ and utils/checkpoint.py against the JAX package,
on the CPU, on the JAX tests' MLP (tests/test_graph.py ``_mlp_and_data``:
Linear(4, 16), relu, Linear(16, 2), 32 rows) with the same weights. The
port's module names its layers ``layer_0`` / ``layer_2``, so its
parameter tree and checkpoint keys are the JAX ones.

- TrainGraph against JAX ``train_graph``: 5 Adam steps with clipping,
  grad accumulation 4 (against 1 and against JAX), activation
  checkpointing; AMP for 3 steps at rtol 2e-2 on the losses, float32
  master parameters, float32 grads;
- ``GradScaler`` dynamics, and the skipped non-finite step: parameters,
  optimizer state, its step counter and the schedule unchanged, the
  scale backed off, the next step in step with JAX;
- ZeRO-1 on ``ShardMesh(["cpu"] * 8)``: the S(0) leaves are the ones the
  JAX rule shards on ``mesh8``, the numbers those of stage 0 and of JAX;
- ``EvalGraph`` under AMP returns float32;
- checkpoints: resume at step 3 identical to the uninterrupted run; a
  JAX-written file loads in the port and a port-written one in JAX (the
  same keys), a JAX TrainGraph state (with its scaler) carried by
  ``interop.train_state_from_numpy`` continues in step with JAX for 3
  steps; generic trees both ways and the structure-mismatch error;
  ``save_sharded`` / ``load_sharded`` in one process;
- ``OFS_DEBUG_PASS`` prints the same pass lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu import amp as jamp
from of_spmm_tpu import nn as jnn
from of_spmm_tpu import optim as joptim
from of_spmm_tpu.graph import EvalGraph as JEvalGraph
from of_spmm_tpu.graph import GraphConfig as JGraphConfig
from of_spmm_tpu.graph import TrainGraph as JTrainGraph
from of_spmm_tpu.graph import train_graph as jtrain_graph
from of_spmm_tpu.utils import checkpoint as jckpt
from of_spmm_tpu_torch import amp, optim
from of_spmm_tpu_torch.graph import EvalGraph, GraphConfig, TrainGraph, train_graph
from of_spmm_tpu_torch.interop import identity_params_from_numpy, train_state_from_numpy
from of_spmm_tpu_torch.nn import Linear, losses
from of_spmm_tpu_torch.optim import lr_scheduler as tsched
from of_spmm_tpu_torch.parallel import GlobalTensor, ShardMesh
from of_spmm_tpu_torch.utils import checkpoint as tckpt
from of_spmm_tpu_torch.utils.tree import unnest
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol)


class MLP(torch.nn.Module):
    """Linear, relu, Linear, named as the JAX Sequential's params."""

    def __init__(self, sizes=(4, 16, 2)):
        super().__init__()
        self.layer_0 = Linear(sizes[0], sizes[1], device="cpu")
        self.layer_2 = Linear(sizes[1], sizes[2], device="cpu")

    def forward(self, x):
        return self.layer_2(torch.relu(self.layer_0(x)))


def _pair(seed=0, n=32, sizes=(4, 16, 2)):
    """The JAX model, params, data and loss; the port's model (the same
    weights), data and loss."""
    jmodel = jnn.Sequential(jnn.Linear(sizes[0], sizes[1]), jnn.relu,
                            jnn.Linear(sizes[1], sizes[2]))
    params = jmodel.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[2], n).astype(np.int32)

    def jloss(p, xx, yy):
        return jnn.losses.cross_entropy(jmodel.apply(p, xx), yy)

    model = MLP(sizes)
    model.load_state_dict(identity_params_from_numpy(jax.tree.map(np.asarray, params)))
    return (jmodel, params, (jnp.asarray(x), jnp.asarray(y)), jloss,
            model, (torch.from_numpy(x), torch.from_numpy(y).long()), loss_fn)


def loss_fn(model, x, y):
    return losses.cross_entropy(model(x), y)


def _jax_run(jloss, opt, params, batch, steps, **cfg):
    init, step = jtrain_graph(jloss, opt, JGraphConfig(**cfg), donate=False)
    state, out = init(params), []
    for _ in range(steps):
        params, state, m = step(params, state, *batch)
        out.append(m)
    return params, state, out


def _same_params(model, jparams, rtol=RTOL, atol=ATOL):
    flat = unnest(jax.tree.map(np.asarray, jparams))
    named = dict(model.named_parameters())
    assert set(flat) == set(named)
    for k, v in flat.items():
        _close(named[k], v, rtol, atol)


def _sched_pair(lr=1e-2):
    return (joptim.lr_scheduler.warmup(joptim.lr_scheduler.cosine_annealing(lr, 20), 3),
            tsched.warmup(tsched.cosine_annealing(lr, 20), 3))


@pytest.mark.parametrize("cfg", [dict(clip_grad_norm=1.0), dict(grad_accumulation_steps=4),
                                 dict(checkpoint_activations=True)],
                         ids=["adam_clip", "grad_acc4", "checkpoint_activations"])
def test_train_graph_matches_jax(cfg):
    _, params, jb, jloss, model, tb, _ = _pair()
    jsched, tsch = _sched_pair()
    jp, _, jm = _jax_run(jloss, joptim.adam(jsched), params, jb, 5, **cfg)
    g = TrainGraph(loss_fn, optim.adam(tsch), model, GraphConfig(**cfg))
    for want in jm:
        m = g(*tb)
        _close(m["loss"], want["loss"])
        assert bool(m["did_step"])
        if "clip_grad_norm" in cfg:
            _close(m["grad_norm"], want["grad_norm"])
    _same_params(model, jp)
    assert g.step_count == 5 and int(g.state_dict()["state"]["opt"]["step"]) == 5


def test_grad_accumulation_equals_full_batch():
    """K micro-batches of mean-loss grads equal the full batch's (SGD)."""
    outs = []
    for k in (1, 4):
        _, _, _, _, model, tb, _ = _pair()
        init, step = train_graph(loss_fn, optim.sgd(0.1), GraphConfig(grad_accumulation_steps=k))
        _, _, m = step(model, init(model), *tb)
        outs.append((m["loss"], [p.detach().clone() for p in model.parameters()]))
    _close(outs[1][0], outs[0][0].numpy(), rtol=1e-5)
    for a, b in zip(outs[0][1], outs[1][1]):
        _close(a, b.numpy(), rtol=1e-5, atol=1e-6)


def test_amp_matches_jax_and_keeps_fp32_masters():
    _, params, jb, jloss, model, tb, _ = _pair()
    _, _, jm = _jax_run(jloss, joptim.adam(1e-2), params, jb, 3, amp=True)
    g = TrainGraph(loss_fn, optim.adam(1e-2), model, GraphConfig(amp=True))
    seen = []
    g.state["opt"].opt.register_step_pre_hook(
        lambda opt, *_: seen.extend(p.grad.dtype for p in opt.param_groups[0]["params"]))
    for want in jm:
        m = g(*tb)
        assert m["loss"].dtype == torch.bfloat16  # the loss ran in bf16, as JAX's
        _close(m["loss"], want["loss"].astype(jnp.float32), rtol=2e-2, atol=0)
    assert seen and all(d == torch.float32 for d in seen)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_grad_scaler_dynamics_match_jax():
    kw = dict(init_scale=8.0, growth_factor=2.0, backoff_factor=0.5, growth_interval=2)
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jstate, tstate = js.init(), ts.init()
    good, bad = np.ones(3, np.float32), np.array([1.0, np.inf, 0.0], np.float32)
    for g, finite in ((good, True), (good, True), (bad, False), (good, True)):
        jg, jstate, jok = js.unscale_and_update({"w": jnp.asarray(g)}, jstate)
        tg, tstate, tok = ts.unscale_and_update({"w": torch.from_numpy(g)}, tstate)
        assert bool(tok) == bool(jok) == finite
        assert float(tstate["scale"]) == float(jstate["scale"])
        assert int(tstate["growth_tracker"]) == int(jstate["growth_tracker"])
        np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    assert float(tstate["scale"]) == 8.0 and tstate["growth_tracker"].dtype == torch.int32
    st = amp.StaticGradScaler(4.0)
    g, _, ok = st.unscale_and_update([torch.full((2,), 8.0)], st.init())
    assert bool(ok) and torch.equal(g[0], torch.full((2,), 2.0))
    assert not bool(amp.all_finite({"a": torch.ones(2), "b": [torch.tensor([np.nan])]}))
    cast = amp.DEFAULT_POLICY.cast_to_compute({"x": torch.ones(2), "i": torch.ones(2).long()})
    assert cast["x"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int64


def test_nonfinite_step_is_skipped_with_optimizer_state_and_schedule():
    _, params, jb, jloss, model, tb, _ = _pair()

    def jexploding(p, xx, yy, f):  # f = inf overflows the grads
        return jloss(p, xx, yy) * f

    def exploding(m, xx, yy, f):
        return loss_fn(m, xx, yy) * f

    jsched, tsch = _sched_pair()
    init, jstep = jtrain_graph(jexploding, joptim.adam(jsched),
                               JGraphConfig(loss_scale=jamp.GradScaler(init_scale=4.0),
                                            clip_grad_norm=1.0), donate=False)
    g = TrainGraph(exploding, optim.adam(tsch), model,
                   GraphConfig(loss_scale=amp.GradScaler(init_scale=4.0), clip_grad_norm=1.0))
    jp, jstate = params, init(params)
    for explode in (False, True, False):
        f = np.float32(np.inf if explode else 1.0)
        jp, jstate, jm = jstep(jp, jstate, *jb, jnp.asarray(f))
        before = {k: v.clone() for k, v in unnest(g.state_dict()).items()
                  if isinstance(v, torch.Tensor)}
        lr_before = g.state["opt"].opt.param_groups[0]["lr"]
        m = g(*tb, torch.tensor(f))
        assert bool(m["did_step"]) == bool(jm["did_step"]) == (not explode)
        if explode:
            after = unnest(g.state_dict())
            for k, v in before.items():
                if k.startswith(("params", "state.opt")):
                    assert torch.equal(after[k], v), k  # params, moments, step counter
            assert g.state["opt"].opt.param_groups[0]["lr"] == lr_before
            assert g.state["opt"].opt.param_groups[0]["step_count"] == 1
            assert float(g.state["scaler"]["scale"]) == 2.0  # backed off
        else:
            _close(m["loss"], jm["loss"])
        assert float(g.state["scaler"]["scale"]) == float(jstate["scaler"]["scale"])
    _same_params(model, jp)
    assert int(jstate["opt"]["step"]) == int(g.state_dict()["state"]["opt"]["step"]) == 2


def test_zero1_on_a_shard_mesh_matches_stage0_and_jax(mesh8):
    sizes = (8, 64, 8)
    _, params, jb, jloss, model, tb, _ = _pair(n=16, sizes=sizes)
    cfg = dict(zero_stage=1, zero_min_size=64)
    with mesh8:
        init, step = jtrain_graph(jloss, joptim.adam(1e-3), JGraphConfig(**cfg), mesh=mesh8,
                                  dp_axis="x", donate=False)
        jp, jstate = params, init(params)
        for _ in range(2):
            jp, jstate, _ = step(jp, jstate, *jb)
    jsharded = {k for k, v in unnest({"m": jstate["opt"]["m"]}).items()
                if not v.sharding.is_fully_replicated}
    assert jsharded == {"m.layer_0.w", "m.layer_0.b", "m.layer_2.w"}
    ref = MLP(sizes)
    ref.load_state_dict(model.state_dict())
    g0 = TrainGraph(loss_fn, optim.adam(1e-3), ref)
    g1 = TrainGraph(loss_fn, optim.adam(1e-3), model, GraphConfig(**cfg),
                    mesh=ShardMesh(["cpu"] * 8), dp_axis="x")
    for _ in range(2):
        _close(g1(*tb)["loss"], g0(*tb)["loss"].numpy(), rtol=1e-6, atol=0)
    tree = unnest(g1.state_dict()["state"]["opt"])
    sharded = {k for k, v in tree.items() if isinstance(v, GlobalTensor)}
    assert sharded == jsharded | {k.replace("m.", "v.") for k in jsharded}
    assert tree["m.layer_0.w"].local.shape == (8, 1, 64)  # each of 8 shards holds 1 row
    for (k, p), p0 in zip(model.named_parameters(), ref.parameters()):
        _close(p, p0.detach().numpy(), rtol=1e-6, atol=1e-7)
    _same_params(model, jp)
    for k, v in unnest(jax.tree.map(np.asarray, jstate["opt"]["m"])).items():
        got = tree[f"m.{k}"]
        _close(got.full() if isinstance(got, GlobalTensor) else got, v)


def test_eval_graph_amp_returns_float32():
    _, params, jb, _, model, tb, _ = _pair()
    jmodel = jnn.Sequential(jnn.Linear(4, 16), jnn.relu, jnn.Linear(16, 2))
    want = JEvalGraph(lambda p, xx: jmodel.apply(p, xx), JGraphConfig(amp=True))(params, jb[0])
    out = EvalGraph(lambda m, xx: m(xx), GraphConfig(amp=True))(model, tb[0])
    assert out.dtype == torch.float32 and not out.requires_grad
    _close(out, want, rtol=2e-2, atol=2e-2)
    out32 = EvalGraph(lambda m, xx: m(xx))(model, tb[0])
    _close(out, out32.numpy(), rtol=0, atol=0.1)


def test_checkpoint_resume_is_identical(tmp_path):
    batches = [(torch.from_numpy(np.random.default_rng(i).standard_normal((8, 4)).astype(
        np.float32)), torch.from_numpy(np.random.default_rng(10 + i).integers(0, 2, 8)))
        for i in range(6)]
    _, _, _, _, model, _, _ = _pair()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = GraphConfig(loss_scale=amp.GradScaler(init_scale=2.0 ** 10, growth_interval=2))
    _, tsch = _sched_pair()
    g = TrainGraph(loss_fn, optim.adam(tsch), model, cfg)
    for b in batches[:3]:
        g(*b)
    path = str(tmp_path / "g.npz")
    g.save(path)
    for b in batches[3:]:
        g(*b)
    model2 = MLP()
    model2.load_state_dict(start)
    g2 = TrainGraph(loss_fn, optim.adam(tsch), model2, cfg)
    g2.load(path)
    assert g2.step_count == 3 and g2.state["opt"].opt.param_groups[0]["step_count"] == 3
    for b in batches[3:]:
        g2(*b)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    assert float(g.state["scaler"]["scale"]) == float(g2.state["scaler"]["scale"])


def test_checkpoint_files_cross_packages(tmp_path):
    """A JAX TrainGraph's file loads into the port's graph and the two
    continue in step; the port's file loads into the JAX graph."""
    _, params, jb, jloss, model, tb, _ = _pair()
    jg = JTrainGraph(jloss, joptim.adam(1e-2), params)
    for _ in range(2):
        jg(*jb)
    jpath = str(tmp_path / "jax.npz")
    jg.save(jpath)
    g = TrainGraph(loss_fn, optim.adam(1e-2), model)
    g.load(jpath)
    assert g.step_count == 2
    for _ in range(3):
        _close(g(*tb)["loss"], jg(*jb)["loss"])
    _same_params(model, jg.params)
    tpath = str(tmp_path / "port.npz")
    g.save(tpath)
    _, params2, _, _, _, _, _ = _pair(seed=1)
    jg2 = JTrainGraph(jloss, joptim.adam(1e-2), params2)
    jg2.load(tpath)
    assert jg2.step_count == 5
    _same_params(model, jg2.params, rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(jg2.state["opt"]["m"]), jax.tree.leaves(jg.state["opt"]["m"])):
        _close(np.asarray(a), b)


def test_interop_carries_a_jax_train_state_with_its_scaler():
    _, params, jb, jloss, model, tb, _ = _pair()
    jsched, tsch = _sched_pair()
    kw = dict(init_scale=2.0 ** 10, growth_interval=2)
    jg = JTrainGraph(jloss, joptim.adam(jsched), params,
                     JGraphConfig(loss_scale=jamp.GradScaler(**kw), clip_grad_norm=1.0))
    for _ in range(3):
        jg(*jb)
    g = TrainGraph(loss_fn, optim.adam(tsch), model,
                   GraphConfig(loss_scale=amp.GradScaler(**kw), clip_grad_norm=1.0))
    g.load_state_dict(train_state_from_numpy(jax.tree.map(np.asarray, jg.state_dict()),
                                             identity_params_from_numpy))
    assert g.step_count == 3 and float(g.state["scaler"]["scale"]) == 2.0 ** 11
    for _ in range(3):
        want = jg(*jb)
        got = g(*tb)
        _close(got["loss"], want["loss"])
        _close(got["grad_norm"], want["grad_norm"])
    _same_params(model, jg.params)
    assert float(g.state["scaler"]["scale"]) == float(jg.state["scaler"]["scale"])


def test_generic_checkpoint_trees_cross_packages(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"b": [rng.standard_normal(3).astype(np.float32), (np.arange(4, dtype=np.int32),)],
            "a": {"z": rng.standard_normal((2, 2)).astype(np.float32), "n": None},
            "s": np.int32(7)}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, jax.tree.map(jnp.asarray, tree))
    like = jax.tree.map(lambda a: torch.zeros(np.shape(a), dtype=torch.from_numpy(
        np.asarray(a)).dtype), tree)
    got = tckpt.load_checkpoint(jpath, like)
    tckpt.save_checkpoint(tpath, got)
    back = jckpt.load_checkpoint(tpath, jax.tree.map(jnp.asarray, tree))
    for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(got, is_leaf=torch.is_tensor),
                       jax.tree.leaves(back)):
        np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(np.asarray(c), a)
    with open(tpath, "rb") as f:
        assert np.load(f, allow_pickle=False)["manifest"].item() == \
            np.load(jpath, allow_pickle=False)["manifest"].item()
    with pytest.raises(ValueError, match="checkpoint structure mismatch"):
        tckpt.load_checkpoint(jpath, {"a": {"z": torch.zeros(2, 2)}})


def test_save_and_load_sharded_in_one_process(tmp_path):
    mesh = ShardMesh(["cpu"] * 4)
    _, _, _, _, model, tb, _ = _pair(sizes=(4, 16, 4))
    g = TrainGraph(loss_fn, optim.adam(1e-2), model, GraphConfig(zero_stage=1, zero_min_size=16),
                   mesh=mesh)
    g(*tb)
    sd = g.state_dict()
    tckpt.save_sharded(str(tmp_path / "ck"), sd)
    like = jax.tree.map(lambda v: GlobalTensor(torch.zeros_like(v.local), v.sbp, v.mesh)
                        if isinstance(v, GlobalTensor) else torch.zeros_like(v), sd,
                        is_leaf=lambda v: isinstance(v, (torch.Tensor, GlobalTensor)))
    back = tckpt.load_sharded(str(tmp_path / "ck"), like)
    flat, got = unnest(sd), unnest(back)
    assert isinstance(got["state.opt.m.layer_0.w"], GlobalTensor)
    for k, v in flat.items():
        want = v.full() if isinstance(v, GlobalTensor) else v
        have = got[k].full() if isinstance(got[k], GlobalTensor) else got[k]
        assert torch.equal(have, want), k


def test_debug_pass_print_matches_jax(monkeypatch, capsys, mesh8):
    monkeypatch.setenv("OFS_DEBUG_PASS", "1")
    for cfg in (dict(amp=True, clip_grad_norm=5.0), dict(grad_accumulation_steps=2,
                                                         zero_stage=1, checkpoint_activations=True)):
        jtrain_graph(lambda p: p, joptim.sgd(0.1), JGraphConfig(**cfg), mesh=mesh8)
        want = capsys.readouterr().err
        train_graph(loss_fn, optim.sgd(0.1), GraphConfig(**cfg), mesh=ShardMesh(["cpu"] * 8))
        got = capsys.readouterr().err
        assert got == want and got.startswith("[ofs graph passes] on=")
