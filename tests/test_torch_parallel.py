"""The port's parallel strategies (one-process form) against the JAX
package's, and its errors module against the JAX package's.

The port runs S shards on ``ShardMesh(["cpu"] * S, shape, axis_names)``;
the JAX package runs ``shard_map`` over the conftest's virtual CPU
devices on a mesh of the same shape and names (jitted). The same weights
(JAX's init, carried over with ``interop``) and the same seeded numpy
inputs; outputs and gradients within rtol 1e-4 / atol 1e-5: tensor
parallelism on 8 shards and (4, 2) dp x tp, Ulysses on 8 and 4, the ring
on 2 / 4 / 8, MoE routing, dense, sharded on 2 and 4 and its grads, GPipe
and 1F1B on 4 stages and on (4, 2) stage x data, the global view's S / B
/ P transitions on 8 and (2, 4), DDP's SGD step, auto_sharding's costs
and choices, and the error hierarchy.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from of_spmm_tpu import nn as jnn
from of_spmm_tpu import optim as joptim
from of_spmm_tpu.nn.attention import MultiheadAttention as JMHA
from of_spmm_tpu.parallel import auto_sharding as jauto
from of_spmm_tpu.parallel import ddp as jddp
from of_spmm_tpu.parallel import ep as jep
from of_spmm_tpu.parallel import global_view as jgv
from of_spmm_tpu.parallel import pipeline as jpipe
from of_spmm_tpu.parallel import ring as jring
from of_spmm_tpu.parallel import sp as jsp
from of_spmm_tpu.parallel import tp as jtp
from of_spmm_tpu.ops.registry import lookup as jlookup
from of_spmm_tpu.utils import errors as jerrors
from of_spmm_tpu_torch import parallel as par
from of_spmm_tpu_torch.interop import (
    mha_params_from_numpy, moe_params_from_numpy, stage_params_from_numpy,
    tp_mlp_params_from_numpy)
from of_spmm_tpu_torch.nn import Linear
from of_spmm_tpu_torch.ops.registry import lookup
from of_spmm_tpu_torch.parallel import auto_sharding, pipeline
from of_spmm_tpu_torch.utils import errors
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _meshes(shape, names):
    """(JAX mesh, port ShardMesh) of one shape and axis names."""
    n = math.prod(shape)
    jm = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
    return jm, par.ShardMesh(["cpu"] * n, shape=shape, axis_names=names)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(tree):
    """numpy leaves -> torch tensors that require grad."""
    return {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in tree.items()}


def test_mesh_axes_checks():
    m = par.ShardMesh(["cpu"] * 8, shape=(2, 4), axis_names=("a", "b"))
    assert m.axis_size("b") == 4 and m.local_coords()[5] == (1, 1)
    assert par.ShardMesh(["cpu"] * 3).axis_names == ("x",)
    for shape, names in (((2, 2), ("a", "b")), ((8,), ("a", "b")), ((2, 4), None),
                         ((2, 4), ("a", "a"))):
        with pytest.raises(ValueError):
            par.ShardMesh(["cpu"] * 8, shape=shape, axis_names=names)
    with pytest.raises(ValueError, match="not 'c'"):
        m.axis("c")
    with pytest.raises(ValueError, match="one device"):
        par.to_global(torch.zeros(4), "S0", par.ShardMesh(["cpu", "meta"]))


# -- tensor parallelism -------------------------------------------------------

TP_MESHES = {"tp8": ((8,), ("tp",), None), "dp4_tp2": ((4, 2), ("dp", "tp"), "dp")}


@pytest.mark.parametrize("case", list(TP_MESHES))
def test_tp_mlp_forward_and_grads_match_jax(case):
    shape, names, dp = TP_MESHES[case]
    jm, pm = _meshes(shape, names)
    params = jtp.init_tp_mlp(jax.random.key(2), 32, 64)
    x = _normal((16, 32), 3)
    fwd = jtp.make_tp_mlp(jm, dp_axis=dp)
    jsh = jtp.shard_tp_mlp(params, jm)
    want = fwd(jsh, jnp.asarray(x))
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(fwd(p, jnp.asarray(x)) ** 2)))(jsh)

    p = _t(tp_mlp_params_from_numpy(_np(params)))
    got = par.make_tp_mlp(pm, dp_axis=dp)(par.shard_tp_mlp(p, pm), torch.from_numpy(x))
    _close(got, want)
    (got ** 2).sum().backward()
    for k in p:
        _close(p[k].grad, jgrads[k])


def test_tp_indivisible_hidden_raises_as_jax():
    jm, pm = _meshes((8,), ("tp",))
    params = jtp.init_tp_mlp(jax.random.key(6), 16, 20)
    with pytest.raises(ValueError, match="not divisible") as want:
        jtp.shard_tp_mlp(params, jm)
    with pytest.raises(ValueError, match="not divisible") as got:
        par.shard_tp_mlp(tp_mlp_params_from_numpy(_np(params)), pm)
    assert str(got.value) == str(want.value)


# -- sequence and ring attention ----------------------------------------------

def _attention_case(cls, jcls, name, n, E, H, B, T, causal, grads):
    jm, pm = _meshes((n,), (name,))
    params = JMHA(E, H).init(jax.random.key(0))
    x = _normal((B, T, E), 1)
    japply = jcls(E, H).make_sharded_apply(jm, name, is_causal=causal)
    mod = cls(E, H, device="cpu")
    mod.load_state_dict(mha_params_from_numpy(_np(params)))
    got = mod.make_sharded_apply(pm, name, is_causal=causal)(torch.from_numpy(x))
    _close(got, japply(params, jnp.asarray(x)))
    if grads:
        jg = jax.jit(jax.grad(lambda p: jnp.sum(japply(p, jnp.asarray(x)) ** 2)))(params)
        (got ** 2).sum().backward()
        for k, p in mod.named_parameters():
            _close(p.grad, jg[k])


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal):
    _attention_case(par.SequenceParallelAttention, jsp.SequenceParallelAttention, "sp", 8,
                    32, 8, 2, 64, causal, grads=False)


def test_ulysses_grads_match_jax():
    _attention_case(par.SequenceParallelAttention, jsp.SequenceParallelAttention, "sp", 4,
                    16, 4, 2, 32, False, grads=True)


def test_ulysses_head_divisibility_shape_error():
    jm, pm = _meshes((8,), ("sp",))
    with pytest.raises(Exception, match="must divide") as want:
        jsp.SequenceParallelAttention(32, 4).make_sharded_apply(jm)(
            JMHA(32, 4).init(jax.random.key(0)), jnp.zeros((1, 16, 32)))
    mod = par.SequenceParallelAttention(32, 4, device="cpu")
    with pytest.raises(errors.ShapeError, match="must divide") as got:
        mod.make_sharded_apply(pm)(torch.zeros((1, 16, 32)))
    assert str(got.value) in str(want.value)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_jax(n, causal):
    _attention_case(par.RingAttention, jring.RingAttention, "ring", n, 32, 4, 2, 64, causal,
                    grads=False)


def test_ring_grads_match_jax():
    _attention_case(par.RingAttention, jring.RingAttention, "ring", 4, 16, 4, 1, 32, True,
                    grads=True)


def test_ring_fully_masked_rows_stay_finite():
    """Causal, shard 0's queries see nothing of the later blocks: the
    guard keeps exp(-inf + inf) out of them."""
    _, pm = _meshes((4,), ("ring",))
    ax = pm.axis("ring")
    q = torch.from_numpy(_normal((4, 1, 2, 4, 8), 5))
    o = par.ring_attention(q, q, q, axis=ax, is_causal=True)
    assert torch.isfinite(o).all()
    ref = torch.softmax(torch.full((1, 1), 1.0), -1)  # row 0 sees only itself
    _close(o[0, :, :, 0], q[0, :, :, 0] * ref)


# -- expert parallelism --------------------------------------------------------

def test_top_k_dispatch_matches_jax_and_invariants():
    T, E, C, K = 64, 8, 12, 2
    probs = np.asarray(jax.nn.softmax(jax.random.normal(jax.random.key(0), (T, E)), axis=-1))
    jd, jc, jaux = jax.jit(jep.top_k_dispatch, static_argnums=(1, 2))(jnp.asarray(probs), K, C)
    d, c, aux = par.top_k_dispatch(torch.tensor(probs), K, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _close(c, jc)
    _close(aux, jaux)
    assert d.sum((1, 2)).max() <= K and d.sum(0).max() <= 1 and d.sum((0, 2)).max() <= C
    assert (c[d == 0] == 0).all() and (c.sum((1, 2)) <= 1 + 1e-5).all()


def _moe(D, E, F, K, cf, key=0):
    layer = jep.MoELayer(D, E, F, top_k=K, capacity_factor=cf)
    params = layer.init(jax.random.key(key))
    mod = par.MoELayer(D, E, F, top_k=K, capacity_factor=cf, device="cpu")
    mod.load_state_dict(moe_params_from_numpy(_np(params)))
    return layer, params, mod


def test_dense_moe_matches_jax():
    layer, params, mod = _moe(8, 4, 16, 2, 4.0)
    x = _normal((16, 8), 1)
    y, aux = mod.apply(torch.from_numpy(x), return_aux=True)
    jy, jaux = jax.jit(lambda p, xx: layer.apply(p, xx, return_aux=True))(params,
                                                                          jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)
    with pytest.raises(errors.ShapeError, match="moe input"):
        mod.apply(torch.zeros((2, 3, 8)))


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_moe_matches_jax(p):
    layer, params, mod = _moe(8, 8, 16, 2, 1.5)
    jm, pm = _meshes((p,), ("ep",))
    x = _normal((8 * p, 8), 1)
    jy, jaux = layer.make_sharded_apply(jm, return_aux=True)(
        layer.shard_params(params, jm), jnp.asarray(x))
    y, aux = mod.make_sharded_apply(pm, return_aux=True)(torch.from_numpy(x),
                                                         mod.shard_params(pm))
    _close(y, jy)
    _close(aux, jaux)


def test_sharded_moe_grads_match_jax():
    p = 4
    layer, params, mod = _moe(8, 8, 16, 2, 2.0)
    jm, pm = _meshes((p,), ("ep",))
    x = _normal((4 * p, 8), 1)
    fn = layer.make_sharded_apply(jm)
    jg = jax.jit(jax.grad(lambda prm: jnp.sum(fn(prm, jnp.asarray(x)) ** 2)))(
        layer.shard_params(params, jm))
    (mod.make_sharded_apply(pm)(torch.from_numpy(x)) ** 2).sum().backward()
    for k, prm in mod.named_parameters():
        _close(prm.grad, jg[k])
    with pytest.raises(ValueError, match="not divisible"):
        par.MoELayer(8, 6, 16, device="cpu").make_sharded_apply(pm)


@pytest.mark.parametrize("args", [(64, 8, 2, 1.0), (64, 8, 2, 1.25), (1, 64, 1, 1.0),
                                  (4096 // 4, 8, 2, 1.25)])
def test_capacity_rule_as_jax(args):
    assert par.expert_capacity(*args) == jep.expert_capacity(*args)


# -- pipeline -----------------------------------------------------------------

S, B, F, N_MICRO = 4, 6, 16, 8


def _jstage(p, x):
    return jax.nn.relu(x @ p["w"] + p["b"])


def _stage(p, x):
    return torch.relu(x @ p["w"] + p["b"])


def _pipe_case(key):
    keys = jax.random.split(jax.random.key(key), S)
    stacked = jpipe.stack_stage_params([jnn.Linear(F, F).init(k) for k in keys])
    x = _normal((N_MICRO, B, F), key + 1)
    tgt = _normal((N_MICRO, B, F), key + 2)
    return stacked, x, tgt


PIPE_MESHES = {"stage4": ((4,), ("stage",)), "stage4_data2": ((4, 2), ("stage", "data"))}


@pytest.mark.parametrize("case", list(PIPE_MESHES))
def test_gpipe_forward_and_grads_match_jax(case):
    jm, pm = _meshes(*PIPE_MESHES[case])
    stacked, x, tgt = _pipe_case(2)

    @jax.jit
    def jrun(st):
        def loss(st):
            y = jpipe.pipeline_apply(_jstage, st, jnp.asarray(x), jm, axis="stage")
            return jnp.mean((y - jnp.asarray(tgt)) ** 2), y
        return jax.value_and_grad(loss, has_aux=True)(st)

    (_, jy), jg = jrun(stacked)
    st = _t(stage_params_from_numpy(_np(stacked)))
    y = par.pipeline_apply(_stage, st, torch.from_numpy(x), pm, axis="stage")
    _close(y, jy)
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
    for k in st:
        _close(st[k].grad, jg[k])


def test_pipeline_module_matches_jax():
    jm, pm = _meshes((4,), ("stage",))
    jpm = jpipe.PipelineModule(stages=tuple(jnn.Linear(F, F) for _ in range(S)))
    stacked = jpm.init(jax.random.key(5))
    x = _normal((N_MICRO, B, F), 6)
    want = jax.jit(lambda st, xx: jpm.apply(st, xx, jm))(stacked, jnp.asarray(x))
    mod = par.PipelineModule([Linear(F, F, device="cpu") for _ in range(S)])
    _close(mod.apply(stage_params_from_numpy(_np(stacked)), torch.from_numpy(x), pm), want)
    # forward() stacks the module's own stages, differentiably
    y = mod(torch.from_numpy(x), pm)
    y.sum().backward()
    assert all(p.grad is not None for p in mod.parameters())


def _mse(y, t):
    return ((y - t) ** 2).mean()


@pytest.mark.parametrize("case", list(PIPE_MESHES))
def test_1f1b_loss_and_grads_match_jax(case):
    jm, pm = _meshes(*PIPE_MESHES[case])
    stacked, x, tgt = _pipe_case(0)
    jloss, jg = jax.jit(lambda st: jpipe.pipeline_train_step_1f1b(
        _jstage, lambda y, t: jnp.mean((y - t) ** 2), st, jnp.asarray(x), jnp.asarray(tgt), jm,
        axis="stage"))(stacked)
    loss, g = par.pipeline_train_step_1f1b(
        _stage, _mse, stage_params_from_numpy(_np(stacked)), torch.from_numpy(x),
        torch.from_numpy(tgt), pm, axis="stage")
    _close(loss, jloss)
    for k in g:
        _close(g[k], jg[k])


@pytest.mark.parametrize("S_,M_", [(2, 3), (4, 8), (4, 4), (8, 16)])
def test_1f1b_schedule_invariants_and_jax_schedule(S_, M_):
    """Each micro-batch is forwarded, then backwarded, once per stage, in
    order, stage s after s - 1 forward and before it backward, and at
    most 2(S - 1 - s) + 1 are in flight at stage s; the slots equal JAX's."""
    cycles = M_ + 2 * (S_ - 1)
    fwd, bwd = {}, {}
    for s in range(S_):
        f_seen, b_seen, inflight = [], [], 0
        for c in range(cycles):
            f, b = pipeline._fwd_mb(c, s, S_), pipeline._bwd_mb(c, s, S_)
            assert f == int(jpipe._fwd_mb(jnp.int32(c), jnp.int32(s), S_))
            assert b == int(jpipe._bwd_mb(jnp.int32(c), jnp.int32(s), S_))
            if 0 <= f < M_:
                f_seen.append((c, f))
            if 0 <= b < M_:
                b_seen.append((c, b))
            inflight = max(inflight, len(f_seen) - len(b_seen))
        assert [m for _, m in f_seen] == list(range(M_))
        assert [m for _, m in b_seen] == list(range(M_))
        assert inflight <= 2 * (S_ - 1 - s) + 1
        fwd[s], bwd[s] = {m: c for c, m in f_seen}, {m: c for c, m in b_seen}
    for s in range(1, S_):
        for m in range(M_):
            assert fwd[s][m] > fwd[s - 1][m] and bwd[s - 1][m] > bwd[s][m]
    assert all(bwd[s][m] >= fwd[S_ - 1][m] for s in range(S_) for m in range(M_))


def test_1f1b_stash_is_static_in_the_number_of_stages(monkeypatch):
    """The stash is (L, 2 * n_stages, ...) whatever the micro-batch count."""
    shapes = []
    real = pipeline.new_stash

    def recording(n_local, n_stages, like):
        out = real(n_local, n_stages, like)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(pipeline, "new_stash", recording)
    _, pm = _meshes((4,), ("stage",))
    st = {"w": torch.zeros((S, F, F)), "b": torch.zeros((S, F))}
    for m in (4, 16):
        x = torch.zeros((m, B, F))
        par.pipeline_train_step_1f1b(_stage, _mse, st, x, x, pm, axis="stage")
    assert shapes == [(S, 2 * S, B, F)] * 2


# -- global view ---------------------------------------------------------------

ATOMS = ["S0", "S1", "B", "P"]


def _host(shape=(8, 16)):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


@pytest.mark.parametrize("src", ATOMS)
def test_comb_1d(src):
    _, pm = _meshes((8,), ("x",))
    x = torch.from_numpy(_host())
    g = par.to_global(x, src, pm)
    assert par.sbp_of(g, pm) == (src,)
    for dst in ATOMS:
        r = par.reshard(g, dst)
        assert par.sbp_of(r, pm) == (dst,) and r.shape == (8, 16)
        assert torch.equal(r.full(), x), f"{src}->{dst}"


@pytest.mark.parametrize("src", list(itertools.product(ATOMS, ATOMS)))
def test_comb_2d(src):
    _, pm = _meshes((2, 4), ("a", "b"))
    x = torch.from_numpy(_host())
    g = par.to_global(x, src, pm)
    for dst in itertools.product(ATOMS, ATOMS):
        r = par.reshard(g, dst)
        assert par.sbp_of(r, pm) == dst
        assert torch.equal(r.full(), x), f"{src}->{dst}"


@pytest.mark.parametrize("sbp", [("S0", "S1"), ("S1", "S0"), ("S0", "S0"), ("B", "S1"),
                                 ("B", "B")])
def test_sbp_to_spec_and_placement_match_jax(sbp):
    jm, pm = _meshes((2, 4), ("a", "b"))
    assert par.sbp_to_spec(sbp, pm, 2) == tuple(jgv.sbp_to_spec(sbp, jm, 2))
    x = _host()
    jshards = jgv.to_local(jgv.to_global(x, sbp, jm))
    for got, want in zip(par.to_local(par.to_global(torch.from_numpy(x), sbp, pm)), jshards):
        np.testing.assert_array_equal(got.numpy(), want)


def test_global_view_errors_as_jax():
    jm, pm = _meshes((8,), ("x",))
    for bad in ("Q", "S", ("B", "B")):
        with pytest.raises(ValueError) as want:
            jgv.sbp_to_spec(bad, jm, 2)
        with pytest.raises(ValueError) as got:
            par.sbp_to_spec(bad, pm, 2)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not a storable") as got:
        par.sbp_to_spec("P", pm, 2)
    with pytest.raises(ValueError, match="pad first"):
        par.to_global(torch.zeros((6, 2)), "S0", pm)
    padded = par.pad_to_multiple(torch.ones((6, 2)), 0, 8)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jgv.pad_to_multiple(np.ones((6, 2)), 0, 8)))
    assert par.to_global(padded, "S0", pm).local.shape == (8, 1, 2)


def test_to_local_shard_shapes():
    _, pm = _meshes((8,), ("x",))
    x = _host()
    shards = par.to_local(par.to_global(torch.from_numpy(x), "S0", pm))
    assert len(shards) == 8 and all(s.shape == (1, 16) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)


def test_partial_sum_round_trip_matches_jax():
    """P -> B (materialize_partial, an all-reduce) and P -> S0 (a
    reduce-scatter) of every shard's replica, as the JAX tests' psum and
    psum_scatter bodies."""
    from jax.sharding import PartitionSpec as P
    jm, pm = _meshes((8,), ("x",))
    x = _host()
    want_b = jax.jit(jax.shard_map(lambda s: jax.lax.psum(s, "x"), mesh=jm, in_specs=P("x"),
                                   out_specs=P()))(jnp.asarray(x))
    want_s = jax.jit(jax.shard_map(
        lambda s: jax.lax.psum_scatter(s, "x", scatter_dimension=0, tiled=True), mesh=jm,
        in_specs=P(None, None), out_specs=P("x")))(jnp.asarray(x))
    blocks = par.to_global(torch.from_numpy(x), "S0", pm).local
    b = par.materialize_partial(blocks, pm.axis("x"))
    _close(b[0], want_b)
    assert torch.equal(b[0], b[7])
    # every shard holding a replica of x is P of 8 x
    p = par.GlobalTensor(par.to_global(torch.from_numpy(x), "B", pm).local, ("P",), pm)
    _close(par.reshard(p, "S0").full(), want_s)
    _close(p.full(), want_s)


# -- data parallelism -----------------------------------------------------------

def test_ddp_step_matches_jax():
    jm, pm = _meshes((8,), ("x",))
    jmodel = jnn.Linear(8, 4)
    params = jmodel.init(jax.random.key(0))
    x, y = _normal((32, 8), 0), _normal((32, 4), 1)

    def jloss(p, xx, yy):
        return jnp.mean((jmodel.apply(p, xx) - yy) ** 2)

    opt = joptim.sgd(lr=0.1)
    dp = jddp.broadcast_params(params, jm)
    jl, jp, _ = jddp.ddp_train_step(jloss, opt, jm, axis="x", donate=False)(
        dp, opt.init(dp), jnp.asarray(x), jnp.asarray(y))

    model = Linear(8, 4, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    rep = par.broadcast_params(dict(model.named_parameters()), pm)
    assert all(par.sbp_of(g, pm) == ("B",) for g in rep.values())
    step = par.ddp_train_step(lambda xx, yy: ((model(xx) - yy) ** 2).mean(),
                              torch.optim.SGD(model.parameters(), lr=0.1), pm, axis="x")
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    _close(loss, jl)
    for k, v in model.named_parameters():
        _close(v, jp[k])


def test_allreduce_gradients_in_a_body():
    from jax.sharding import PartitionSpec as P
    jm, pm = _meshes((8,), ("x",))
    grads = {"w": np.arange(8.0, dtype=np.float32).reshape(8, 1)}
    want = jax.shard_map(lambda g: jddp.allreduce_gradients(g, "x"), mesh=jm,
                         in_specs=({"w": P("x")},), out_specs={"w": P("x")})(grads)
    local = par.to_global({"w": torch.from_numpy(grads["w"])}, "S0", pm)
    got = par.allreduce_gradients({"w": local["w"].local}, pm.axis("x"))
    _close(got["w"].reshape(8, 1), want["w"])
    summed = par.allreduce_gradients({"w": local["w"].local}, pm.axis("x"), mean=False)
    assert torch.equal(summed["w"].reshape(8), torch.full((8,), 28.0))


# -- auto-sharding ----------------------------------------------------------------

def _same_placement(got, want):
    assert got.op == want.op and got.in_atoms == want.in_atoms
    assert got.out_atoms == want.out_atoms and got.rule.ins == want.rule.ins
    assert got.copy_cost == pytest.approx(want.copy_cost) and got.per_input == pytest.approx(
        want.per_input)


@pytest.mark.parametrize("src,dst", list(itertools.product(["S0", "S1", "B", "P"], repeat=2)))
def test_costs_match_jax(src, dst):
    for p in (1, 4, 8):
        assert auto_sharding.direct_cost(src, dst, 1000.0, p) == jauto.direct_cost(
            src, dst, 1000.0, p)
        assert auto_sharding.boxing_cost(src, dst, 1000.0, p) == jauto.boxing_cost(
            src, dst, 1000.0, p)


CHOICES = [("gather", ("B", "S0"), (1e6, 1e3), 8), ("spmm", ("S0", "P"), (4e7, 1e6), 8),
           ("spmm", ("S0", "P"), (1e5, 8e6), 8), ("segment_sum", ("P", "S0"), (1e4, 1e2), 4),
           ("spmv", ("B", "B"), (1e6, 1e3), 4)]


@pytest.mark.parametrize("op,atoms,nbytes,p", CHOICES)
def test_choose_signature_matches_jax(op, atoms, nbytes, p):
    _same_placement(auto_sharding.choose_signature(lookup(op), atoms, nbytes, p),
                    jauto.choose_signature(jlookup(op), atoms, nbytes, p))


def test_plan_chain_matches_jax():
    steps = [("gather", ("S0",), (1e3,), 2e6), ("segment_sum", ("S0",), (1e3,), 2e6)]
    got, total = auto_sharding.plan_chain([auto_sharding.ChainStep(*s) for s in steps], "B",
                                          1e6, p=8)
    want, jtotal = jauto.plan_chain([jauto.ChainStep(*s) for s in steps], "B", 1e6, p=8)
    assert total == jtotal == 0.0
    for g, w in zip(got, want):
        _same_placement(g, w)
    with pytest.raises(ValueError):
        auto_sharding.choose_signature(lookup("gather"), ("B",), (1.0,), p=4)


# -- errors ----------------------------------------------------------------------

ERRORS = ["OfSpmmError", "ShapeError", "PlacementError", "ConfigError", "PlanError",
          "CapacityError"]


@pytest.mark.parametrize("name", ERRORS)
def test_error_classes_relate_as_jax(name):
    mine, theirs = getattr(errors, name), getattr(jerrors, name)
    for base in (ValueError, RuntimeError, Exception):
        assert issubclass(mine, base) == issubclass(theirs, base)
    for other in ERRORS:
        assert issubclass(mine, getattr(errors, other)) == issubclass(
            theirs, getattr(jerrors, other))


def test_checks_and_error_frames_as_jax():
    for mod in (errors, jerrors):
        with pytest.raises(mod.ShapeError, match="bad dims"):
            mod.check_shape(False, "bad dims")
        with pytest.raises(mod.PlacementError, match="bad sbp"):
            mod.check_placement(False, "bad sbp")
        with pytest.raises(mod.ConfigError):
            mod.check(False, "x", mod.ConfigError)
        mod.check(True, "never")
    notes = []
    for mod in (errors, jerrors):
        with pytest.raises(KeyError) as e:
            with mod.error_frame("building the plan"):
                with mod.error_frame("binning rows"):
                    raise KeyError("k")
        notes.append(e.value.__notes__)
    assert notes[0] == notes[1] == ["  while binning rows", "  while building the plan"]
