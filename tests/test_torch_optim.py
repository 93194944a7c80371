"""The port's optim/ and nn/losses.py against the JAX package, on the CPU.

- each of the eight optimizers for 5 steps on a two-leaf tree ({"w",
  "b"}) with the same seeded grads: constant lr and a schedule, with and
  without weight decay, momentum / nesterov / centred where the rule has
  them; then the JAX state after 3 steps carried into the port
  (``interop.optimizer_state_from_numpy`` + ``load_state_tree``) and 2
  more steps in both;
- ``clip_grad_norm`` (clipped and not), the five schedules added here at
  steps 1-12;
- ``indexed_slices``: ``dense``, ``reduce_ids`` with duplicates and
  sentinel slots, the sparse SGD and lazy Adam updates, a sentinel slot
  dropped by the update, ``sparse_value_and_grad``, ``sparse_lookup``'s
  dense backward;
- the six losses at each reduction, ``cross_entropy``'s negative labels
  with ``ignore_index=None`` and its ``ignore_index`` mean, an unknown
  reduction;
- ``parallel.ddp_train_step`` with the ported ``sgd`` and ``adam`` against
  the JAX ``ddp_train_step`` on 8 shards.

rtol 1e-4 / atol 1e-5 throughout (tests/conftest.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from of_spmm_tpu import nn as jnn
from of_spmm_tpu import optim as joptim
from of_spmm_tpu.nn import losses as jlosses
from of_spmm_tpu.optim import indexed_slices as jis
from of_spmm_tpu.parallel import ddp as jddp
from of_spmm_tpu_torch import optim, parallel as par
from of_spmm_tpu_torch.interop import identity_params_from_numpy, optimizer_state_from_numpy
from of_spmm_tpu_torch.nn import Linear
from of_spmm_tpu_torch.nn import losses
from of_spmm_tpu_torch.optim import indexed_slices as tis
from of_spmm_tpu_torch.optim import lr_scheduler as tsched
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

NAMES = ("w", "b")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _schedules(lr):
    """(JAX, port) warmup(cosine_annealing(lr, 10), 3)."""
    return (joptim.lr_scheduler.warmup(joptim.lr_scheduler.cosine_annealing(lr, 10), 3),
            tsched.warmup(tsched.cosine_annealing(lr, 10), 3))


OPT_CASES = {
    "sgd": [dict(lr=0.1), dict(lr="sched", momentum=0.9),
            dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.01)],
    "adam": [dict(lr=1e-2), dict(lr="sched", weight_decay=0.01)],
    "adamw": [dict(lr=1e-2, weight_decay=0.01), dict(lr="sched", weight_decay=0.05)],
    "lamb": [dict(lr=1e-2), dict(lr="sched", weight_decay=0.01)],
    "ftrl": [dict(lr=0.1), dict(lr="sched", lambda1=0.01, lambda2=0.1, beta=0.5)],
    "rmsprop": [dict(lr=1e-2), dict(lr="sched", momentum=0.9, centered=True, weight_decay=0.01)],
    "adagrad": [dict(lr=1e-2), dict(lr="sched", weight_decay=0.01,
                                    initial_accumulator_value=0.1)],
    "adadelta": [dict(lr=1.0), dict(lr="sched", weight_decay=0.01)],
}
BASE_LR = {"sgd": 0.1, "adam": 1e-2, "adamw": 1e-2, "lamb": 1e-2, "ftrl": 0.1, "rmsprop": 1e-2,
           "adagrad": 1e-2, "adadelta": 1.0}


def _factories(name, kw):
    kw = dict(kw)
    if kw.get("lr") == "sched":
        jlr, tlr = _schedules(BASE_LR[name])
        return getattr(joptim, name)(**{**kw, "lr": jlr}), getattr(optim, name)(**{**kw, "lr": tlr})
    return getattr(joptim, name)(**kw), getattr(optim, name)(**kw)


def _port_state(jstate):
    """A JAX optimizer state as the port's lists in NAMES order."""
    tree = optimizer_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      identity_params_from_numpy)
    return {k: v if k == "step" else [v[n] for n in NAMES] for k, v in tree.items()}


@pytest.mark.parametrize("name,case", [(n, i) for n, cs in OPT_CASES.items()
                                       for i in range(len(cs))])
def test_optimizer_matches_jax(name, case):
    jopt, topt = _factories(name, OPT_CASES[name][case])
    params = {"w": _normal((5, 3), 0), "b": _normal((3,), 1)}
    grads = [{"w": _normal((5, 3), 10 + s, 2.0), "b": _normal((3,), 20 + s, 2.0)}
             for s in range(5)]
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    mid = None
    for s, g in enumerate(grads):
        jp, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        if s == 2:
            mid = (jax.tree.map(np.asarray, jp), jstate)
    # the port from scratch
    tp = [torch.nn.Parameter(torch.from_numpy(params[n].copy())) for n in NAMES]
    opt = topt.init(tp)
    for g in grads:
        topt.update([torch.from_numpy(g[n]) for n in NAMES], opt)
    for n, p in zip(NAMES, tp):
        _close(p, jp[n])
    tree = topt.state_tree(opt)
    want = _port_state(jstate)
    assert int(tree["step"]) == int(want["step"]) == 5 and set(tree) == set(want)
    for k in tree:
        if k != "step":
            for got, ref in zip(tree[k], want[k]):
                _close(got, ref)
    # the JAX state after 3 steps carried across, then 2 more steps
    tp = [torch.nn.Parameter(torch.from_numpy(mid[0][n].copy())) for n in NAMES]
    opt = topt.init(tp)
    topt.load_state_tree(opt, _port_state(mid[1]))
    for g in grads[3:]:
        topt.update([torch.from_numpy(g[n]) for n in NAMES], opt)
    for n, p in zip(NAMES, tp):
        _close(p, jp[n])


def test_clip_grad_norm_matches_jax():
    for scale in (5.0, 0.01):  # clipped, then under the bound
        g = {"w": _normal((4, 3), 3, scale), "b": _normal((3,), 4, scale)}
        jg, jn = joptim.clip_grad_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = optim.clip_grad_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        assert tn.dtype == torch.float32
        _close(tn, jn)
        for k in g:
            _close(tg[k], jg[k])


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("step_lr", (0.1, 3, 0.5)), ("multistep_lr", (0.1, (2, 5, 9), 0.3)),
    ("exponential_lr", (0.1, 0.8)), ("polynomial_lr", (0.1, 8, 0.01, 2.0))])
def test_schedule_matches_jax(name, args):
    js, ts = getattr(joptim.lr_scheduler, name)(*args), getattr(tsched, name)(*args)
    want = [float(js(jnp.asarray(k, jnp.int32))) for k in range(1, 13)]
    np.testing.assert_allclose([ts(k) for k in range(1, 13)], want, rtol=1e-6)


# -- indexed slices -------------------------------------------------------------

def _slices(ids, vals, n):
    return (jis.IndexedSlices(indices=jnp.asarray(ids), values=jnp.asarray(vals), n_rows=n),
            tis.IndexedSlices(indices=torch.from_numpy(np.asarray(ids)),
                              values=torch.from_numpy(vals), n_rows=n))


def test_indexed_slices_dense_and_reduce_ids_match_jax():
    ids = np.array([4, 2, 4, 2, 4, 0], np.int32)
    jg, tg = _slices(ids, _normal((6, 3), 5), 6)
    assert tg.shape == (6, 3)
    _close(tg.dense(), jg.dense())
    jr, tr = jis.reduce_ids(jg), tis.reduce_ids(tg)
    # the same static length: three ids, then the sentinel 6 with zero values
    assert tr.indices.tolist() == np.asarray(jr.indices).tolist() == [0, 2, 4, 6, 6, 6]
    _close(tr.values, jr.values)
    _close(tr.dense(), tg.dense())


def test_sparse_sgd_update_matches_jax():
    p = _normal((8, 4), 6)
    jg, tg = _slices(np.array([0, 5, 0], np.int32), _normal((3, 4), 7), 8)
    _close(tis.sparse_sgd_update(torch.from_numpy(p), tg, 0.1),
           jis.sparse_sgd_update(jnp.asarray(p), jg, 0.1))


def test_sparse_adam_update_is_lazy_and_matches_jax():
    n, d = 10, 4
    p, m = _normal((n, d), 8), _normal((n, d), 9, 0.01)
    v = np.abs(_normal((n, d), 10, 0.01))
    jg, tg = _slices(np.array([2, 7, 2, 9], np.int32), _normal((4, d), 11), n)
    for step in (1, 4):
        want = jis.sparse_adam_update(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
                                      jnp.asarray(step, jnp.int32), jg, lr=0.01)
        got = tis.sparse_adam_update(torch.from_numpy(p), torch.from_numpy(m),
                                     torch.from_numpy(v), step, tg, lr=0.01)
        for a, b in zip(got, want):
            _close(a, b)
        untouched = [i for i in range(n) if i not in (2, 7, 9)]
        for a, b in zip(got, (p, m, v)):  # rows, and moments, left undecayed
            assert torch.equal(a[untouched], torch.from_numpy(b[untouched]))


def test_sparse_update_drops_the_sentinel_slot():
    """A reduced gradient (sentinel slots at n_rows) applied directly: JAX
    drops them on scatter, the port drops them before index_add."""
    p = _normal((5, 2), 12)
    jg, tg = _slices(np.array([1, 1, 3], np.int32), _normal((3, 2), 13), 5)
    jr, tr = jis.reduce_ids(jg), tis.reduce_ids(tg)
    assert int(tr.indices[-1]) == 5
    _close(tis.sparse_sgd_update(torch.from_numpy(p), tr, 0.5),
           jis.sparse_sgd_update(jnp.asarray(p), jr, 0.5))


def test_sparse_value_and_grad_and_lookup_match_jax():
    n, d = 50, 8
    w = _normal((n, d), 14)
    ids = np.random.default_rng(15).integers(0, n, (4, 4)).astype(np.int32)
    tgt = _normal((16, d), 16)

    def jloss(rows, t):
        return jnp.mean((rows - t) ** 2)

    jl, jgs = jis.sparse_value_and_grad(jloss)(jnp.asarray(w), jnp.asarray(ids),
                                               jnp.asarray(tgt))
    tl, tgs = tis.sparse_value_and_grad(lambda r, t: ((r - t) ** 2).mean())(
        torch.from_numpy(w), torch.from_numpy(ids), torch.from_numpy(tgt))
    assert isinstance(tgs, tis.IndexedSlices) and tgs.values.shape == (16, d)
    _close(tl, jl)
    _close(tgs.values, jgs.values)
    _close(tgs.dense(), jgs.dense())
    # sparse_lookup: a row gather whose backward is the dense segment sum
    # (1-D ids: the JAX backward reshapes the cotangent only for those)
    flat = ids.reshape(-1)
    wt = torch.from_numpy(w).requires_grad_()
    rows = tis.sparse_lookup(wt, torch.from_numpy(flat))
    ct = _normal((16, d), 17)
    (rows * torch.from_numpy(ct)).sum().backward()
    jrows, vjp = jax.vjp(lambda ww: jis.sparse_lookup(ww, jnp.asarray(flat)), jnp.asarray(w))
    _close(rows, jrows)
    _close(wt.grad, vjp(jnp.asarray(ct))[0])


# -- losses ---------------------------------------------------------------------

def _loss_args(name):
    logits = _normal((6, 5), 18, 3.0)
    if name == "cross_entropy":
        return logits, np.array([0, 4, 2, 2, 1, 3], np.int32)
    if name == "nll_loss":
        return np.asarray(jax.nn.log_softmax(logits)), np.array([1, 0, 4, 3, 3, 2], np.int32)
    if name == "bce_with_logits":
        return logits, (np.random.default_rng(19).random((6, 5)) < 0.5).astype(np.float32)
    return logits, _normal((6, 5), 20, 2.0)


def _as_torch(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if a.dtype == np.int32 else t


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("name", ["cross_entropy", "nll_loss", "mse_loss", "l1_loss",
                                  "smooth_l1_loss", "bce_with_logits"])
def test_loss_matches_jax(name, reduction):
    a, b = _loss_args(name)
    want = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b), reduction=reduction)
    _close(getattr(losses, name)(_as_torch(a), _as_torch(b), reduction=reduction), want)


def test_cross_entropy_negative_labels_and_ignore_index():
    """ignore_index=None: a negative label is class 0 and counted, as in
    JAX (F.cross_entropy would ignore -100); with ignore_index it is
    masked out of the mean."""
    logits = _normal((5, 4), 21, 2.0)
    for kw, labels in (({}, np.array([-100, 2, -1, 3, 1], np.int32)),
                       ({"ignore_index": -100}, np.array([-100, 2, 0, 3, -100], np.int32))):
        for reduction in ("mean", "none", "sum"):
            want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                         reduction=reduction, **kw)
            _close(losses.cross_entropy(torch.from_numpy(logits), _as_torch(labels),
                                        reduction=reduction, **kw), want)
    labels = np.array([-100, 2, -1, 3, 1], np.int32)
    as_zero = labels.copy()
    as_zero[labels < 0] = 0
    _close(losses.cross_entropy(torch.from_numpy(logits), _as_torch(labels)),
           jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(as_zero)))
    with pytest.raises(ValueError, match="unknown reduction"):
        losses.mse_loss(torch.zeros(2), torch.zeros(2), reduction="avg")


# -- data parallelism with the ported optimizers --------------------------------

@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_ddp_train_step_with_ported_optimizer_matches_jax(name):
    jm = Mesh(np.asarray(jax.devices()[:8]), ("x",))
    pm = par.ShardMesh(["cpu"] * 8)
    jmodel = jnn.Linear(8, 4)
    params = jmodel.init(jax.random.key(0))
    x, y = _normal((32, 8), 22), _normal((32, 4), 23)
    jopt, topt = (joptim.sgd(lr=0.1), optim.sgd(lr=0.1)) if name == "sgd" else \
        (joptim.adam(lr=1e-2), optim.adam(lr=1e-2))

    def jloss(p, xx, yy):
        return jnp.mean((jmodel.apply(p, xx) - yy) ** 2)

    dp = jddp.broadcast_params(params, jm)
    jstep = jddp.ddp_train_step(jloss, jopt, jm, axis="x", donate=False)
    state = jopt.init(dp)
    model = Linear(8, 4, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    step = par.ddp_train_step(lambda xx, yy: ((model(xx) - yy) ** 2).mean(),
                              topt.init(model.parameters()), pm, axis="x")
    for _ in range(2):
        jl, dp, state = jstep(dp, state, jnp.asarray(x), jnp.asarray(y))
        _close(step(torch.from_numpy(x), torch.from_numpy(y)), jl)
    for k, v in model.named_parameters():
        _close(v, dp[k])
    assert not math.isnan(float(jl))
