"""Training on the port against the JAX package, on the CPU.

- the edge-list ops (gather, segment_sum, spmv, sddmm, spmm_coo,
  segment_softmax): values and grads against ``jax.vjp`` of the JAX
  functions, with out-of-range indices and an empty segment;
- ``GCN.loss_fn``: the loss, every parameter grad and dX against
  ``jax.value_and_grad(GCN.loss_fn)`` with ``impl="xla"``, weights
  carried over, on cora (binned, relabeled) and a small power-law graph
  (tiered, cold tier), with and without a mask;
- the grad of ``spmm`` on a non-symmetric relabeled operator;
- the warmup + cosine schedule step by step (and the LambdaLR offset), one
  clip + Adam update on fixed gradients, and three training steps against
  JAX's ``TrainGraph``;
- dropout in train mode, and ``loss_fn`` running without it as JAX's does;
- the example under ``--amp`` (TrainGraph, bf16) against JAX's TrainGraph
  with AMP at rtol 2e-2; the BERT example's loss and loop (2 layers,
  width 32, vocabulary 64, seq 16) against the JAX example's loss and
  TrainGraph on the same weights, then with AMP and grad accumulation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu import optim as joptim
from of_spmm_tpu.graph import GraphConfig as JTrainConfig
from of_spmm_tpu.graph import TrainGraph
from of_spmm_tpu.models.gcn import GCN as JGCN
from of_spmm_tpu.ops import autograd as jag
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch.data.graphs import load_graph, random_features
from of_spmm_tpu_torch.examples import train_bert, train_gcn
from of_spmm_tpu_torch.interop import gcn_params_from_numpy
from of_spmm_tpu_torch.models import GCN
from of_spmm_tpu_torch.ops import autograd as ag
from of_spmm_tpu_torch.ops import make_operator, spmm
from of_spmm_tpu_torch.optim.lr_scheduler import cosine_annealing, lambda_lr, warmup
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.sparse.tiled import TieredEll
from tests.conftest import ATOL, RTOL
from tests.test_torch_gcn import _cora, _powerlaw

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _vjp_both(torch_fn, jax_fn, args, ct, diff):
    """Values and the vjp of ``ct`` against both packages' functions;
    ``diff`` names the positions of the differentiable arguments."""
    targs = [_t(a).requires_grad_() if i in diff else _t(a) for i, a in enumerate(args)]
    out = torch_fn(*targs)
    grads = torch.autograd.grad(out, [targs[i] for i in diff], _t(ct))
    jargs = [jnp.asarray(a) for a in args]

    def f(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        return jax_fn(*full)

    jout, vjp = jax.vjp(f, *[jargs[i] for i in diff])
    jgrads = vjp(jnp.asarray(ct))
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


def _edge_case():
    """A small non-symmetric matrix (an empty row: an empty segment) in both
    packages' operators."""
    rng = np.random.default_rng(31)
    d = ((rng.random((12, 9)) < 0.3) * rng.standard_normal((12, 9))).astype(np.float32)
    d[4] = 0.0
    return (make_operator(CSR.from_dense(d), layout="tiered", device="cpu"),
            jag.make_operator(JCSR.from_dense(d), layout="tiered", place=False), rng)


def test_gather_segment_sum_pair_matches_jax():
    rng = np.random.default_rng(30)
    params = rng.standard_normal((10, 4)).astype(np.float32)
    idx = np.array([3, -1, 9, 10, 0, 3, 15, 7], np.int32)  # out of range both ways
    _vjp_both(ag.gather, jag.gather, (params, idx),
              rng.standard_normal((8, 4)).astype(np.float32), diff=(0,))
    data = rng.standard_normal((9, 3)).astype(np.float32)
    ids = np.array([0, 2, 2, -1, 5, 8, 0, 6, 2], np.int32)  # 8 dropped, segments 1, 3, 4, 7 empty
    _vjp_both(lambda a, b: ag.segment_sum(a, b, 8), lambda a, b: jag.segment_sum(a, b, 8),
              (data, ids), rng.standard_normal((8, 3)).astype(np.float32), diff=(0,))


def test_edge_list_ops_match_jax():
    op, jop, rng = _edge_case()
    n, m = op.shape
    x = rng.standard_normal(m).astype(np.float32)
    _vjp_both(lambda v: ag.spmv(op, v), lambda v: jag.spmv(jop, v), (x,),
              rng.standard_normal(n).astype(np.float32), diff=(0,))
    lhs = rng.standard_normal((n, 5)).astype(np.float32)
    rhs = rng.standard_normal((m, 5)).astype(np.float32)
    e = int(op.coo_rows.shape[0])
    _vjp_both(lambda a, b: ag.sddmm(op, a, b), lambda a, b: jag.sddmm(jop, a, b), (lhs, rhs),
              rng.standard_normal(e).astype(np.float32), diff=(0, 1))
    rows = np.r_[np.asarray(jop.coo_rows), [n, 2]].astype(np.int32)  # row n dropped
    cols = np.r_[np.asarray(jop.coo_cols), [0, -1]].astype(np.int32)  # col -1 reads zeros
    vals = rng.standard_normal(e + 2).astype(np.float32)
    xm = rng.standard_normal((m, 6)).astype(np.float32)
    _vjp_both(lambda r, c, v, a: ag.spmm_coo(r, c, v, a, n),
              lambda r, c, v, a: jag.spmm_coo(r, c, v, a, n), (rows, cols, vals, xm),
              rng.standard_normal((n, 6)).astype(np.float32), diff=(2, 3))
    scores = (3 * rng.standard_normal((e + 2, 4))).astype(np.float32)
    _vjp_both(lambda s, r: ag.segment_softmax(s, r, n),
              lambda s, r: jag.segment_softmax(s, r, n), (scores, rows),
              rng.standard_normal((e + 2, 4)).astype(np.float32), diff=(0,))
    # the empty row's segment: no edge, so nothing; the other rows sum to one
    alpha = ag.segment_softmax(_t(scores), _t(rows), n)
    sums = ag.segment_sum(alpha, _t(rows), n)
    _close(sums, np.broadcast_to(np.isin(np.arange(n), rows)[:, None], (n, 4)).astype(float),
           atol=1e-6)


def test_require_coo_quirk_of_the_reference():
    """keep_coo=False: the port raises ValueError on every layout; the JAX
    check reads ``op.binned.nnz_padded``, which only binned and tiered plans
    have, so on an engine layout it raises AttributeError (a reference
    quirk, ROADMAP.md Queue 3)."""
    d = np.eye(6, dtype=np.float32) + np.eye(6, k=2, dtype=np.float32)
    x = np.ones(6, np.float32)
    jop = jag.make_operator(JCSR.from_dense(d), layout="expansion", keep_coo=False, place=False)
    with pytest.raises(AttributeError, match="nnz_padded"):
        jag.spmv(jop, jnp.asarray(x))
    op = make_operator(CSR.from_dense(d), layout="expansion", keep_coo=False, device="cpu")
    with pytest.raises(ValueError, match="keep_coo=False"):
        ag.spmv(op, _t(x))


@functools.lru_cache(maxsize=None)
def _gcn_operators(case):
    a_hat, ja_hat, x, dims, tier_size = _cora() if case == "cora" else _powerlaw()
    op = make_operator(a_hat, tier_size=tier_size, device="cpu")
    jop = jag.make_operator(ja_hat, tier_size=tier_size, place=False)
    if case == "cora":
        assert op.relabeled and not isinstance(op.binned, TieredEll)
    else:
        assert isinstance(op.binned, TieredEll) and op.binned.tiers[0].tier == -1
    return op, jop, x, dims


def _gcn_pair(case):
    """Both packages' operators and GCNs, the port's carrying the JAX
    weights."""
    op, jop, x, dims = _gcn_operators(case)
    jmodel = JGCN(feature_dims=dims)
    params = jmodel.init(jax.random.key(0))
    model = GCN(dims, device="cpu")
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    return op, jop, model, jmodel, params, x, dims


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["cora", "powerlaw_tiered"])
def test_gcn_loss_and_grads_match_jax(case, masked):
    op, jop, model, jmodel, params, x, dims = _gcn_pair(case)
    rng = np.random.default_rng(9)
    y = rng.integers(0, dims[-1], x.shape[0]).astype(np.int32)
    mask = rng.random(x.shape[0]) < 0.3 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    # jit: eager JAX dispatches the tiered oracle op by op (seconds a call)
    (jloss, (jg, jdx)) = jax.jit(jax.value_and_grad(jmodel.loss_fn, argnums=(0, 2)),
                                 static_argnames="impl")(
        params, jop, jnp.asarray(x), jnp.asarray(y), jmask, impl="xla")
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the kernels' plain versions
        model.zero_grad()
        xt = _t(x).requires_grad_()
        loss = model.loss_fn(op, xt, _t(y), None if mask is None else _t(mask), impl=impl)
        loss.backward()
        _close(loss, jloss)
        _close(xt.grad, jdx)
        for i, layer in enumerate(model.layers):
            _close(layer.w.grad, jg[f"layer_{i}"]["w"])
            _close(layer.b.grad, jg[f"layer_{i}"]["b"])


def test_spmm_grad_on_non_symmetric_relabeled_operator_matches_jax():
    rng = np.random.default_rng(12)
    d = ((rng.random((80, 80)) < 0.08) * rng.standard_normal((80, 80))).astype(np.float32)
    d[3] = rng.standard_normal(80)  # a heavy row: split across buckets
    op = make_operator(CSR.from_dense(d), layout="binned", device="cpu")
    jop = jag.make_operator(JCSR.from_dense(d), layout="binned", place=False)
    assert op.relabeled and not op.transpose_aliased
    x = rng.standard_normal((80, 6)).astype(np.float32)
    w = rng.standard_normal((80, 6)).astype(np.float32)
    jdx = jax.jit(jax.grad(lambda o, v: jnp.sum(jag.spmm(o, v, impl="xla") * jnp.asarray(w)),
                           argnums=1))(jop, jnp.asarray(x))
    for impl in ("torch", "cuda"):
        xt = _t(x).requires_grad_()
        (spmm(op, xt, impl=impl) * _t(w)).sum().backward()
        _close(xt.grad, jdx)


def test_schedule_matches_jax_step_by_step():
    jsched = joptim.lr_scheduler.warmup(joptim.lr_scheduler.cosine_annealing(1e-2, t_max=100), 10)
    sched = warmup(cosine_annealing(1e-2, t_max=100), 10)
    want = [float(jsched(jnp.asarray(k, jnp.int32))) for k in range(1, 31)]
    np.testing.assert_allclose([sched(k) for k in range(1, 31)], want, rtol=1e-6)
    # the k-th optimizer step under lambda_lr takes schedule(k): LambdaLR
    # evaluates its factor at k - 1
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=1e-2)
    lr_sched = lambda_lr(opt, sched, 1e-2)
    seen = []
    for _ in range(30):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(1)
        opt.step()
        lr_sched.step()
    np.testing.assert_allclose(seen, want, rtol=1e-6)
    assert seen[0] == pytest.approx(1e-3) and seen[0] != pytest.approx(want[1])


def test_clip_and_adam_update_match_jax():
    rng = np.random.default_rng(14)
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (4 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    jsched = joptim.lr_scheduler.warmup(joptim.lr_scheduler.cosine_annealing(1e-2, t_max=100), 10)
    jopt = joptim.adam(lr=jsched)
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jp)
    for _ in range(2):  # two updates: the second sees Adam's moments
        jgc, _ = joptim.clip_grad_norm(jax.tree.map(jnp.asarray, grads), 5.0)
        jp, state = jopt.update(jgc, state, jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    model = torch.nn.Module()
    for k, v in tp.items():
        model.register_parameter(k, v)
    opt, sched = train_gcn.make_optimizer(model, 1e-2, 100)
    for _ in range(2):
        for k in tp:
            tp[k].grad = _t(grads[k].copy())
        torch.nn.utils.clip_grad_norm_(model.parameters(), train_gcn.CLIP_NORM)
        opt.step()
        sched.step()
    for k in tp:
        _close(tp[k], jp[k], rtol=1e-5, atol=1e-7)


def test_three_training_steps_match_jax_train_graph():
    op, jop, model, jmodel, params, x, dims = _gcn_pair("cora")
    _, cfg = load_graph("cora", symmetrize=True)
    _, y = random_features(cfg)
    lr, epochs = 1e-2, 3
    jsched = joptim.lr_scheduler.warmup(
        joptim.lr_scheduler.cosine_annealing(lr, t_max=epochs), train_gcn.WARMUP_STEPS)
    graph = TrainGraph(lambda p, xx, yy: jmodel.loss_fn(p, jop, xx, yy, impl="xla"),
                       joptim.adam(lr=jsched), params,
                       config=JTrainConfig(clip_grad_norm=train_gcn.CLIP_NORM))
    jlosses = [float(graph(jnp.asarray(x), jnp.asarray(y))["loss"]) for _ in range(epochs)]
    losses = train_gcn.train(model, op, _t(x), _t(y).long(), epochs, lr)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-4)
    assert jlosses[2] < jlosses[0]


def test_dropout_train_mode_and_loss_fn_ignores_it():
    op, _, _, _, params, x, dims = _gcn_pair("cora")
    model = GCN(dims, device="cpu", dropout=0.5)
    model.load_state_dict(gcn_params_from_numpy(jax.tree.map(np.asarray, params)))
    xt = _t(x)
    with torch.no_grad():
        a = model(op, xt, train=True, generator=torch.Generator().manual_seed(3))
        b = model(op, xt, train=True, generator=torch.Generator().manual_seed(3))
        c = model(op, xt, train=True, generator=torch.Generator().manual_seed(4))
        plain = model(op, xt)
        assert torch.equal(a, b) and not torch.allclose(a, c)
        assert not torch.allclose(a, plain)
        # the hidden layer after dropout: kept entries scaled by 1 / keep
        h = torch.relu(ag.spmm_internal(op, op.to_internal(xt)) @ model.layers[0].w
                       + model.layers[0].b)
        hd = model.drop(h, train=True, generator=torch.Generator().manual_seed(5))
        kept = hd != 0
        _close(hd[kept], (h[kept] * 2.0).numpy(), rtol=1e-6, atol=0)
        assert 0.4 < float(kept[h != 0].float().mean()) < 0.6
    with pytest.raises(ValueError, match="generator"):
        model(op, xt, train=True)
    y = _t(np.zeros(x.shape[0], np.int64))
    _close(model.loss_fn(op, xt, y),
           torch.nn.functional.cross_entropy(model(op, xt), y).detach(), rtol=1e-6, atol=0)


def test_example_refuses_amp():
    """--amp is ported: the example's ``train(..., amp=True)`` (TrainGraph,
    bf16 compute on float32 masters) on cora for 3 epochs against the JAX
    example's TrainGraph with ``GraphConfig(amp=True, clip_grad_norm=5.0)``
    at rtol 2e-2 (bf16), and ``main(["--amp", ...])`` runs."""
    op, jop, model, jmodel, params, x, dims = _gcn_pair("cora")
    _, cfg = load_graph("cora", symmetrize=True)
    _, y = random_features(cfg)
    lr, epochs = 1e-2, 3
    jsched = joptim.lr_scheduler.warmup(
        joptim.lr_scheduler.cosine_annealing(lr, t_max=epochs), train_gcn.WARMUP_STEPS)
    graph = TrainGraph(lambda p, xx, yy: jmodel.loss_fn(p, jop, xx, yy, impl="xla"),
                       joptim.adam(lr=jsched), params,
                       config=JTrainConfig(amp=True, clip_grad_norm=train_gcn.CLIP_NORM))
    jlosses = [float(graph(jnp.asarray(x), jnp.asarray(y))["loss"]) for _ in range(epochs)]
    losses = train_gcn.train(model, op, _t(x), _t(y).long(), epochs, lr, impl="cuda", amp=True)
    assert losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert train_gcn.main(["--amp", "--device", "cpu", "--epochs", "2"]) == 0


def _bert_pair(vocab=64, seq=16, width=32, layers=2):
    """The JAX encoder (seeded) and the port's example model carrying its
    weights: 2 layers, width 32, 4 heads, MLP 64."""
    from of_spmm_tpu.models import TransformerEncoder as JEncoder
    from of_spmm_tpu_torch.interop import transformer_params_from_numpy

    jmodel = JEncoder(vocab_size=vocab, max_len=seq, embed_dim=width, num_heads=4,
                      num_layers=layers, mlp_dim=2 * width)
    params = jmodel.init(jax.random.key(0))
    model = train_bert.make_model(vocab, seq, width, 4, layers, 2 * width, device="cpu")
    model.load_state_dict(transformer_params_from_numpy(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def test_bert_example_matches_jax_loss_and_train_graph():
    """train_bert's loss and loop (fp32, 3 steps) against the JAX example's
    loss and TrainGraph (adamw, warmup-cosine) on the same weights and
    batches; then --amp and --grad-acc 2 give finite losses, and main runs."""
    from of_spmm_tpu import nn as jnn
    steps, batch, seq, vocab = 3, 4, 16, 64
    jmodel, params, model = _bert_pair(vocab, seq)
    stream = train_bert.batch_stream(batch, seq, vocab, "cpu")
    batches = [next(stream) for _ in range(steps)]

    def jloss(p, inputs, targets, mask):
        h = jmodel.apply(p, inputs)
        logits = (h @ p["tok"]["weight"].T) / np.sqrt(128)
        nll = jnn.losses.cross_entropy(logits.reshape(-1, vocab), targets.reshape(-1),
                                       reduction="none")
        m = mask.reshape(-1).astype(nll.dtype)
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)

    jb = [tuple(jnp.asarray(t.numpy().astype(np.int32) if t.dtype != torch.bool else t.numpy())
                for t in b) for b in batches]
    _close(train_bert.mlm_loss(model, *batches[0]), jloss(params, *jb[0]))
    sched = joptim.lr_scheduler.warmup(joptim.lr_scheduler.cosine_annealing(1e-3, t_max=3), 1)
    jg = TrainGraph(jloss, joptim.adamw(sched, weight_decay=0.01), params, config=JTrainConfig())
    jlosses = [float(jg(*b)["loss"]) for b in jb]
    got = train_bert.train(train_bert.make_graph(model, steps, lr=1e-3), iter(batches), steps)
    np.testing.assert_allclose(got, jlosses, rtol=RTOL)
    for kw in (dict(amp=True), dict(grad_acc=2)):
        _, _, m = _bert_pair(vocab, seq)
        out = train_bert.train(train_bert.make_graph(m, steps, lr=1e-3, **kw), iter(batches),
                               steps)
        assert np.isfinite(out).all()
        if kw.get("amp"):  # grad_acc's first loss is the mean of two half-batch means
            np.testing.assert_allclose(out[0], jlosses[0], rtol=2e-2)
    assert train_bert.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                            "--vocab", "64", "--amp", "--grad-acc", "2"]) == 0


def test_registry_matches_jax():
    """The same op names and sharding rules as the JAX registry, impls
    keyed "torch" / "cuda" (spgemm: "host", as in the JAX registry), and
    each op's "torch" impl against its oracle."""
    from of_spmm_tpu.ops import registry as jreg
    from of_spmm_tpu_torch.ops import registry as reg

    assert reg.all_ops() == jreg.all_ops()
    for name in reg.all_ops():
        op, jop = reg.lookup(name), jreg.lookup(name)
        assert [(r.ins, r.outs) for r in op.sharding_rules] == \
            [(r.ins, r.outs) for r in jop.sharding_rules]
        if name == "spgemm":  # a host op: "auto" finds no impl, as in the JAX registry
            assert set(op.impls) == set(jop.impls) == {"host"}
            with pytest.raises(KeyError, match="no impl"):
                op.impl("auto")
            continue
        assert set(op.impls) <= {"torch", "cuda"} and "torch" in op.impls
        assert op.impl("auto") is op.impls["torch"]  # no card here
    with pytest.raises(KeyError, match="no impl"):
        reg.lookup("gather").impl("cuda")
    with pytest.raises(KeyError, match="unknown op"):
        reg.lookup("spgemm_device")
    params = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([2, -1, 0, 4])
    assert torch.equal(reg.lookup("gather").impl()(params, idx),
                       reg.lookup("gather").oracle(params, idx))
    op, _, rng = _edge_case()
    x = _t(rng.standard_normal((op.shape[1], 3)).astype(np.float32))
    spmm_op = reg.lookup("spmm")
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain versions
        _close(spmm_op.impl(impl)(op.binned, x), ag.spmm_internal(op, x))
