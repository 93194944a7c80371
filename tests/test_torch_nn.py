"""The port's nn/ modules against the JAX package's, on the CPU: the same
seeded numpy inputs through the JAX module (parameters from its ``init``,
carried by interop) and the port's, forward and gradients (of the sum of
each output times a seeded cotangent, with respect to the parameters and
the inputs), at rtol 1e-4 / atol 1e-5.

- nn/layers.py: ``BatchNorm`` (features last; eval, and train with the
  running statistics updated in the buffers as JAX's ``new_state``),
  ``GroupNorm``, ``InstanceNorm2d`` and the activation aliases;
- nn/module.py: ``Sequential`` (a bare callable among the layers, train
  and BatchNorm state through it), ``param_count``, ``param_bytes``,
  ``is_stateful``;
- nn/conv.py and nn/volumetric.py: every convolution, pool and adaptive
  pool, ``PReLU``, ``GLU`` and the shrink family;
- nn/rnn.py: ``LSTM``, ``GRU``, ``RNN`` with and without an initial state;
- nn/extras.py: ``interpolate`` / ``Upsample``, the pads, pixel shuffle,
  ``Flatten``, distances, losses and activations;
- the reference's quirks the port keeps: bilinear ``scale_factor`` maps
  with In / Out (not ``F.interpolate``'s 1 / factor), the ``GroupNorm``
  message, ``AdaptiveAvgPool2d``'s ``NotImplementedError``, ``kl_div``
  without "batchmean".

Every JAX call is jitted.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from of_spmm_tpu import nn as jnn
from of_spmm_tpu.nn import extras as jextras
from of_spmm_tpu.nn import volumetric as jvol
from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.interop import (
    conv_params_from_numpy, identity_params_from_numpy, rnn_params_from_numpy,
    sequential_params_from_numpy)
from of_spmm_tpu_torch.nn import extras as oextras
from of_spmm_tpu_torch.nn import volumetric as ovol
from of_spmm_tpu_torch.utils.tree import unnest
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _flat(o)]
    return [out]


def compare(jfn, tfn, params, xs, module=None, seed=0, jit=True):
    """jfn(params, *xs) (JAX, jitted unless ``jit=False``) against
    tfn(*xs) (the port): every output, and the gradients of sum(out * cot)
    for seeded cotangents, with respect to the inputs and to ``module``'s
    parameters (named as the JAX parameter tree's dotted keys)."""
    rng = np.random.default_rng(seed)
    jxs = [jnp.asarray(x) for x in xs]
    shapes = jax.tree_util.tree_leaves(jax.eval_shape(jfn, params, *jxs) if jit
                                       else jfn(params, *jxs))
    cots = [rng.standard_normal(s.shape).astype(np.float32) for s in shapes]

    def run(p, c, *a):
        out, vjp = jax.vjp(jfn, p, *a)
        return out, vjp(jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(out), c))

    jout, jgrads = (jax.jit(run) if jit else run)(params, [jnp.asarray(c) for c in cots], *jxs)
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    if module is not None:
        module.zero_grad(set_to_none=True)
    tout = _flat(tfn(*txs))
    jleaves = jax.tree_util.tree_leaves(jout)
    assert len(tout) == len(jleaves)
    for got, want in zip(tout, jleaves):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots)).backward()
    for t, g in zip(txs, jgrads[1:]):
        _close(t.grad, g)
    if module is not None:
        want = unnest(jgrads[0])
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        for name, p in got.items():
            _close(p.grad, want[name])


def _port(cls, *args, **kw):
    """The port's module, on the CPU where it takes a device."""
    if "device" in inspect.signature(cls.__init__).parameters:
        kw["device"] = "cpu"
    return cls(*args, **kw)


def _perturbed(params, rng):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(a.shape).astype(np.float32), params)


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# (JAX module, port module, args, kwargs, input shape)
MODULE_CASES = {
    "conv2d_stride_pad": (jnn.Conv2d, onn.Conv2d, (3, 8, 3), dict(stride=2, padding=1),
                          (2, 3, 9, 11)),
    "conv2d_dilation_groups": (jnn.Conv2d, onn.Conv2d, (4, 6, (3, 2)),
                               dict(stride=(1, 2), padding=(2, 1), dilation=(2, 1), groups=2),
                               (2, 4, 10, 9)),
    "conv2d_no_bias": (jnn.Conv2d, onn.Conv2d, (3, 5, 1), dict(use_bias=False), (2, 3, 4, 5)),
    "conv1d": (jnn.Conv1d, onn.Conv1d, (4, 6, 3), dict(stride=2, padding=1, dilation=2,
                                                       groups=2), (2, 4, 17)),
    "conv_transpose2d_stride2": (jnn.ConvTranspose2d, onn.ConvTranspose2d, (4, 3, 4),
                                 dict(stride=2, padding=1), (2, 4, 5, 6)),
    "conv_transpose2d": (jnn.ConvTranspose2d, onn.ConvTranspose2d, (3, 2, (3, 2)),
                         dict(use_bias=False), (1, 3, 4, 4)),
    "conv3d": (jvol.Conv3d, onn.Conv3d, (3, 4, 3), dict(stride=(1, 2, 2), padding=1),
               (2, 3, 5, 6, 7)),
    "conv3d_groups": (jvol.Conv3d, onn.Conv3d, (4, 4, 2), dict(groups=2, dilation=2),
                      (1, 4, 5, 5, 5)),
    "conv_transpose1d": (jvol.ConvTranspose1d, onn.ConvTranspose1d, (3, 4, 3),
                         dict(stride=2, padding=1), (2, 3, 7)),
    "conv_transpose3d": (jvol.ConvTranspose3d, onn.ConvTranspose3d, (2, 3, 2), dict(stride=2),
                         (1, 2, 3, 4, 3)),
    "maxpool2d": (jnn.MaxPool2d, onn.MaxPool2d, (3,), dict(stride=2, padding=1), (2, 3, 9, 10)),
    "maxpool2d_default_stride": (jnn.MaxPool2d, onn.MaxPool2d, (2,), {}, (2, 3, 8, 7)),
    "maxpool2d_wide_padding": (jnn.MaxPool2d, onn.MaxPool2d, (3,), dict(stride=1, padding=2),
                               (1, 2, 5, 6)),
    "avgpool2d": (jnn.AvgPool2d, onn.AvgPool2d, (3,), dict(stride=2, padding=1), (2, 3, 9, 10)),
    "avgpool2d_wide_padding": (jnn.AvgPool2d, onn.AvgPool2d, ((2, 3),), dict(padding=(1, 2)),
                               (1, 2, 6, 7)),
    "adaptive_avgpool2d_1": (jnn.AdaptiveAvgPool2d, onn.AdaptiveAvgPool2d, (1,), {},
                             (2, 3, 5, 7)),
    "adaptive_avgpool2d_divides": (jnn.AdaptiveAvgPool2d, onn.AdaptiveAvgPool2d, ((2, 3),), {},
                                   (2, 3, 4, 9)),
    "adaptive_avgpool2d_identity": (jnn.AdaptiveAvgPool2d, onn.AdaptiveAvgPool2d, (6,), {},
                                    (1, 2, 6, 6)),
    "maxpool1d": (jvol.MaxPool1d, onn.MaxPool1d, (3,), dict(stride=2, padding=1), (2, 3, 11)),
    "maxpool3d": (jvol.MaxPool3d, onn.MaxPool3d, (2,), {}, (1, 2, 4, 6, 5)),
    "avgpool1d": (jvol.AvgPool1d, onn.AvgPool1d, (4,), dict(stride=3, padding=2), (2, 3, 11)),
    "avgpool3d": (jvol.AvgPool3d, onn.AvgPool3d, ((2, 3, 2),), dict(padding=(1, 1, 0)),
                  (1, 2, 4, 6, 5)),
    "adaptive_maxpool1d": (jvol.AdaptiveMaxPool1d, onn.AdaptiveMaxPool1d, (4,), {}, (2, 3, 10)),
    "adaptive_maxpool2d": (jvol.AdaptiveMaxPool2d, onn.AdaptiveMaxPool2d, ((3, 5),), {},
                           (2, 3, 7, 9)),
    "adaptive_maxpool3d": (jvol.AdaptiveMaxPool3d, onn.AdaptiveMaxPool3d, ((2, 3, 2),), {},
                           (1, 2, 5, 7, 3)),
    "adaptive_avgpool1d": (jvol.AdaptiveAvgPool1d, onn.AdaptiveAvgPool1d, (3,), {}, (2, 3, 8)),
    "adaptive_avgpool3d": (jvol.AdaptiveAvgPool3d, onn.AdaptiveAvgPool3d, ((3, 2, 4),), {},
                           (1, 2, 5, 5, 9)),
    "prelu_scalar": (jvol.PReLU, onn.PReLU, (), {}, (2, 3, 4, 5)),
    "prelu_channels": (jvol.PReLU, onn.PReLU, (3,), dict(init_value=0.1), (2, 3, 4, 5)),
    "glu": (jvol.GLU, onn.GLU, (), dict(axis=1), (2, 6, 3)),
    "groupnorm": (jnn.GroupNorm, onn.GroupNorm, (2, 6), {}, (2, 6, 4, 5)),
    "groupnorm_no_affine": (jnn.GroupNorm, onn.GroupNorm, (3, 6), dict(affine=False),
                            (2, 6, 7)),
    "instancenorm2d": (jnn.InstanceNorm2d, onn.InstanceNorm2d, (3,), {}, (2, 3, 5, 6)),
    "instancenorm2d_affine": (jnn.InstanceNorm2d, onn.InstanceNorm2d, (3,), dict(affine=True),
                              (2, 3, 5, 6)),
    "upsample_nearest_x2": (jextras.Upsample, onn.Upsample, (2,), {}, (2, 3, 4, 5)),
    "upsample_nearest_size": (jextras.Upsample, onn.Upsample, (), dict(size=(7, 3)),
                              (2, 3, 4, 5)),
    "upsample_bilinear_x2": (jextras.Upsample, onn.Upsample, (2,), dict(mode="bilinear"),
                             (2, 3, 4, 5)),
    "upsample_bilinear_align_corners": (jextras.Upsample, onn.Upsample, (),
                                        dict(size=(9, 4), mode="bilinear", align_corners=True),
                                        (2, 3, 4, 5)),
    "upsample_bilinear_one_row": (jextras.Upsample, onn.Upsample, (),
                                  dict(size=(1, 3), mode="bilinear", align_corners=True),
                                  (1, 2, 4, 5)),
    "upsample_bilinear_x1_5": (jextras.Upsample, onn.Upsample, (1.5,), dict(mode="bilinear"),
                               (2, 3, 5, 7)),
    "upsample_bilinear_x0_6": (jextras.Upsample, onn.Upsample, (0.6,), dict(mode="bilinear"),
                               (2, 3, 5, 7)),
    "zeropad2d": (jextras.ZeroPad2d, onn.ZeroPad2d, ((1, 2, 0, 3),), {}, (2, 3, 4, 5)),
    "reflectionpad2d": (jextras.ReflectionPad2d, onn.ReflectionPad2d, (2,), {}, (2, 3, 4, 5)),
    "replicationpad2d": (jextras.ReplicationPad2d, onn.ReplicationPad2d, ((0, 1, 2, 1),), {},
                         (2, 3, 4, 5)),
    "pixelshuffle": (jextras.PixelShuffle, onn.PixelShuffle, (2,), {}, (2, 8, 3, 4)),
    "flatten": (jextras.Flatten, onn.Flatten, (), {}, (2, 3, 4, 5)),
    "flatten_middle": (jextras.Flatten, onn.Flatten, (1, 2), {}, (2, 3, 4, 5)),
}
PERTURB = ("prelu", "groupnorm", "instancenorm")  # modules whose init is a constant
# JAX's AvgPool1d / AvgPool3d take float() of their window's size computed
# with jnp, which fails under jit: these run eagerly
EAGER = ("avgpool1d", "avgpool3d")


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_module_matches_jax(case):
    jcls, ocls, args, kw, shape = MODULE_CASES[case]
    jmod = jcls(*args, **kw)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.key(3)))
    if case.startswith(PERTURB):
        params = _perturbed(params, np.random.default_rng(4))
    tmod = _port(ocls, *args, **kw)
    tmod.load_state_dict(identity_params_from_numpy(params))
    assert onn.param_count(tmod) == onn.param_count(params)
    compare(lambda p, x: jmod.apply(p, x), tmod, params, [_x(shape)], module=tmod,
            jit=case not in EAGER)


def test_conv_params_from_numpy():
    conv = jnn.Conv2d(3, 4, 3)
    params = conv.init(jax.random.key(0))
    sd = conv_params_from_numpy(params, prefix="c.")
    assert list(sd) == ["c.w", "c.b"] and sd["c.w"].shape == (4, 3, 3, 3)
    with pytest.raises(KeyError, match="conv params"):
        conv_params_from_numpy({"w": params["w"], "bias": params["b"]})


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(8, 6), (4, 3, 5, 6)])
def test_batchnorm_matches_jax(shape, train):
    """Features on the last axis; under train the buffers become JAX's
    new_state (unbiased running variance, momentum 0.2)."""
    rng = np.random.default_rng(5)
    jbn = jnn.BatchNorm(6, momentum=0.2)
    params = _perturbed(jbn.init(jax.random.key(0)), rng)
    state = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    tbn = onn.BatchNorm(6, momentum=0.2, device="cpu")
    tbn.load_state_dict(identity_params_from_numpy({**params, **state}))
    x = _x(shape, scale=3.0) + 2.0
    if not train:
        compare(lambda p, xx: jbn.apply(p, xx, state=state), tbn, params, [x], module=tbn)
        return
    compare(lambda p, xx: jbn.apply(p, xx, state=state, train=True)[0],
            lambda xx: tbn(xx, train=True), params, [x], module=tbn)
    _, new = jax.jit(lambda p, xx: jbn.apply(p, xx, state=state, train=True))(params, x)
    _close(tbn.mean, new["mean"])
    _close(tbn.var, new["var"])


@pytest.mark.parametrize("name", ["relu", "silu", "sigmoid", "tanh", "softmax", "log_softmax",
                                  "leaky_relu", "elu", "gelu"])
def test_activation_aliases_match_jax(name):
    x = _x((4, 7), scale=3.0)
    compare(lambda p, xx: getattr(jnn, name)(xx), getattr(onn, name), {}, [x])


VOLUMETRIC_FUNCTIONS = {
    "hardshrink": {}, "softshrink": dict(lambd=0.3), "tanhshrink": {}, "softsign": {},
    "logsigmoid": {}, "threshold": dict(threshold_val=0.2, value=-1.5), "elu": dict(alpha=0.7),
    "leaky_relu": dict(negative_slope=0.2)}
EXTRAS_FUNCTIONS = {
    "hardsigmoid": {}, "hardswish": {}, "hardtanh": dict(min_val=-0.5, max_val=2.0), "mish": {},
    "softplus": dict(beta=2.0, threshold=3.0), "glu": dict(axis=0), "selu": {},
    "celu": dict(alpha=0.5)}


@pytest.mark.parametrize("name", sorted(VOLUMETRIC_FUNCTIONS) + sorted(EXTRAS_FUNCTIONS))
def test_functions_match_jax(name):
    jmod, omod, kw = ((jvol, ovol, VOLUMETRIC_FUNCTIONS[name]) if name in VOLUMETRIC_FUNCTIONS
                      else (jextras, oextras, EXTRAS_FUNCTIONS[name]))
    x = _x((6, 9), scale=4.0)
    compare(lambda p, xx: getattr(jmod, name)(xx, **kw), lambda xx: getattr(omod, name)(xx, **kw),
            {}, [x])


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("with_state", [False, True])
def test_recurrent_layers_match_jax(kind, with_state):
    """(ys, final state) over (T, B, I), with the weights carried by
    rnn_params_from_numpy; grads of the weights, the inputs and the
    initial state."""
    T, B, I, H = 6, 3, 5, 7
    jcls, ocls, kw = {"lstm": (jnn.LSTM, onn.LSTM, {}), "gru": (jnn.GRU, onn.GRU, {}),
                      "rnn_tanh": (jnn.RNN, onn.RNN, {}),
                      "rnn_relu": (jnn.RNN, onn.RNN, dict(nonlinearity="relu"))}[kind]
    jmod = jcls(I, H, **kw)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.key(6)))
    tmod = ocls(I, H, device="cpu", **kw)
    tmod.load_state_dict(rnn_params_from_numpy(params))
    xs = [_x((T, B, I))]
    if not with_state:
        compare(lambda p, x: jmod.apply(p, x), tmod, params, xs, module=tmod)
    elif kind == "lstm":
        compare(lambda p, x, h, c: jmod.apply(p, x, state=(h, c)),
                lambda x, h, c: tmod(x, (h, c)), params, xs + [_x((B, H), 2), _x((B, H), 3)],
                module=tmod)
    else:
        compare(lambda p, x, h: jmod.apply(p, x, state=h), lambda x, h: tmod(x, h), params,
                xs + [_x((B, H), 2)], module=tmod)


def test_rnn_params_from_numpy_wants_the_four_tensors():
    params = jnn.GRU(3, 4).init(jax.random.key(0))
    assert list(rnn_params_from_numpy(params)) == ["w_ih", "w_hh", "b_ih", "b_hh"]
    with pytest.raises(KeyError, match="RNN params"):
        rnn_params_from_numpy({k: v for k, v in params.items() if k != "b_hh"})


def test_sequential_matches_jax_and_carries_batchnorm_state():
    """Linear, a bare relu, BatchNorm, Linear: eval, then train (the
    BatchNorm child's buffers become the JAX Sequential's new_state), and
    param_count / param_bytes / is_stateful on both packages' trees."""
    jseq = jnn.Sequential(jnn.Linear(5, 8), jnn.relu, jnn.BatchNorm(8, momentum=0.3),
                          jnn.Linear(8, 3))
    params = jax.tree_util.tree_map(np.asarray, jseq.init(jax.random.key(7)))
    state = jseq.init_state()
    tseq = onn.Sequential(onn.Linear(5, 8, device="cpu"), onn.relu,
                          onn.BatchNorm(8, momentum=0.3, device="cpu"),
                          onn.Linear(8, 3, device="cpu"))
    sd = sequential_params_from_numpy(params, state)
    assert set(sd) == set(tseq.state_dict())
    tseq.load_state_dict(sd)
    x = _x((16, 5), scale=2.0)
    # eval without a state: the JAX Sequential raises given one (below)
    compare(lambda p, xx: jseq.apply(p, xx), tseq, params, [x], module=tseq)
    compare(lambda p, xx: jseq.apply(p, xx, state=state, train=True)[0],
            lambda xx: tseq(xx, train=True), params, [x], module=tseq)
    _, new = jax.jit(lambda p, xx: jseq.apply(p, xx, state=state, train=True))(params, x)
    _close(tseq.layer_2.mean, new["layer_2"]["mean"])
    _close(tseq.layer_2.var, new["layer_2"]["var"])
    assert len(tseq) == 4 and list(dict(tseq.named_children())) == ["layer_0", "layer_2",
                                                                     "layer_3"]
    from of_spmm_tpu.nn import module as jmodule
    assert onn.param_count(tseq) == onn.param_count(params) == jmodule.param_count(params) == 91
    assert onn.param_bytes(tseq) == jmodule.param_bytes(params) == 364
    assert onn.is_stateful(tseq) == jmodule.is_stateful(jseq) is True
    assert onn.is_stateful(onn.Linear(2, 2, device="cpu")) == jmodule.is_stateful(
        jnn.Linear(2, 2)) is False


def test_jax_sequential_eval_with_state_raises_port_runs():
    """The JAX Sequential unpacks (y, new_state) from every stateful child,
    but BatchNorm returns y alone unless train=True, so an eval call with a
    state raises (of_spmm_tpu/nn/module.py:89-91); the port's eval uses
    the buffers."""
    jseq = jnn.Sequential(jnn.Linear(3, 4), jnn.BatchNorm(4))
    params = jseq.init(jax.random.key(0))
    x = _x((5, 3))
    with pytest.raises(ValueError, match="too many values to unpack"):
        jseq.apply(params, jnp.asarray(x), state=jseq.init_state())
    tseq = onn.Sequential(onn.Linear(3, 4, device="cpu"), onn.BatchNorm(4, device="cpu"))
    tseq.load_state_dict(sequential_params_from_numpy(params, jseq.init_state()))
    _close(tseq(torch.from_numpy(x)), jax.jit(jseq.apply)(params, x))


def test_sequential_passes_train_and_generator_to_dropout():
    seq = onn.Sequential([onn.Linear(4, 64, device="cpu"), onn.Dropout(0.5), torch.tanh])
    x = torch.ones((3, 4))
    assert torch.equal(seq(x), seq(x, train=False))
    with pytest.raises(ValueError, match="generator"):
        seq(x, train=True)
    a = seq(x, train=True, generator=torch.Generator().manual_seed(1))
    b = seq(x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a == 0).any() and not torch.equal(a, seq(x))
    with pytest.raises(TypeError, match="neither a module nor callable"):
        onn.Sequential(onn.relu, 3)


def test_bilinear_scale_factor_follows_jax_not_f_interpolate():
    """At a factor that does not divide evenly the JAX map (In / Out) and
    F.interpolate's (1 / factor) differ; the port follows JAX. Integer
    factors, size= and nearest agree with F.interpolate."""
    x = _x((2, 3, 5, 7))
    for factor in (1.5, 0.6):
        want = np.asarray(jax.jit(lambda xx: jextras.interpolate(
            xx, factor, mode="bilinear"))(x))
        got = onn.interpolate(torch.from_numpy(x), factor, mode="bilinear")
        _close(got, want)
        torch_rule = F.interpolate(torch.from_numpy(x), scale_factor=factor, mode="bilinear")
        assert torch_rule.shape == got.shape
        assert float((torch_rule - got).abs().max()) > 0.1
    t = torch.from_numpy(x)
    for kw in (dict(scale_factor=2, mode="bilinear"), dict(size=(9, 4), mode="bilinear"),
               dict(scale_factor=2, mode="nearest"), dict(size=(9, 4), mode="nearest")):
        _close(onn.interpolate(t, **kw), F.interpolate(t, **kw))
    with pytest.raises(ValueError, match="unsupported mode"):
        onn.interpolate(t, 2, mode="bicubic")
    with pytest.raises(ValueError, match="size/scale_factor"):
        onn.interpolate(t)
    with pytest.raises(ValueError, match="NCHW"):
        onn.interpolate(t[0], 2)


def test_pixel_shuffle_round_trip_and_errors():
    x = _x((2, 2, 4, 6))
    want = np.asarray(jax.jit(lambda a: jextras.pixel_unshuffle(a, 2))(x))
    got = onn.pixel_unshuffle(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(onn.pixel_shuffle(got, 2).numpy(), x)
    with pytest.raises(ValueError, match="not divisible by 2\\^2"):
        onn.pixel_shuffle(torch.zeros((1, 6, 2, 2)), 2)
    with pytest.raises(ValueError, match="spatial dims"):
        onn.pixel_unshuffle(torch.zeros((1, 1, 3, 4)), 2)
    with pytest.raises(ValueError, match="padding must be int"):
        onn.ZeroPad2d((1, 2))


def test_quirk_errors_match_jax():
    with pytest.raises(ValueError, match="num_channels must divide num_groups") as j:
        jnn.GroupNorm(4, 6)
    with pytest.raises(ValueError, match="num_channels must divide num_groups") as o:
        onn.GroupNorm(4, 6, device="cpu")
    assert str(j.value) == str(o.value)
    x = np.zeros((1, 2, 5, 7), np.float32)
    with pytest.raises(NotImplementedError, match="divide input 5x7") as j:
        jnn.AdaptiveAvgPool2d((2, 3)).apply({}, jnp.asarray(x))
    with pytest.raises(NotImplementedError, match="divide input 5x7") as o:
        onn.AdaptiveAvgPool2d((2, 3))(torch.from_numpy(x))
    assert str(j.value) == str(o.value)
    logp, target = np.log(np.full((2, 3), 1 / 3, np.float32)), np.full((2, 3), 1 / 3, np.float32)
    with pytest.raises(ValueError, match="bad reduction 'batchmean'") as j:
        jextras.kl_div(jnp.asarray(logp), jnp.asarray(target), reduction="batchmean")
    with pytest.raises(ValueError, match="bad reduction 'batchmean'") as o:
        onn.kl_div(torch.from_numpy(logp), torch.from_numpy(target), reduction="batchmean")
    assert str(j.value) == str(o.value)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_and_distances_match_jax(reduction):
    rng = np.random.default_rng(8)
    a, b, c = (_x((5, 6), seed) for seed in (10, 11, 12))
    logits = _x((5, 6), 13)
    logp = np.asarray(jax.nn.log_softmax(logits))
    target = rng.uniform(0, 1, (5, 6)).astype(np.float32)
    target[rng.uniform(size=(5, 6)) < 0.3] = 0.0  # 0 contributes nothing
    y = np.where(rng.uniform(size=5) < 0.5, 1.0, -1.0).astype(np.float32)
    for log_target in (False, True):
        tgt = np.log(target + 0.1) if log_target else target
        compare(lambda p, lp: jextras.kl_div(lp, tgt, reduction, log_target),
                lambda lp: onn.kl_div(lp, torch.from_numpy(tgt), reduction, log_target),
                {}, [logp])
    compare(lambda p, u, v: jextras.margin_ranking_loss(u, v, y, 0.3, reduction),
            lambda u, v: oextras.margin_ranking_loss(u, v, torch.from_numpy(y), 0.3, reduction),
            {}, [a[:, 0], b[:, 0]])
    compare(lambda p, u: jextras.hinge_embedding_loss(u, y[:, None], 0.5, reduction),
            lambda u: oextras.hinge_embedding_loss(u, torch.from_numpy(y)[:, None], 0.5, reduction),
            {}, [a])
    for p_norm in (2.0, 3.0):
        compare(lambda p, u, v, w: jextras.triplet_margin_loss(u, v, w, 0.7, p_norm,
                                                                reduction=reduction),
                lambda u, v, w: oextras.triplet_margin_loss(u, v, w, 0.7, p_norm,
                                                        reduction=reduction),
                {}, [a, b, c])
    if reduction == "mean":
        for p_norm in (2.0, 3.0):
            compare(lambda p, u, v: jextras.pairwise_distance(u, v, p_norm),
                    lambda u, v: onn.pairwise_distance(u, v, p_norm), {}, [a, b])
        for axis in (0, 1):
            compare(lambda p, u, v: jextras.cosine_similarity(u, v, axis),
                    lambda u, v: onn.cosine_similarity(u, v, axis), {}, [a, b])
