"""The port's ResNet, VGG16 and AlexNet against the JAX package's, on the
CPU, with parameters (and ResNet's BatchNorm state) carried by interop,
at rtol 1e-4 / atol 1e-5:

- ``ResNet(layers=(1, 1), width=8)`` on 2 x 3 x 32 x 32: eval logits,
  then a train forward (batch statistics): logits, the gradients of every
  parameter and of the input, and the BatchNorm buffers against JAX's
  ``new_state``; eval again on the updated buffers;
- ``VGG16`` and ``AlexNet`` at 224 x 224, B = 1, ``n_classes=10``: logits
  and every gradient, the JAX model replaying the port's ReLU branches
  and max-pool argmaxes (``Branches``); dropout only with ``train=True``
  and a generator, reproducible from its seed;
- the parameter counts of ``resnet50`` / ``resnet101`` / ``vgg16`` /
  ``alexnet`` against the JAX trees' (``jax.eval_shape``, no init);
- interop's key checks.

Every JAX call is jitted.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from of_spmm_tpu.models import resnet as jresnet
from of_spmm_tpu.models import vision as jvision
from of_spmm_tpu.nn import conv as jconv
from of_spmm_tpu_torch import nn as onn
from of_spmm_tpu_torch.interop import (
    alexnet_params_from_numpy, resnet_params_from_numpy, vgg16_params_from_numpy)
from of_spmm_tpu_torch.models import (
    AlexNet, ResNet, VGG16, alexnet, resnet50, resnet101, vgg16)
from of_spmm_tpu_torch.utils.tree import unnest
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _grads_close(model: torch.nn.Module, jgrads) -> None:
    want = unnest(jgrads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        _close(p.grad, want[name])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_small_resnet_matches_jax_and_its_batchnorm_state():
    jmodel = jresnet.ResNet(layers=(1, 1), n_classes=10, width=8)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    state = jmodel.init_state()
    model = ResNet(layers=(1, 1), n_classes=10, width=8, device="cpu")
    model.load_state_dict(resnet_params_from_numpy(params, state))
    x = _x((2, 3, 32, 32), 1)
    cot = _x((2, 10), 2)

    evaluate = jax.jit(lambda p, xx, st: jmodel.apply(p, xx, state=st))
    _close(model(torch.from_numpy(x)), evaluate(params, x, state))

    def train_loss(p, xx):
        logits, new = jmodel.apply(p, xx, state=state, train=True)
        return jnp.sum(logits * cot), (logits, new)

    (_, (logits, new)), (gp, gx) = jax.jit(jax.value_and_grad(
        train_loss, argnums=(0, 1), has_aux=True))(params, x)
    xt = torch.tensor(x, requires_grad=True)
    out = model(xt, train=True)
    _close(out, logits)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, gx)
    _grads_close(model, gp)
    buffers = dict(model.named_buffers())
    want = unnest(new)
    assert set(buffers) == set(want) and len(want) == 2 * 9  # stem + 2 x (3 + down)
    for name, b in buffers.items():
        _close(b, want[name])
    _close(model(torch.from_numpy(x)), evaluate(params, x, new))


@pytest.fixture(scope="module", params=["vgg16", "alexnet"])
def vision_pair(request):
    """(JAX model, its params as numpy, the port's model with them)."""
    jcls, ocls, convert = {"vgg16": (jvision.VGG16, VGG16, vgg16_params_from_numpy),
                           "alexnet": (jvision.AlexNet, AlexNet,
                                       alexnet_params_from_numpy)}[request.param]
    jmodel = jcls(n_classes=10)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1)))
    model = ocls(n_classes=10, device="cpu")
    model.load_state_dict(convert(params))
    return jmodel, params, model


class Branches:
    """The port forward's branch decisions, replayed in the JAX model: a
    unit within float32 rounding of 0 may take the other ReLU branch in
    the other package (AlexNet at 224 has one at 7.5e-8, which moves
    conv_2's grads by 5e-3 max-relative), and a max-pool window whose two
    largest values lie that close may route its gradient to the other
    one. ``record`` runs the port's forward keeping each torch.relu call's
    mask and each max pool's argmax; under ``replay`` the i-th
    jax.nn.relu returns its input times mask i and the i-th JAX MaxPool2d
    takes the recorded argmax of each window."""

    def __init__(self, monkeypatch):
        self.mp, self.masks, self.argmax = monkeypatch, [], []

    def record(self, fn):
        relu, pool = torch.relu, F.max_pool2d

        def recording_relu(h):
            self.masks.append((h > 0).detach().numpy())
            return relu(h)

        def recording_pool(h, *args):
            out, idx = pool(h, *args, return_indices=True)
            self.argmax.append(idx.numpy())
            return out

        with self.mp.context() as m:
            m.setattr(torch, "relu", recording_relu)
            m.setattr(F, "max_pool2d", recording_pool)
            return fn()

    @contextlib.contextmanager
    def replay(self, masks, argmax):
        """JAX's relu and MaxPool2d replaying ``masks`` and ``argmax`` (the
        recorded ones, passed in as arguments of the jitted function)."""
        masks, argmax = iter(masks), iter(argmax)

        def pool_apply(mod, params, h, **kw):
            idx = next(argmax)
            flat = h.reshape(h.shape[0], h.shape[1], -1)
            return jnp.take_along_axis(flat, idx.reshape(idx.shape[0], idx.shape[1], -1),
                                       axis=2).reshape(idx.shape)

        with self.mp.context() as m:
            m.setattr(jax.nn, "relu", lambda h: h * next(masks))
            m.setattr(jconv.MaxPool2d, "apply", pool_apply)
            yield
        assert next(masks, None) is None and next(argmax, None) is None


def test_vision_model_matches_jax_at_224(vision_pair, monkeypatch):
    """Logits and every gradient (of sum(logits * cot)) at 224 x 224, with
    the port's ReLU branches and max-pool argmaxes replayed in JAX."""
    jmodel, params, model = vision_pair
    x = _x((1, 3, 224, 224), 3)
    cot = _x((1, 10), 4)
    branches = Branches(monkeypatch)
    model.zero_grad(set_to_none=True)
    out = branches.record(lambda: model(torch.from_numpy(x)))
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(p, xx, masks, argmax):
        with branches.replay(masks, argmax):
            logits = jmodel.apply(p, xx)
        return jnp.sum(logits * cot), logits

    (_, logits), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, x, branches.masks, branches.argmax)
    assert (len(branches.masks), len(branches.argmax)) == {VGG16: (15, 5),
                                                           AlexNet: (7, 3)}[type(model)]
    _close(out, logits)
    _grads_close(model, gp)


def test_vision_model_dropout_needs_train_and_a_generator(vision_pair):
    jmodel, params, model = vision_pair
    x = torch.from_numpy(_x((1, 3, 224, 224), 5))
    with torch.no_grad():
        plain = model(x)
        assert torch.equal(model(x, train=True), plain)  # no generator: no dropout, as JAX
        a = model(x, train=True, generator=torch.Generator().manual_seed(6))
        b = model(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    want = jax.jit(lambda p, xx: jmodel.apply(p, xx, train=True))(params, x.numpy())
    _close(plain, want)


@pytest.mark.parametrize("name,count", [("resnet50", 25_557_032), ("resnet101", 44_549_160),
                                        ("vgg16", 138_357_544), ("alexnet", 61_100_840)])
def test_parameter_counts_match_jax_trees(name, count):
    jmodel = {"resnet50": jresnet.resnet50, "resnet101": jresnet.resnet101,
              "vgg16": jvision.vgg16, "alexnet": jvision.alexnet}[name]()
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == count
    model = {"resnet50": resnet50, "resnet101": resnet101, "vgg16": vgg16,
             "alexnet": alexnet}[name](device="cpu")
    assert onn.param_count(model) == count
    assert onn.param_bytes(model) == 4 * count
    assert onn.is_stateful(model) == name.startswith("resnet")
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == {
        k: s.shape for k, s in unnest(shapes).items()}
    if name.startswith("resnet"):
        state = jax.eval_shape(jmodel.init_state)
        assert {k: tuple(v.shape) for k, v in model.named_buffers()} == {
            k: s.shape for k, s in unnest(state).items()}


def test_interop_checks_the_trees():
    params = jax.eval_shape(jvision.AlexNet(n_classes=10).init, jax.random.key(0))
    with pytest.raises(KeyError, match="VGG16 params need conv_0..conv_12"):
        vgg16_params_from_numpy(params)
    jmodel = jresnet.ResNet(layers=(1,), width=4)
    rparams = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                     jax.eval_shape(jmodel.init, jax.random.key(0)))
    state = jmodel.init_state()
    with pytest.raises(KeyError, match="state keys"):
        resnet_params_from_numpy(rparams, {k: v for k, v in state.items() if k != "stem_bn"})
    sd = resnet_params_from_numpy(rparams, state)
    assert set(sd) == set(ResNet(layers=(1,), width=4, device="cpu").state_dict())
