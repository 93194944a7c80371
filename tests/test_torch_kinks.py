"""Gradients at kinks: where the port and the JAX package pick different
derivatives, on the CPU, seeded float32 inputs, JAX jitted.

- ``bce_with_logits`` at a logit of 0: the port gives the true derivative
  sigmoid(0) - t = 0.5 - t; JAX gives -t (``max``'s kink taken as 0 and
  ``|x|``'s as 1), a fault of the reference that the port does not copy.
- Activations and losses delegated to torch's own functions take torch's
  one-sided derivatives at their kinks, JAX its own (``leaky_relu`` at 0,
  also inside ``GATConv``'s attention scores; ``hardtanh`` at +-1;
  ``hardsigmoid`` and ``hardswish`` at +-3; ``l1_loss`` at a zero
  residual). Under jit XLA moves -3 / 6 + 0.5 off 0, so JAX's
  ``hardsigmoid`` and ``hardswish`` have their kink at +3 only there.
- JAX's ``softplus`` gradient is NaN for beta x above about 88: the branch
  it does not take, log1p(exp(beta x)), overflows. The port's is 1.

Each case asserts both packages' values, so that a change on either side
shows; away from the kinks the two agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_spmm_tpu import nn as jnn
from of_spmm_tpu.models import normalized_adjacency as jnormalized_adjacency
from of_spmm_tpu.nn import gnn as jgnn
from of_spmm_tpu.nn import losses as jlosses
from of_spmm_tpu.ops.autograd import make_operator as jmake_operator
from of_spmm_tpu.sparse.formats import CSR as JCSR
from of_spmm_tpu_torch import interop
from of_spmm_tpu_torch import nn
from of_spmm_tpu_torch.models import normalized_adjacency
from of_spmm_tpu_torch.nn import GATConv
from of_spmm_tpu_torch.nn import losses
from of_spmm_tpu_torch.ops import make_operator
from of_spmm_tpu_torch.sparse.formats import CSR

SLOPE = 0.01
TARGET = np.array([1.0, 2.0, 0.0, 0.0], np.float32)  # l1_loss's targets
# name -> (port f, JAX f, inputs (the kinks first), port grads, JAX grads)
KINKS = {
    "leaky_relu": (lambda x: nn.leaky_relu(x, SLOPE), lambda x: jnn.leaky_relu(x, SLOPE),
                   [0.0, -0.0, 1.0, -1.0], [SLOPE, SLOPE, 1.0, SLOPE], [1.0, 1.0, 1.0, SLOPE]),
    "hardtanh": (nn.hardtanh, jnn.hardtanh,
                 [1.0, -1.0, 0.5, 2.0], [0.0, 0.0, 1.0, 0.0], [0.5, 0.5, 1.0, 0.0]),
    "hardsigmoid": (nn.hardsigmoid, jnn.hardsigmoid,
                    [3.0, -3.0, 0.0, 4.0], [0.0, 0.0, 1 / 6, 0.0], [1 / 12, 0.0, 1 / 6, 0.0]),
    "hardswish": (nn.hardswish, jnn.hardswish,
                  [3.0, -3.0, 0.0, 4.0], [1.0, 0.0, 0.5, 1.0], [1.25, 0.0, 0.5, 1.0]),
    "l1_loss": (lambda x: losses.l1_loss(x, torch.from_numpy(TARGET), "none"),
                lambda x: jlosses.l1_loss(x, jnp.asarray(TARGET), "none"),
                [1.0, 2.0, 0.5, -0.5], [0.0, 0.0, 1.0, -1.0], [1.0, 1.0, 1.0, -1.0]),
    "softplus": (nn.softplus, jnn.softplus,
                 [89.0, 100.0, 21.0, 0.0], [1.0, 1.0, 1.0, 0.5], [np.nan, np.nan, 1.0, 0.5]),
    "softplus_beta2": (lambda x: nn.softplus(x, 2.0), lambda x: jnn.softplus(x, 2.0),
                       [44.5, 50.0, 11.0, 0.0], [1.0, 1.0, 1.0, 0.5],
                       [np.nan, np.nan, 1.0, 0.5]),
}


def _grads(port, jfn, x: np.ndarray):
    """(port value, port grad, JAX value, JAX grad) of sum(f(x)) elementwise."""
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    y.sum().backward()
    jy, jvjp = jax.vjp(jax.jit(jfn), jnp.asarray(x))
    (jg,) = jax.jit(jvjp)(jnp.ones_like(jy))
    return y.detach().numpy(), xt.grad.numpy(), np.asarray(jy), np.asarray(jg)


@pytest.mark.parametrize("name", list(KINKS))
def test_kink_gradients_of_both_packages(name):
    port, jfn, xs, want_port, want_jax = KINKS[name]
    x = np.asarray(xs, np.float32)
    y, g, jy, jg = _grads(port, jfn, x)
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g, np.asarray(want_port, np.float32), rtol=1e-6, atol=0)
    np.testing.assert_allclose(jg, np.asarray(want_jax, np.float32), rtol=1e-6, atol=0)


def test_bce_with_logits_gradient_at_zero_is_sigmoid_minus_target():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.zeros(3), rng.standard_normal(5)]).astype(np.float32)
    t = np.concatenate([[0.0, 0.5, 1.0], rng.random(5)]).astype(np.float32)
    y, g, jy, jg = _grads(lambda a: losses.bce_with_logits(a, torch.from_numpy(t), "none"),
                          lambda a: jlosses.bce_with_logits(a, jnp.asarray(t), "none"), x)
    np.testing.assert_allclose(y, jy, rtol=1e-6)
    true = 1 / (1 + np.exp(-x.astype(np.float64))) - t
    np.testing.assert_allclose(g, true, rtol=0, atol=1e-7)
    np.testing.assert_allclose(g[:3], [0.5, 0.0, -0.5], rtol=0, atol=1e-7)
    # the reference's fault at 0: -t; elsewhere it agrees with the true derivative
    np.testing.assert_allclose(jg[:3], -t[:3], rtol=0, atol=1e-7)
    np.testing.assert_allclose(jg[3:], true[3:], rtol=0, atol=1e-6)


def test_gat_scores_at_zero_take_leaky_relus_kink():
    """With a_src = a_dst = 0 every edge score is exactly 0: the outputs
    agree, and the port's grad of a_src is the slope times JAX's (JAX's
    leaky_relu has derivative 1 at 0). a_dst's grad is 0 in exact
    arithmetic (a destination's scores shift together under its softmax)."""
    rng = np.random.default_rng(3)
    dense = (rng.random((12, 12)) < 0.3).astype(np.float32)
    np.fill_diagonal(dense, 0)
    op = make_operator(normalized_adjacency(CSR.from_dense(dense)), device="cpu")
    jop = jmake_operator(jnormalized_adjacency(JCSR.from_dense(dense)), place=False)
    jconv = jgnn.GATConv(5, 4, heads=2, negative_slope=SLOPE)
    params = jconv.init(jax.random.key(0))
    params = {**params, "a_src": jnp.zeros_like(params["a_src"]),
              "a_dst": jnp.zeros_like(params["a_dst"])}
    conv = GATConv(5, 4, heads=2, negative_slope=SLOPE, device="cpu")
    conv.load_state_dict(interop.gat_conv_params_from_numpy(jax.tree.map(np.asarray, params)))
    x = rng.standard_normal((12, 5)).astype(np.float32)
    ct = rng.standard_normal((12, 8)).astype(np.float32)
    out = conv(op, torch.from_numpy(x))
    (out * torch.from_numpy(ct)).sum().backward()
    jout, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jconv.apply(p, jop, jnp.asarray(x), impl="xla") * ct)))(params)
    np.testing.assert_allclose(float((out.detach() * torch.from_numpy(ct)).sum()), float(jout),
                               rtol=1e-5)
    want = np.asarray(jgrad["a_src"])
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(conv.a_src.grad.numpy(), SLOPE * want, rtol=1e-4, atol=1e-8)
