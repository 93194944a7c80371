"""Dual-object autotest: a port module against its stock ``torch.nn``
twin, forward and backward; the counterpart of the JAX package's
``of_spmm_tpu/testing/autotest.py``.

- ``torch_equivalent(module)`` builds the ``torch.nn`` twin of one of the
  port's modules with the module's own weights copied in (the port keeps
  torch layouts, so most maps are the identity; Linear transposes).
- ``check_module_against_torch`` runs both on the same inputs and holds
  the output, the input gradients and the parameter gradients under one
  seeded cotangent at rtol 1e-4 / atol 1e-5, on whatever device the
  module and the inputs are on (a port module with a hand-written kernel,
  ``MultiheadAttention(flash=True)``, against torch's own on the card).
- ``check_grads_against_torch`` does the same for two functions.
- ``@autotest(n, seed)`` repeats a test body over ``n`` seeded
  ``torch.Generator``s.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch import nn as _nn

# the reference's parity bar (the JAX package's RTOL / ATOL)
RTOL = 1e-4
ATOL = 1e-5


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(a, b, rtol: float = RTOL, atol: float = ATOL, what: str = "",
                 norm: bool = False) -> None:
    """``a`` and ``b`` (tensors on any device, or arrays) of one shape and
    within ``atol + rtol * |b|`` elementwise, or with ``norm`` within
    ``atol + rtol * max|b|`` (the bar for long float32 sums taken in
    another order, where an element near zero carries the others'
    rounding)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    if norm:
        err, scale = float(np.abs(a - b).max(initial=0.0)), float(np.abs(b).max(initial=0.0))
        assert np.isfinite(a).all() and err <= atol + rtol * scale, (
            f"{what}: max |a - b| {err} > {atol} + {rtol} * max |b| ({scale})")
        return
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def autotest(n: int = 3, seed: int = 0) -> Callable:
    """Repeat a test body over ``n`` seeded generators:
    ``body(generator=g_i, trial=i)``, each ``g_i`` a CPU
    ``torch.Generator`` seeded from ``seed``."""

    def deco(fn):
        def wrapper():
            seeds = torch.randint(0, 2 ** 62, (n,), generator=torch.Generator().manual_seed(seed))
            for i in range(n):
                fn(generator=torch.Generator().manual_seed(int(seeds[i])), trial=i)

        # a plain zero-argument function, so pytest looks for no fixtures
        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# port module -> torch module converters
# ---------------------------------------------------------------------------
# Each converter returns (torch_module, mapping): mapping is a list of
# (parameter name in the port module, the twin's parameter, to_torch)
# with to_torch the linear map (identity or transpose) from the port's
# layout to torch's, which also maps the port's gradient.

_CONVERTERS: Dict[type, Callable] = {}
Mapping = List[Tuple[str, torch.nn.Parameter, Callable[[torch.Tensor], torch.Tensor]]]


def _converter(cls):
    def deco(fn):
        _CONVERTERS[cls] = fn
        return fn

    return deco


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def _transpose(t: torch.Tensor) -> torch.Tensor:
    return t.T


def _load(module, mapping: Mapping) -> Mapping:
    with torch.no_grad():
        for name, tparam, to_torch in mapping:
            tparam.copy_(to_torch(getattr(module, name).detach()))
    return mapping


def _device(module) -> torch.device:
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return torch.device("cpu")


def torch_equivalent(module) -> Tuple[torch.nn.Module, Mapping]:
    """The ``torch.nn`` twin of ``module`` with its weights (and running
    statistics) copied in, on the module's device, and the mapping of
    their parameters."""
    conv = _CONVERTERS.get(type(module))
    if conv is None:
        raise NotImplementedError(f"no torch converter registered for {type(module).__name__}")
    tm, mapping = conv(module)
    return tm.to(_device(module)), mapping


def _bias(m, names=("b",)) -> bool:
    return all(getattr(m, n, None) is not None for n in names)


@_converter(_nn.Linear)
def _linear(m):
    fan_in, fan_out = m.w.shape
    tm = torch.nn.Linear(fan_in, fan_out, bias=_bias(m))
    mapping = [("w", tm.weight, _transpose)]
    if _bias(m):
        mapping.append(("b", tm.bias, _ident))
    return tm, _load(m, mapping)


def _conv(m, cls):
    out_ch, in_per_group, *k = m.w.shape
    tm = cls(in_per_group * m.groups, out_ch, tuple(k), stride=m.stride, padding=m.padding,
             dilation=m.dilation, groups=m.groups, bias=_bias(m))
    mapping = [("w", tm.weight, _ident)]
    if _bias(m):
        mapping.append(("b", tm.bias, _ident))
    return tm, _load(m, mapping)


@_converter(_nn.Conv2d)
def _conv2d(m):
    return _conv(m, torch.nn.Conv2d)


@_converter(_nn.Conv1d)
def _conv1d(m):
    return _conv(m, torch.nn.Conv1d)


@_converter(_nn.LayerNorm)
def _layernorm(m):
    affine = m.gamma is not None
    tm = torch.nn.LayerNorm(m.normalized_shape, eps=m.eps, elementwise_affine=affine)
    mapping = [("gamma", tm.weight, _ident), ("beta", tm.bias, _ident)] if affine else []
    return tm, _load(m, mapping)


@_converter(_nn.BatchNorm)
def _batchnorm(m):
    affine = m.gamma is not None
    tm = torch.nn.BatchNorm1d(m.num_features, eps=m.eps, momentum=m.momentum, affine=affine)
    with torch.no_grad():
        tm.running_mean.copy_(m.mean)
        tm.running_var.copy_(m.var)
    mapping = [("gamma", tm.weight, _ident), ("beta", tm.bias, _ident)] if affine else []
    return tm, _load(m, mapping)


@_converter(_nn.Embedding)
def _embedding(m):
    n, dim = m.weight.shape
    tm = torch.nn.Embedding(n, dim, padding_idx=getattr(m, "padding_idx", None))
    return tm, _load(m, [("weight", tm.weight, _ident)])


def _recurrent(m, cls, **kwargs):
    tm = cls(m.input_size, m.hidden_size, **kwargs)
    return tm, _load(m, [("w_ih", tm.weight_ih_l0, _ident), ("w_hh", tm.weight_hh_l0, _ident),
                         ("b_ih", tm.bias_ih_l0, _ident), ("b_hh", tm.bias_hh_l0, _ident)])


@_converter(_nn.LSTM)
def _lstm(m):
    return _recurrent(m, torch.nn.LSTM)


@_converter(_nn.GRU)
def _gru(m):
    return _recurrent(m, torch.nn.GRU)


@_converter(_nn.RNN)
def _rnn(m):
    return _recurrent(m, torch.nn.RNN, nonlinearity=m.nonlinearity)


@_converter(_nn.MultiheadAttention)
def _mha(m):
    tm = torch.nn.MultiheadAttention(m.embed_dim, m.num_heads, bias=m.use_bias,
                                     batch_first=True)
    mapping = [("in_w", tm.in_proj_weight, _ident), ("out_w", tm.out_proj.weight, _ident)]
    if m.use_bias:
        mapping += [("in_b", tm.in_proj_bias, _ident), ("out_b", tm.out_proj.bias, _ident)]
    return tm, _load(m, mapping)


@_converter(_nn.MaxPool2d)
def _maxpool(m):
    return torch.nn.MaxPool2d(m.kernel_size, stride=m.stride, padding=m.padding), []


@_converter(_nn.AvgPool2d)
def _avgpool(m):
    return torch.nn.AvgPool2d(m.kernel_size, stride=m.stride, padding=m.padding), []


# ---------------------------------------------------------------------------
# comparison engine
# ---------------------------------------------------------------------------


def _torch_forward(tm, tinputs):
    """Call the torch twin with the port's output conventions: a
    recurrence's outputs without its state, self-attention's output
    without its weights."""
    if isinstance(tm, (torch.nn.LSTM, torch.nn.GRU, torch.nn.RNN)):
        y, _ = tm(*tinputs)
        return y
    if isinstance(tm, torch.nn.MultiheadAttention):
        q = tinputs[0]
        y, _ = tm(q, q, q, need_weights=False)
        return y
    return tm(*tinputs)


def _ours_forward(module, inputs, train: bool):
    kwargs = {"train": train} if "train" in inspect.signature(module.forward).parameters else {}
    out = module(*inputs, **kwargs)
    return out[0] if isinstance(out, tuple) else out  # recurrences return (y, state)


def _inputs(inputs: Sequence[Any], device: torch.device, grad: bool) -> List[torch.Tensor]:
    out = []
    for x in inputs:
        t = (x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)))
        t = t.to(device).clone()
        out.append(t.requires_grad_(True) if grad and t.is_floating_point() else t)
    return out


def _cotangent(shape, like: torch.Tensor) -> torch.Tensor:
    """The shared cotangent: N(0, 1) from a CPU generator seeded 0."""
    ct = torch.randn(tuple(shape), generator=torch.Generator().manual_seed(0))
    return ct.to(device=like.device, dtype=like.dtype)


def check_module_against_torch(module, inputs: Sequence[Any], *, rtol: float = RTOL,
                               atol: float = ATOL, grad: bool = True, train: bool = False,
                               int_inputs: bool = False, norm: bool = False) -> None:
    """Forward (and backward) parity of ``module`` with its torch twin on
    ``inputs`` (tensors or arrays, moved to the module's device).

    The loss is sum(y * ct) for one seeded cotangent ct, so dL/dy = ct and
    every gradient path carries non-uniform weights: the input gradients
    (unless ``int_inputs``) and each parameter's gradient, mapped to
    torch's layout, are held at the same tolerances (elementwise, or
    normwise with ``norm``: ``assert_close``)."""
    tm, mapping = torch_equivalent(module)
    # a recurrence's twin stays in training mode (it has no dropout): the
    # port's runs its cuDNN recurrence so, and cuDNN's backward needs it
    tm.train(train or isinstance(tm, (torch.nn.LSTM, torch.nn.GRU, torch.nn.RNN)))
    module.train(train)
    dev = _device(module)
    xs = _inputs(inputs, dev, grad and not int_inputs)
    txs = _inputs(inputs, dev, grad and not int_inputs)
    for p in module.parameters():
        p.grad = None
    y = _ours_forward(module, xs, train)
    ty = _torch_forward(tm, txs)
    assert_close(y, ty, rtol, atol, "forward", norm)
    if not grad:
        return
    ct = _cotangent(y.shape, y)
    (y * ct).sum().backward()
    (ty * ct).sum().backward()
    if not int_inputs:
        for i, (x, tx) in enumerate(zip(xs, txs)):
            if x.requires_grad:
                assert_close(x.grad, tx.grad, rtol, atol, f"d/d input[{i}]", norm)
    for name, tparam, to_torch in mapping:
        assert_close(to_torch(getattr(module, name).grad), tparam.grad, rtol, atol,
                     f"d/d {name}", norm)


def check_grads_against_torch(fn_ours: Callable, fn_torch: Callable, inputs: Sequence[Any], *,
                              rtol: float = RTOL, atol: float = ATOL) -> None:
    """Parity of two functions (forward and the float inputs' gradients)
    on the same inputs, under one seeded cotangent."""
    dev = next((x.device for x in inputs if isinstance(x, torch.Tensor)), torch.device("cpu"))
    xs, txs = _inputs(inputs, dev, True), _inputs(inputs, dev, True)
    y, ty = fn_ours(*xs), fn_torch(*txs)
    assert_close(y, ty, rtol, atol, "forward")
    ct = _cotangent(y.shape, y)
    (y * ct).sum().backward()
    (ty * ct).sum().backward()
    for i, (x, tx) in enumerate(zip(xs, txs)):
        if x.requires_grad:
            assert_close(x.grad, tx.grad, rtol, atol, f"d/d input[{i}]")
