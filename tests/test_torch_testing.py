"""The port's testing harness (of_spmm_tpu_torch/testing/autotest.py) and
autoprof (of_spmm_tpu_torch/autoprof.py) against the JAX package's
(of_spmm_tpu/testing/autotest.py, of_spmm_tpu/autoprof.py), on the CPU.

- each converter's twin passes ``check_module_against_torch`` (forward,
  input and parameter grads at rtol 1e-4 / atol 1e-5), and a twin with
  one weight perturbed fails it;
- for each converter class, the twin the port builds from a module
  loaded with the JAX package's parameters equals, ``state_dict`` for
  ``state_dict``, the twin JAX ``torch_equivalent(module, params)``
  builds;
- ``autotest`` runs its n seeds; ``check_grads_against_torch``;
  ``profile_module`` / ``table`` as tests/test_utils.py holds the JAX ones.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from of_spmm_tpu import nn as jnn
from of_spmm_tpu.testing.autotest import torch_equivalent as jtorch_equivalent
from of_spmm_tpu_torch import nn
from of_spmm_tpu_torch.autoprof import ProfRow, profile_module, table
from of_spmm_tpu_torch.interop import identity_params_from_numpy
from of_spmm_tpu_torch.testing import (
    ATOL, RTOL, autotest, check_grads_against_torch, check_module_against_torch,
    torch_equivalent)

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

# the module (``testing.autotest`` is also the decorator's name)
port_autotest = importlib.import_module("of_spmm_tpu_torch.testing.autotest")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# name -> (JAX module, port module class and arguments, inputs, check kwargs)
CASES = {
    "Linear": (jnn.Linear(8, 4), (nn.Linear, (8, 4)), (_rand(0, 3, 8),), {}),
    "Conv2d": (jnn.Conv2d(3, 4, 3, stride=1, padding=1), (nn.Conv2d, (3, 4, 3, 1, 1)),
               (_rand(1, 2, 3, 6, 6),), {}),
    "Conv1d": (jnn.Conv1d(3, 4, 3, stride=2), (nn.Conv1d, (3, 4, 3, 2)), (_rand(2, 2, 3, 9),),
               {}),
    "LayerNorm": (jnn.LayerNorm(8), (nn.LayerNorm, (8,)), (_rand(3, 3, 8),), {}),
    "BatchNorm": (jnn.BatchNorm(8), (nn.BatchNorm, (8,)), (_rand(4, 5, 8),), {"train": True}),
    "Embedding": (jnn.Embedding(10, 4), (nn.Embedding, (10, 4)),
                  (np.array([[0, 2], [3, 9]]),), {"int_inputs": True}),
    "LSTM": (jnn.LSTM(4, 5), (nn.LSTM, (4, 5)), (_rand(6, 6, 2, 4),), {}),
    "GRU": (jnn.GRU(4, 5), (nn.GRU, (4, 5)), (_rand(7, 6, 2, 4),), {}),
    "RNN": (jnn.RNN(4, 5), (nn.RNN, (4, 5)), (_rand(8, 6, 2, 4),), {}),
    "MultiheadAttention": (jnn.MultiheadAttention(8, 2), (nn.MultiheadAttention, (8, 2)),
                           (_rand(9, 2, 5, 8),), {}),
    "MaxPool2d": (jnn.MaxPool2d(2), (nn.MaxPool2d, (2,)), (_rand(10, 2, 3, 6, 6),), {}),
    "AvgPool2d": (jnn.AvgPool2d(2), (nn.AvgPool2d, (2,)), (_rand(11, 2, 3, 6, 6),), {}),
}


def _port_module(name: str, seed: int = 0):
    cls, args = CASES[name][1]
    if cls in (nn.MaxPool2d, nn.AvgPool2d):
        return cls(*args)
    if cls in (nn.LayerNorm, nn.BatchNorm):
        return cls(*args, device="cpu")
    return cls(*args, device="cpu", generator=torch.Generator().manual_seed(seed))


def _cases():
    for name in CASES:
        yield name, _port_module(name), CASES[name][2], CASES[name][3]
    yield ("MultiheadAttention(flash=True)",
           nn.MultiheadAttention(8, 2, flash=True, device="cpu",
                                 generator=torch.Generator().manual_seed(0)),
           (_rand(12, 2, 8, 8),), {})


@pytest.mark.parametrize("name,module,inputs,kw", list(_cases()),
                         ids=[c[0] for c in _cases()])
def test_twin_passes(name, module, inputs, kw):
    check_module_against_torch(module, inputs, **kw)


@pytest.mark.parametrize("name,module,inputs,kw",
                         [c for c in _cases() if list(c[1].parameters())],
                         ids=[c[0] for c in _cases() if list(c[1].parameters())])
def test_perturbed_twin_fails(name, module, inputs, kw, monkeypatch):
    convert = port_autotest._CONVERTERS[type(module)]

    def perturbed(m):
        tm, mapping = convert(m)
        with torch.no_grad():
            mapping[0][1].view(-1)[0] += 1e-2
        return tm, mapping

    monkeypatch.setitem(port_autotest._CONVERTERS, type(module), perturbed)
    with pytest.raises(AssertionError):
        check_module_against_torch(module, inputs, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_the_jax_twin(name):
    jmodule = CASES[name][0]
    params = jmodule.init(jax.random.key(3))
    module = _port_module(name)
    if params:
        sd = identity_params_from_numpy(jax.tree.map(np.asarray, params))
        module.load_state_dict(sd, strict=not isinstance(module, nn.BatchNorm))
    want, _ = jtorch_equivalent(jmodule, params)
    got, mapping = torch_equivalent(module)
    assert type(got) is type(want)
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert list(got_sd) == list(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert len(mapping) == len([p for p in module.parameters()])


def test_autotest_runs_n_seeds():
    seen = []

    @autotest(n=4, seed=7)
    def body(generator, trial):
        seen.append((trial, torch.randn(3, generator=generator)))

    body()
    assert [t for t, _ in seen] == [0, 1, 2, 3]
    assert len({tuple(v.tolist()) for _, v in seen}) == 4
    first = [v for _, v in seen]
    seen.clear()
    body()
    assert all(torch.equal(a, b) for a, b in zip(first, [v for _, v in seen]))
    assert body.__name__ == "body"


def test_check_grads_against_torch():
    x = _rand(13, 4, 6)
    check_grads_against_torch(nn.gelu, lambda t: F.gelu(t, approximate="tanh"), (x,))
    with pytest.raises(AssertionError):
        check_grads_against_torch(nn.gelu, lambda t: F.gelu(t), (x,), rtol=RTOL, atol=ATOL)


def test_autoprof_table():
    """autoprof times ours against torch and renders the comparison table."""
    x = _rand(0, 8, 16)
    row = profile_module(nn.Linear(16, 8, device="cpu"), (x,), iters=3, warmup=1)
    assert row.ours_ms > 0
    assert row.torch_ms is None or row.torch_ms > 0
    text = table([row, ProfRow("Custom", 1.0, None)])
    assert "Linear" in text and "ours ms" in text and "n/a" in text
    assert profile_module(nn.Linear(16, 8, device="cpu"), (x,), iters=2,
                          with_torch=False).torch_ms is None
