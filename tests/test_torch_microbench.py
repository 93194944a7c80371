"""The port's microbenchmark tools (of_spmm_tpu_torch/tools/, the plain
versions in ops/cuda/{microbench_blockfma,microbench_mxu,microbench_cond,
proto_fused}.py) against the TPU tools under tools/ on the CPU.

Each TPU tool is loaded by path and its ``pl.pallas_call`` is swapped, on
that module alone, for one that adds ``interpret=True`` and keeps the
callable; the tool's inputs are captured where it hands them to its timing
code, and a sentinel (a BaseException, which the tools' ``except
Exception`` does not catch) stops it there. The captured inputs must equal
the port tool's bit for bit; the Pallas callable and the port's plain
version then run on them.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_blockfma as kblockfma
from of_spmm_tpu_torch.ops.cuda import microbench_cond as kcond
from of_spmm_tpu_torch.ops.cuda import microbench_mxu as kmxu
from of_spmm_tpu_torch.ops.cuda import proto_fused as kproto
from of_spmm_tpu_torch.tools import microbench_blockfma as tblockfma
from of_spmm_tpu_torch.tools import microbench_cond as tcond
from of_spmm_tpu_torch.tools import microbench_mxu as tmxu
from of_spmm_tpu_torch.tools import proto_fused as tproto

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # the repository's parity bar (tests/conftest.py)
PROTO_REL_TOL = 1e-5     # max-relative, the port against proto_fused's oracle
# proto_fused at a small size: N, R, T, S, TILES, SPT
PROTO_SMALL = (4096, 128, 256, 1600, 2, 25)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


class _Stop(BaseException):
    """Raised where a TPU tool would start timing."""


class _PallasProxy:
    """The tool module's ``pl``: everything of jax.experimental.pallas, but
    ``pallas_call`` builds in interpret mode, keeps the callable in
    ``made`` and hands the tool a stand-in that records its inputs (as
    numpy, in ``seen``) and stops the tool."""

    def __init__(self, pl, made, seen):
        self._pl, self._made, self._seen = pl, made, seen

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        self._made.append(self._pl.pallas_call(*args, interpret=True, **kwargs))

        def record(*inputs):
            self._seen.extend(np.asarray(x) for x in inputs)
            raise _Stop

        return record


class _JaxProxy:
    """The tool module's ``jax`` with ``jit`` as the identity, so that the
    stand-in meets concrete inputs."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(f, **kwargs):
        return f


def _load(name, monkeypatch, made, seen):
    path = os.path.join(_TOOLS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", _PallasProxy(mod.pl, made, seen))
    monkeypatch.setattr(mod, "jax", _JaxProxy())
    return mod


def _raw(x):
    """An array's bytes as numpy (torch bfloat16 through its int16 view)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(x)


def _assert_same_inputs(port, tpu):
    assert len(port) == len(tpu)
    for p, t in zip(port, tpu):
        p, t = _raw(p), _raw(t)
        assert p.shape == t.shape and p.dtype.itemsize == t.dtype.itemsize
        assert p.tobytes() == t.tobytes()


@pytest.mark.parametrize("variant", ["A", "B"])
def test_blockfma_matches_jax(variant, monkeypatch):
    C, T, K = 64, 256, 32
    made, seen = [], []
    mod = _load("microbench_blockfma", monkeypatch, made, seen)

    def delta_time(make, *args):  # where the tool starts timing
        seen.extend(np.asarray(a) for a in args)
        raise _Stop

    monkeypatch.setattr(mod, "delta_time", delta_time)
    with pytest.raises(_Stop):
        getattr(mod, f"bench_{variant}")(C=C, T=T, K=K)
    port = tblockfma.inputs(variant, C, T, K)
    _assert_same_inputs(port, seen)
    want = np.asarray(made[0](*seen))
    starts, w, tier = (torch.from_numpy(a) for a in port)
    got = tblockfma.run(variant, starts, w, tier).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = kblockfma.blockfma_a_torch if variant == "A" else kblockfma.blockfma_b_torch
    assert np.array_equal(got, plain(starts, w, tier).numpy())


@pytest.mark.parametrize("variant", kmxu.VARIANTS)
def test_mxu_matches_jax(variant, monkeypatch):
    S = 3
    made, seen = [], []
    mod = _load("microbench_mxu", monkeypatch, made, seen)
    with pytest.raises(_Stop):
        mod.run(variant, S=S)
    port = tmxu.inputs(S)
    _assert_same_inputs(port, seen)
    want = np.asarray(made[0](*seen))
    got = kmxu.mxu_step(variant, *port).numpy()
    assert got.shape == want.shape == ((512 if variant == "chain2" else 128), 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,frac", tcond.RUNS)
def test_cond_matches_jax(mode, frac, monkeypatch):
    steps = 3
    made, seen = [], []
    mod = _load("microbench_cond", monkeypatch, made, seen)
    monkeypatch.setattr(mod, "STEPS", steps)
    with pytest.raises(_Stop):
        mod.run(mode, frac)
    port = tcond.inputs(frac, steps)
    _assert_same_inputs(port, seen)
    want = np.asarray(made[0](*seen))
    tiles = kcond.cond_steps(mode, *port)
    assert tiles.shape == (steps, 128, 128)
    np.testing.assert_allclose(tiles[-1].numpy(), want, rtol=RTOL, atol=ATOL)


def _proto_tpu(monkeypatch):
    """The TPU tool's module, its fused Pallas callable and its inputs."""
    made = []
    mod = _load("proto_fused", monkeypatch, made, [])
    N, R, T, S, TILES, SPT = PROTO_SMALL
    _, args = mod.build(N, R, T, S, TILES, SPT, "fused")
    return mod, made[0], [np.asarray(a) for a in args]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_proto_fused_plain_matches_reference(monkeypatch):
    mod, _, args = _proto_tpu(monkeypatch)
    N, R, T, S, TILES, SPT = PROTO_SMALL
    port = tproto.inputs(N, R, T, S, TILES, SPT)
    _assert_same_inputs(port, args)
    want = mod.reference(args, R, T, S, TILES, SPT)
    got = kproto.proto_fused("fused", *port, R=R, S=S, SPT=SPT, TILES=TILES).numpy()
    assert got.shape == want.shape == (TILES * R, 128)
    assert _rel(got, want) <= PROTO_REL_TOL
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_proto_fused_tpu_kernel_diverges_from_its_oracle(monkeypatch):
    """tools/proto_fused.py:98-100 builds the row one-hot along axis 1 (the
    lane) instead of axis 0 (the tile row), so the TPU kernel as written
    disagrees with its own oracle; the port follows the oracle."""
    mod, kernel, args = _proto_tpu(monkeypatch)
    N, R, T, S, TILES, SPT = PROTO_SMALL
    want = mod.reference(args, R, T, S, TILES, SPT)
    tpu = np.asarray(kernel(*args))
    assert _rel(tpu, want) > 0.5
    port = tproto.inputs(N, R, T, S, TILES, SPT)
    got = kproto.proto_fused("fused", *port, R=R, S=S, SPT=SPT, TILES=TILES).numpy()
    assert _rel(got, want) <= PROTO_REL_TOL
