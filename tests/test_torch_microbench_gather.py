"""The port's gather microbenchmark tools (of_spmm_tpu_torch/tools/
microbench_gather, microbench_gather2, microbench_dyngather; the plain
versions in ops/cuda/ of the same names) against the TPU tools under
tools/ on the CPU, at small sizes.

Each TPU tool is loaded by path and its ``pl.pallas_call`` is swapped, on
that module alone, for one that adds ``interpret=True`` and keeps the
callable (tests/test_torch_microbench.py's proxies); the tool's inputs are
captured where it starts timing (``delta_time``, or ``delta`` in
microbench_dyngather) and a sentinel stops it there. The captured inputs
must equal the port tool's bit for bit; the Pallas callable and the port's
plain version then run on them. tools/microbench_gather2.py imports
microbench_gather as a top-level module: the proxied module stands in for
it in sys.modules while the test runs.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.ops.cuda import microbench_dyngather as kdyn
from of_spmm_tpu_torch.ops.cuda import microbench_gather as kgather
from of_spmm_tpu_torch.ops.cuda import microbench_gather2 as kgather2
from of_spmm_tpu_torch.tools import microbench_dyngather as tdyn
from of_spmm_tpu_torch.tools import microbench_gather as tgather
from of_spmm_tpu_torch.tools import microbench_gather2 as tgather2
from test_torch_microbench import _assert_same_inputs, _JaxProxy, _PallasProxy, _Stop

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # the repository's parity bar (tests/conftest.py)
NORM_TOL = 1e-4          # twosided: max |k - p| <= 1e-4 max |p| (lanes summed in any order)
C, T, TILE = 64, 2048, 1024
TABLE_ROWS = 300
TWOSIDED = dict(TILE=512, CW=128, R=64, T=4096)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


class _TpuInterpretProxy(_PallasProxy):
    """As _PallasProxy, with Pallas's TPU interpreter
    (``pltpu.InterpretParams()``), which runs bench_dma_deep's 1,024
    unrolled DMAs in seconds where ``interpret=True`` spends minutes
    compiling them."""

    def pallas_call(self, *args, **kwargs):
        from jax.experimental.pallas import tpu as pltpu

        self._made.append(self._pl.pallas_call(*args, interpret=pltpu.InterpretParams(),
                                               **kwargs))

        def record(*inputs):
            self._seen.extend(np.asarray(x) for x in inputs)
            raise _Stop

        return record


def _load(name, monkeypatch, made, seen, proxy=_PallasProxy):
    """The TPU tool ``name`` with proxied pl and jax, its timing call
    (``delta_time`` or ``delta``) replaced by one that records its inputs
    into ``seen`` and stops."""
    path = os.path.join(_TOOLS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", proxy(mod.pl, made, seen))
    monkeypatch.setattr(mod, "jax", _JaxProxy())

    def timing(make, *args, **kwargs):
        seen.extend(np.asarray(a) for a in args)
        raise _Stop

    monkeypatch.setattr(mod, "delta" if name == "microbench_dyngather" else "delta_time", timing)
    return mod


def _gather2(monkeypatch, made, seen, proxy=_PallasProxy):
    monkeypatch.setitem(sys.modules, "microbench_gather",
                        _load("microbench_gather", monkeypatch, [], []))
    return _load("microbench_gather2", monkeypatch, made, seen, proxy)


def _run_tpu(bench, made, seen, **size):
    with pytest.raises(_Stop):
        bench(**size)
    return np.asarray(made[0](*seen))


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_vmem_loop_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _load("microbench_gather", monkeypatch, made, seen)
    want = _run_tpu(mod.bench_vmem_loop, made, seen, C=C, T=T, K=16)
    port = tgather.inputs_vmem_loop(C, T, 16)
    _assert_same_inputs(port, seen)
    _close(kgather.vmem_loop(*port), want)


def test_vmem_take_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _load("microbench_gather", monkeypatch, made, seen)
    want = _run_tpu(mod.bench_vmem_take, made, seen, C=C, T=T, TILE=TILE)
    port = tgather.inputs_take(C, T)
    _assert_same_inputs(port, seen)
    got = kgather.vmem_take(*port)
    _close(got, want)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_matches_jax(dtype, monkeypatch):
    import jax.numpy as jnp

    made, seen = [], []
    mod = _load("microbench_gather", monkeypatch, made, seen)
    want = _run_tpu(mod.bench_onehot_mxu, made, seen, C=C, T=T, TILE=TILE,
                    dtype=getattr(jnp, dtype))
    port = tgather.inputs_take(C, T, dtype=getattr(torch, dtype))
    _assert_same_inputs(port, seen)
    _close(kgather.onehot(*port), want)


def test_block_slice_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _load("microbench_gather", monkeypatch, made, seen)
    want = _run_tpu(mod.bench_block_slice, made, seen, C=C, T=T, K=8)
    port = tgather.inputs_block_slice(C, T, 8)
    _assert_same_inputs(port, seen)
    _close(kgather.block_slice(*port), want)


def test_row_dma_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _load("microbench_gather", monkeypatch, made, seen)
    want = _run_tpu(mod.bench_row_dma, made, seen, table_rows=TABLE_ROWS, T=T, W=16)
    port = tgather.inputs_row_dma(TABLE_ROWS, T)
    _assert_same_inputs(port, seen)
    _close(kgather.row_dma(*port, W=16), want)


def test_onehot_pair_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _gather2(monkeypatch, made, seen)
    want = _run_tpu(mod.bench_onehot_pair, made, seen, C=C, T=T, TILE=TILE)
    port = tgather2.inputs_onehot_pair(C, T)
    _assert_same_inputs(port, seen)
    _close(kgather2.onehot_pair(*port), want)


def test_take_fused_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _gather2(monkeypatch, made, seen)
    want = _run_tpu(mod.bench_take_fused, made, seen, C=C, T=2 * T, K=8, TILE_ROWS=256)
    port = tgather2.inputs_take_fused(C, 2 * T, 8)
    _assert_same_inputs(port, seen)
    _close(kgather2.take_fused(*port), want)


def test_dma_deep_matches_jax(monkeypatch):
    made, seen = [], []
    mod = _gather2(monkeypatch, made, seen, _TpuInterpretProxy)
    want = _run_tpu(mod.bench_dma_deep, made, seen, table_rows=TABLE_ROWS, T=1024, W=128, NSEM=4)
    port = tgather.inputs_row_dma(TABLE_ROWS, 1024)
    _assert_same_inputs(port, seen)
    _close(kgather2.dma_deep(*port, W=128), want)


def test_window_pair_matches_jax(monkeypatch):
    """U = 300 repeated indices do not fill T = 2048 lanes: the tail is
    padded with U - 1, and lanes past their step's window are clamped."""
    made, seen = [], []
    mod = _gather2(monkeypatch, made, seen)
    want = _run_tpu(mod.bench_window_pair, made, seen, TILE=TILE, CW=128, T=T, U=TABLE_ROWS)
    *port, spill = tgather2.inputs_window_pair(TILE, 128, T, U=TABLE_ROWS)
    assert spill > 0
    _assert_same_inputs(port, seen)
    got = kgather2.window_pair(*port, CW=128)
    _close(got, want)
    assert np.array_equal(got.numpy(), want)


def _twosided(monkeypatch):
    made, seen = [], []
    mod = _gather2(monkeypatch, made, seen)
    want = _run_tpu(mod.bench_twosided, made, seen, **TWOSIDED)
    port = tgather2.inputs_twosided(TWOSIDED["TILE"], TWOSIDED["CW"], TWOSIDED["R"],
                                    TWOSIDED["T"])
    _assert_same_inputs(port, seen)
    return port, want


def _normwise(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def test_twosided_matches_jax(monkeypatch):
    port, want = _twosided(monkeypatch)
    got = kgather2.twosided(*port, CW=TWOSIDED["CW"], R=TWOSIDED["R"])
    assert got.shape == want.shape == (TWOSIDED["R"], 128)
    assert _normwise(got, want) <= NORM_TOL


def test_twosided_keeps_the_lo_half(monkeypatch):
    """The TPU kernel's c_lo is not folded away in interpret mode: a scatter
    of the hi halves alone misses the JAX result by more than the bar."""
    port, want = _twosided(monkeypatch)
    bases, lidx, rows, vals, hi, lo = port
    c = kgather2.window_pair(bases, lidx, hi, lo, TWOSIDED["CW"]) * vals.reshape(-1, 1)
    hi_only = torch.zeros((TWOSIDED["R"], 128)).index_add_(
        0, rows.reshape(-1).long(), c.to(torch.bfloat16).float())
    assert _normwise(hi_only, want) > NORM_TOL
    assert _normwise(kgather2.twosided(*port, CW=TWOSIDED["CW"], R=TWOSIDED["R"]),
                     want) <= NORM_TOL


@pytest.mark.parametrize("shape", ["eq", "ne", "bcast"])
def test_take_along_matches_jax(shape, monkeypatch):
    made, seen = [], []
    mod = _load("microbench_dyngather", monkeypatch, made, seen)
    with pytest.raises(_Stop):
        mod._run(f"tala_{shape}", C, 32, shape, steps=2)
    want = np.asarray(made[0](*seen))
    port = tdyn.inputs(C, 32, shape)
    _assert_same_inputs(port, seen)
    got = kdyn.take_along(*port, steps=2)
    _close(got, want)
    assert np.array_equal(got.numpy(), want)


def test_smem_cap_matches_jax(monkeypatch):
    """vmem_cap's first size (100 MB of scratch) runs in interpret mode and
    returns its input; so does the port's copy at the H100's limit."""
    made, seen = [], []
    mod = _load("microbench_dyngather", monkeypatch, made, seen)
    with pytest.raises(_Stop):
        mod.vmem_cap()
    want = np.asarray(made[0](*seen))
    x = torch.from_numpy(seen[0].copy())
    assert np.array_equal(kdyn.smem_cap(x, tdyn.H100_OPTIN).numpy(), want)
    assert np.array_equal(want, np.ones((8, 128), np.float32))
