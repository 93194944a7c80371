"""autoprof — side-by-side module timing against torch, the counterpart
of the JAX package's ``of_spmm_tpu/autoprof.py``.

Each entry runs a port module and its stock ``torch.nn`` twin
(testing/autotest.py ``torch_equivalent``, the port module's weights
copied in) on the same inputs and reports the median forward time of
each and their ratio. On the card both are timed with CUDA events
(utils/roofline.py ``time_cuda``: the device's time for the work); on
the CPU with ``time.perf_counter`` medians.

    from of_spmm_tpu_torch.autoprof import profile_module, table
    rows = [profile_module(nn.Linear(512, 512), (x,)) for x in inputs]
    print(table(rows))
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from of_spmm_tpu_torch.testing.autotest import (
    _device, _inputs, _ours_forward, _torch_forward, torch_equivalent)
from of_spmm_tpu_torch.utils.roofline import time_cuda


@dataclasses.dataclass
class ProfRow:
    name: str
    ours_ms: float
    torch_ms: Optional[float]

    @property
    def speedup(self) -> Optional[float]:
        if self.torch_ms is None or self.ours_ms <= 0:
            return None
        return self.torch_ms / self.ours_ms


def _median_ms(fn: Callable, iters: int, warmup: int, device: torch.device) -> float:
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        return time_cuda(fn, iters=iters)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def profile_module(module, inputs: Sequence[Any], iters: int = 20, warmup: int = 3,
                   with_torch: bool = True) -> ProfRow:
    """Median forward time of ``module`` (no gradients, eval mode) on
    ``inputs`` (tensors or arrays, moved to the module's device), and of
    its torch twin unless ``with_torch`` is False or no converter exists."""
    dev = _device(module)
    xs = _inputs(inputs, dev, False)
    module.eval()
    with torch.no_grad():
        ours_ms = _median_ms(lambda: _ours_forward(module, xs, False), iters, warmup, dev)
        torch_ms = None
        if with_torch:
            try:
                tm, _ = torch_equivalent(module)
            except NotImplementedError:
                tm = None
            if tm is not None:
                tm.eval()
                torch_ms = _median_ms(lambda: _torch_forward(tm, xs), iters, warmup, dev)
    return ProfRow(name=type(module).__name__, ours_ms=ours_ms, torch_ms=torch_ms)


def table(rows: Sequence[ProfRow]) -> str:
    """The comparison table (the JAX package's columns)."""
    w = max([len(r.name) for r in rows], default=4)
    out = [f"{'module':<{w}}  {'ours ms':>9}  {'torch ms':>9}  {'speedup':>8}"]
    for r in rows:
        t = f"{r.torch_ms:9.3f}" if r.torch_ms is not None else "      n/a"
        s = f"{r.speedup:8.2f}" if r.speedup is not None else "     n/a"
        out.append(f"{r.name:<{w}}  {r.ours_ms:9.3f}  {t}  {s}")
    return "\n".join(out)
