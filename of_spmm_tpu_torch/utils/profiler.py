"""Profiling — ranges, op timing tables, trace capture; the counterpart of
the JAX package's ``utils/profiler.py``.

- ``range_push`` / ``range_pop`` / ``record``: named wall-clock ranges
  with nesting, collected per thread into a global event list; ``record``
  also opens a ``torch.profiler.record_function`` of the same name, so
  the range appears in a captured trace;
- ``profile``: collects ranges; ``key_averages()`` renders the JAX
  package's aggregate table;
- ``trace(log_dir)``: a ``torch.profiler`` capture (CPU, and the card's
  kernels where there is one) written to ``log_dir`` as a TensorBoard /
  Chrome trace (``*.pt.trace.json``) — the kineto analog;
- ``memory_analysis(fn, *example_args)``: the JAX package's keys for one
  eager call (see its docstring for what each means here).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, tensorboard_trace_handler


@dataclasses.dataclass
class Event:
    name: str
    start: float
    end: float
    depth: int

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3


class _Collector(threading.local):
    def __init__(self):
        self.stack: List = []
        self.events: List[Event] = []
        self.active = 0


_COLLECTOR = _Collector()


def range_push(name: str) -> None:
    _COLLECTOR.stack.append((name, time.perf_counter()))


def range_pop() -> None:
    name, start = _COLLECTOR.stack.pop()
    if _COLLECTOR.active:
        _COLLECTOR.events.append(
            Event(name, start, time.perf_counter(), depth=len(_COLLECTOR.stack))
        )


@contextlib.contextmanager
def record(name: str):
    """OF_PROFILER_RANGE_GUARD analog; nests, opens a record_function."""
    range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        range_pop()


class profile:
    """Context collecting ranges; prints/returns key_averages.

        with profile() as prof:
            with record("step"):
                ...
        print(prof.key_averages())
    """

    def __enter__(self):
        _COLLECTOR.active += 1
        self._start_len = len(_COLLECTOR.events)
        return self

    def __exit__(self, *exc):
        _COLLECTOR.active -= 1
        self.events = _COLLECTOR.events[self._start_len:]
        if _COLLECTOR.active == 0:
            del _COLLECTOR.events[self._start_len:]
        return False

    def key_averages(self) -> str:
        agg: Dict[str, List[float]] = {}
        for e in self.events:
            agg.setdefault(e.name, []).append(e.duration_ms)
        rows = [
            (name, len(ds), sum(ds), sum(ds) / len(ds), max(ds))
            for name, ds in sorted(agg.items(), key=lambda kv: -sum(kv[1]))
        ]
        w = max([len(r[0]) for r in rows], default=4)
        out = [f"{'name':<{w}}  {'count':>5}  {'total ms':>10}  {'avg ms':>10}  {'max ms':>10}"]
        for name, cnt, tot, avg, mx in rows:
            out.append(f"{name:<{w}}  {cnt:>5}  {tot:>10.3f}  {avg:>10.3f}  {mx:>10.3f}")
        return "\n".join(out)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (the host's ops and ranges, and the
    card's kernels when there is a card) into ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _leaves(tree) -> list:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size()) if isinstance(t, torch.Tensor) else int(t.nbytes)


def _storage(t):
    return t.untyped_storage().data_ptr() if isinstance(t, torch.Tensor) else None


def _cpu_peak_bytes(prof) -> int:
    """The high-water mark of the host allocations a profiled call made
    (torch.profiler's memory events: allocations positive, frees negative)."""
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]" and e.device_type() == DeviceType.CPU),
                    key=lambda e: e.start_ns())
    level = peak = 0
    for e in events:
        level += e.nbytes()
        peak = max(peak, level)
    return peak


def memory_analysis(fn, *example_args) -> dict:
    """Memory of one eager call ``fn(*example_args)``, under the JAX
    package's keys (byte counts):

    - ``argument``: the bytes of the arrays and tensors in the arguments;
    - ``output``: the bytes of those in the result;
    - ``alias``: the output bytes that share storage with an argument;
    - ``temp``: what the call allocated at its peak beyond its new
      outputs — on the card the caching allocator's peak around the call,
      on the CPU torch.profiler's host allocation events;
    - ``peak``: ``argument + output + temp``, as the JAX package sums it;
    - ``generated_code_size``: 0 (an eager call compiles no program).
    """
    args = _leaves(example_args)
    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in args)
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*example_args)
        torch.cuda.synchronize()
        high = torch.cuda.max_memory_allocated() - base
    else:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU],
                                    profile_memory=True) as prof:
            out = fn(*example_args)
        high = _cpu_peak_bytes(prof)
    outs = _leaves(out)
    arg_storages = {_storage(t) for t in args} - {None}
    argument = sum(_nbytes(t) for t in args)
    output = sum(_nbytes(t) for t in outs)
    alias = sum(_nbytes(t) for t in outs if _storage(t) in arg_storages)
    temp = max(0, high - (output - alias))
    return {"generated_code_size": 0, "argument": argument, "output": output, "alias": alias,
            "temp": temp, "peak": argument + output + temp}
