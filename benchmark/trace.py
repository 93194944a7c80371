"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers read.

The harness opens ``bench.*`` spans (``record_function``) from its own
files: ``bench.window`` around the whole window, and in training
``bench.backward``, ``bench.clip`` and ``bench.optimizer`` around the
calls of the step into autograd, the clip and the optimizer. Every event
of the profiler is read once, from its raw list: host ops (the ATen ops,
the port's ``ofs::`` ops, the spans) with their thread and interval, and
device ops (kernels, copies, fills) with their interval and the host op
that launched them (the profiler's linked correlation id).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
# the profiler's records of its own overhead: host events that share the
# correlation id of the op they interrupted, and are no op
OVERHEAD = frozenset({
    "Command Buffer Full", "Activity Buffer Request", "Activity Buffer Flush",
    "Buffer Flush", "Driver Compiler", "Instrumentation", "Resource",
    "Runtime Triggered Module Loading", "Lazy Function Loading", "Unrecognized",
})


@dataclasses.dataclass
class HostOp:
    name: str
    start: int  # ns
    end: int
    thread: int


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int  # ns
    end: int
    launcher: Optional[HostOp]


@dataclasses.dataclass
class TraceSummary:
    """The traced window: ``window`` is its interval (ns), ``device_ops``
    the device's operations that overlap it, ``host_ops`` the host ops
    (main thread and the autograd thread) and ``spans`` the harness's
    ``bench.*`` spans, by name."""

    window: Tuple[int, int]
    device_ops: List[DeviceOp]
    host_ops: List[HostOp]
    spans: Dict[str, List[Tuple[int, int]]]
    main_thread: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device ops' intervals, clipped to the window."""
        lo, hi = self.window
        ivs = sorted((max(d.start, lo), min(d.end, hi)) for d in self.device_ops
                     if d.end > lo and d.start < hi)
        out: List[List[int]] = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_seconds(self, pred) -> float:
        """Summed duration (s) of the device ops for which ``pred(op)``."""
        return sum(d.end - d.start for d in self.device_ops if pred(d)) * 1e-9

    def launched_in(self, *names: str):
        """A predicate: the device op's launching host op started inside
        one of the intervals of the host ops or spans named ``names``
        (intervals of one name do not nest; of two names they may)."""
        ivs = sorted((h.start, h.end) for h in self.host_ops if h.name in names)
        merged: List[List[int]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        ivs = merged
        starts = [a for a, _ in ivs]

        def pred(d: DeviceOp) -> bool:
            if d.launcher is None:
                return False
            i = bisect.bisect_right(starts, d.launcher.start) - 1
            return i >= 0 and d.launcher.start < ivs[i][1]
        return pred

    def top_device_ops(self, k: int = 10, pred=None) -> List[List]:
        """The ``k`` device ops (of those for which ``pred(op)``) that took
        the most time, by name, in seconds."""
        tot: Dict[str, int] = collections.defaultdict(int)
        for d in self.device_ops:
            if pred is None or pred(d):
                tot[d.name] += d.end - d.start
        return [[name, ns * 1e-9] for name, ns in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        host op the main thread was in when each gap began (the host's
        wait or work that left the device idle), largest first."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        ops = sorted((h for h in self.host_ops
                      if h.thread == self.main_thread and not h.name == WINDOW_SPAN),
                     key=lambda h: h.start)
        starts = [h.start for h in ops]
        tot: Dict[str, int] = collections.defaultdict(int)
        for a, b in gaps:
            i = bisect.bisect_right(starts, a) - 1
            name = "no host op"
            for j in range(i, max(i - 512, -1), -1):
                if ops[j].end > a:
                    name = ops[j].name
                    break
            tot[name] += b - a
        return [[name, ns * 1e-9] for name, ns in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def summarize(prof) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` to a TraceSummary."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host_by_corr: Dict[int, HostOp] = {}
    host_ops: List[HostOp] = []
    spans: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    raw_device = []
    window = None
    main_thread = -1
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() > 0 or name in OVERHEAD:
                continue  # the runtime's own calls (launches, syncs), overhead
            h = HostOp(name, e.start_ns(), e.end_ns(), e.start_thread_id())
            host_by_corr[e.correlation_id()] = h
            host_ops.append(h)
            if name.startswith(SPAN_PREFIX):
                spans[name].append((h.start, h.end))
                if name == WINDOW_SPAN:
                    window = (h.start, h.end)
                    main_thread = h.thread
        else:
            raw_device.append((name, e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    # a span's projection onto the device timeline (torch's own
    # "Optimizer.step#Adam.step" too) carries a host event's name and is no
    # operation
    host_names = {h.name for h in host_ops}
    device_ops = [DeviceOp(n, a, b, host_by_corr.get(c)) for n, a, b, c in raw_device
                  if b > lo and a < hi and n not in host_names]
    return TraceSummary(window=window, device_ops=device_ops, host_ops=host_ops,
                        spans=dict(spans), main_thread=main_thread)
