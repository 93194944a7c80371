"""What the microbenchmark tools share: the ``--device`` option, timing
and the bound of a measured call."""

from __future__ import annotations

import re
import statistics
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from of_spmm_tpu_torch.utils.device import resolve_device
from of_spmm_tpu_torch.utils.roofline import (
    WARMUP_CALLS, KernelWork, detect_peak_bw, detect_peak_fp32, detect_peak_smem,
    detect_peak_tensor16, time_cuda)


def split_device(argv: Sequence[str]) -> Tuple[torch.device, List[str]]:
    """The device that ``--device NAME`` or ``--device=NAME`` names (the
    card when absent; raises without one) and the other arguments."""
    rest, name = [], None
    it = iter(argv)
    for a in it:
        if a == "--device":
            name = next(it, None)
            if name is None:
                raise SystemExit("--device needs a value (cuda or cpu)")
        elif a.startswith("--device="):
            name = a.split("=", 1)[1]
        else:
            rest.append(a)
    return resolve_device(name), rest


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 20) -> float:
    """Median milliseconds of ``fn()``: CUDA events on the card
    (utils/roofline.time_cuda), the host clock on the CPU."""
    if device.type == "cuda":
        return time_cuda(fn, iters=iters)
    fn()
    times = []
    for _ in range(max(1, min(iters, 3))):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_ms(fn: Callable[[], object], iters: int = 20) -> Dict[str, float]:
    """Each CUDA kernel's mean device milliseconds per call of ``fn()`` on
    the card (torch.profiler's CUDA activity over ``iters`` calls, after
    WARMUP_CALLS), by the kernel's name without its namespace and
    arguments: where the time of a call of several launches goes."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP_CALLS):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            head = re.split(r"[<(]", e.key.replace("(anonymous namespace)::", ""), 1)[0]
            name = re.split(r"\s|::", head.strip())[-1] or e.key
            out[name] = out.get(name, 0.0) + e.device_time_total / iters / 1e3
    return out


def bound_fields(work: KernelWork, ms: float, device: torch.device) -> Dict[str, object]:
    """The call's bound on this card and the fraction of it reached; on the
    CPU no device bound exists and the time is the host's."""
    if device.type != "cuda":
        return {"device": "cpu", "clock": "host", "ms": ms, "bytes": work.bytes,
                "flops": work.flops}
    name = torch.cuda.get_device_name(device)
    peaks = (detect_peak_bw(name), detect_peak_fp32(name), detect_peak_tensor16(name),
             detect_peak_smem(name) if work.smem_words else None)
    bound, by = work.bound(*peaks)
    return {"device": name, "clock": "cuda events", "ms": ms, "bytes": work.bytes,
            "flops": work.flops, **({"smem_words": work.smem_words} if work.smem_words else {}),
            "bound_ms": bound, "bound_by": by, "fraction_of_bound": bound / ms}


def describe(row: Dict[str, object], units: str) -> str:
    """One printed line for a measured row."""
    if row["device"] == "cpu":
        return f"{units}  host {row['ms']:.4f} ms (cpu: no device bound)"
    return (f"{units}  {row['ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
            f"  fraction {row['fraction_of_bound']:.3f}  [{row['device']}]")

