"""What the microbenchmark tools share: the ``--device`` option, timing
and the bound of a measured call."""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from of_spmm_tpu_torch.utils.device import resolve_device
from of_spmm_tpu_torch.utils.roofline import (
    KernelWork, detect_peak_bw, detect_peak_fp32, detect_peak_tensor16, time_cuda)


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


def bound_fields(work: KernelWork, ms: float, device: torch.device) -> Dict[str, object]:
    """The call's bound on this card and the fraction of it reached; on the
    CPU no device bound exists and the time is the host's."""
    if device.type != "cuda":
        return {"device": "cpu", "clock": "host", "ms": ms, "bytes": work.bytes,
                "flops": work.flops}
    name = torch.cuda.get_device_name(device)
    bound, by = work.bound(detect_peak_bw(name), detect_peak_fp32(name),
                           detect_peak_tensor16(name))
    return {"device": name, "clock": "cuda events", "ms": ms, "bytes": work.bytes,
            "flops": work.flops,
            "bound_ms": bound, "bound_by": by, "fraction_of_bound": bound / ms}


def onehot_mac_fields(macs: int, tensor_cores: bool, ms: float,
                      device: torch.device) -> Dict[str, object]:
    """A TPU one-hot product's multiply-adds (utils/roofline.onehot_macs),
    reported beside the bound: their count and, on the card, the least
    time they take at the peak of the units that run them (the bf16 tensor
    cores, else float32 on the CUDA cores) as a fraction of ``ms``."""
    row = {"onehot_macs": macs}
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        peak = detect_peak_tensor16(name) if tensor_cores else detect_peak_fp32(name)
        row["onehot_mac_ms"] = 2 * macs / peak * 1e3
        row["onehot_mac_fraction"] = row["onehot_mac_ms"] / ms
    return row


def describe(row: Dict[str, object], units: str) -> str:
    """One printed line for a measured row."""
    if row["device"] == "cpu":
        return f"{units}  host {row['ms']:.4f} ms (cpu: no device bound)"
    macs = (f"  one-hot MACs {row['onehot_mac_fraction']:.3f} of peak"
            if "onehot_mac_fraction" in row else "")
    return (f"{units}  {row['ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
            f"  fraction {row['fraction_of_bound']:.3f}{macs}  [{row['device']}]")

