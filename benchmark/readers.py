"""Shared arithmetic of the per-layer readers under ``metrics/``. Each
returns None where the run has nothing to read (no trace, another loop,
no operation on the device, a device without a published peak), never 0
for a share of a peak."""

from __future__ import annotations

from typing import Optional

from benchmark import counts


def per_unit_ms(run, loop: str) -> Optional[float]:
    """The window's wall time (host clock) over the steps or requests
    completed in it, in ms."""
    if run.loop != loop or not run.units:
        return None
    return 1e3 * run.wall_s / run.units


def traced(run, loop: str) -> bool:
    """The run is of ``loop``, traced, and something ran on the device."""
    return run.loop == loop and run.trace is not None and bool(run.trace.device_ops)


def mfu(run, loop: str) -> Optional[float]:
    """The model FLOPs of the traced window's steps or requests over the
    card's float32 peak for the window's length, in %."""
    peak = counts.peak_fp32_flops(run.device_name)
    if not traced(run, loop) or not run.units or peak is None:
        return None
    return 100.0 * run.flops_per_unit * run.units / (peak * run.trace.window_s)


# the port's SpMM as the profiler records it: the autograd function's
# forward (``_SpmmFunction.apply``, also under inference_mode) and its
# backward node on the transpose plan
SPMM_SPANS = ("_SpmmFunction", "_SpmmFunctionBackward")


def spmm_roofline(run, loop: str) -> Optional[float]:
    """The SpMMs' compulsory bytes of the window over the card's HBM peak,
    over the device time of every operation launched inside the SpMM's
    forward and backward (the ``ofs::`` kernels, the tiered finish's
    ``index_add_`` and any other), in %."""
    peak = counts.peak_hbm_bytes_per_s(run.device_name)
    if not traced(run, loop) or not run.units or peak is None:
        return None
    t = run.trace.device_seconds(run.trace.launched_in(*SPMM_SPANS))
    if t <= 0:
        return None
    return 100.0 * run.spmm_bytes_per_unit * run.units / peak / t


def device_idle(run, loop: str) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device, in %."""
    if not traced(run, loop):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def backward_ms(run) -> Optional[float]:
    """The device time per step of the operations launched by host ops
    that began inside the ``bench.backward`` span (autograd's thread
    included), in ms."""
    if not traced(run, "train") or not run.units or not run.trace.spans.get("bench.backward"):
        return None
    return 1e3 * run.trace.device_seconds(run.trace.launched_in("bench.backward")) / run.units
