"""device_idle.infer: the share of the traced serving window in which no
operation ran on the device."""

from benchmark.readers import device_idle


def read(run):
    return device_idle(run, "serve")
