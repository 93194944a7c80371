"""device_idle.train: the share of the traced training window in which no
operation ran on the device."""

from benchmark.readers import device_idle


def read(run):
    return device_idle(run, "train")
