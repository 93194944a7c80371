"""device_idle.train.products: device_idle.train of the products cells, moving their own
end-to-end metric."""

from benchmark.readers import device_idle


def read(run):
    return device_idle(run, "train")
