"""device_idle.infer.products: device_idle.infer of the products cells, moving their own
end-to-end metric."""

from benchmark.readers import device_idle


def read(run):
    return device_idle(run, "serve")
