"""backward_ms.train: the device time per step of the operations launched
by host ops that began inside the bench.backward span (autograd's thread
included)."""

from benchmark.readers import backward_ms


def read(run):
    return backward_ms(run)
