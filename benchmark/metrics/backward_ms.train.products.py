"""backward_ms.train.products: backward_ms.train of the products cells,
moving their own end-to-end metric."""

from benchmark.readers import backward_ms


def read(run):
    return backward_ms(run)
