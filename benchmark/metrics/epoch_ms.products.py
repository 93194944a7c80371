"""epoch_ms.products: epoch_ms of the products cells, a metric of its own
so that its bound follows their spread and not the arxiv cells'."""

from benchmark.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "train")
