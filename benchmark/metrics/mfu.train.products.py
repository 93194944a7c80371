"""mfu.train.products: mfu.train of the products cells, moving their own
end-to-end metric."""

from benchmark.readers import mfu


def read(run):
    return mfu(run, "train")
