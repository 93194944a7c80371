"""mfu.infer.products: mfu.infer of the products cells, moving their own
end-to-end metric."""

from benchmark.readers import mfu


def read(run):
    return mfu(run, "serve")
