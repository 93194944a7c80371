"""mfu.infer: a request's model FLOPs (dense products and SpMMs of one
forward, from shapes) over the float32 peak, traced window."""

from benchmark.readers import mfu


def read(run):
    return mfu(run, "serve")
