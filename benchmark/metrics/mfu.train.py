"""mfu.train: the training step's model FLOPs (dense products and SpMMs,
forward and backward, from shapes) over the float32 peak, traced window."""

from benchmark.readers import mfu


def read(run):
    return mfu(run, "train")
