"""spmm_roofline.train: the step's SpMMs (forward and the transpose-plan
backward) against the HBM roofline, over the device time of every
operation launched inside the SpMM's forward and backward."""

from benchmark.readers import spmm_roofline


def read(run):
    return spmm_roofline(run, "train")
