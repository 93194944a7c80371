"""spmm_roofline.infer: a request's SpMMs against the HBM roofline, over
the device time of every operation launched inside the SpMM's forward."""

from benchmark.readers import spmm_roofline


def read(run):
    return spmm_roofline(run, "serve")
