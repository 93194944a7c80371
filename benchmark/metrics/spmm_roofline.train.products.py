"""spmm_roofline.train.products: spmm_roofline.train of the products cells, moving their own
end-to-end metric."""

from benchmark.readers import spmm_roofline


def read(run):
    return spmm_roofline(run, "train")
