"""spmm_roofline.infer.products: spmm_roofline.infer of the products cells, moving their own
end-to-end metric."""

from benchmark.readers import spmm_roofline


def read(run):
    return spmm_roofline(run, "serve")
