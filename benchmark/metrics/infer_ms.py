"""infer_ms: the window's wall time over the requests completed in it,
host clock."""

from benchmark.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "serve")
