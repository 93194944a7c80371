"""epoch_ms: the window's wall time over the full-batch training steps
completed in it (a full-batch step is an epoch), host clock."""

from benchmark.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "train")
