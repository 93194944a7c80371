"""infer_p95_ms: the 95th percentile of the latencies of all requests
completed in the window, host clock."""

import numpy as np


def read(run):
    if run.loop != "serve" or not run.latencies_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.latencies_s), 95))
