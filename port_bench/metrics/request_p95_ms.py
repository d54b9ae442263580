"""request_p95_ms: the 95th percentile of every request's latency in the
window, from its issue to its ``synchronize()``."""

import numpy as np


def read(ctx):
    if ctx.kind != "request" or not ctx.latencies_ms:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_ms), 95))
