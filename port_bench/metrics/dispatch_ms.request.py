"""dispatch_ms.request: median host ms from a call of the request to its return
(the benchmark's span around the call)."""

from port_bench import readers


def read(ctx):
    return readers.dispatch_ms(ctx, "request")
