"""idle_share.request: percent of the traced calls' time in which nothing ran on
the device (1 - the union of the device activities' intervals inside the
calls over the calls' time, each call from its issue to its
``synchronize()``)."""

from port_bench import readers


def read(ctx):
    return readers.idle_share(ctx, "request")
