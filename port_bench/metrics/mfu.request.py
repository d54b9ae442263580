"""mfu.request: the traced calls' useful FLOPs, counted by the reference from
the configuration's widths and the inputs' valid pairs and windows, over
the traced span and the data sheet's dense peak of the configuration's
precision (TF32 for float32), in percent."""

from port_bench import readers


def read(ctx):
    return readers.mfu(ctx, "request")
