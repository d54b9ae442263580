"""spconv_roofline.request: the sparse conv kernels' share of their roofline
(K1 forward and as dX, K1b): the sum of each launch's least time over the
profiled time of those kernels, in percent."""

from port_bench import readers

KERNELS = ("rulebook_conv_kernel", "rulebook_conv_dw_kernel", "sum_splits_kernel")


def read(ctx):
    return readers.roofline_share(ctx, "request", "spconv", KERNELS)
