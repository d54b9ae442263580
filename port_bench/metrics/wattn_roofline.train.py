"""wattn_roofline.train: the window attention kernels' share of their
roofline (K3, K4, K5): the sum of each launch's least time over the
profiled time of those kernels, in percent."""

from port_bench import readers

KERNELS = ("wattn_rpe_fwd_kernel", "wattn_rpe_bwd_q_kernel", "wattn_rpe_bwd_k_kernel")


def read(ctx):
    return readers.roofline_share(ctx, "train", "wattn", KERNELS)
