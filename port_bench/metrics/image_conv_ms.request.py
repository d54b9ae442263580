"""image_conv_ms.request: device ms a traced call in cuDNN's convolutions, the
image branch's (forward and backward); no LiDAR layer calls them."""

from port_bench import readers

OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def read(ctx):
    return readers.op_device_ms(ctx, "request", OPS)
