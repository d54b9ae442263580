"""segment_sum_ms.train: device ms a traced step under the operators of
the repeatable sums (``ops/segment.py``'s ``segment_sum`` and ``take``:
an accumulating ``index_put_`` on the card, ``index_add_`` elsewhere)."""

from port_bench import readers

OPS = ("aten::index_put_", "aten::index_add_")


def read(ctx):
    return readers.op_device_ms(ctx, "train", OPS)
