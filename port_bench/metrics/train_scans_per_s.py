"""train_scans_per_s: scans of every step the window issued over the
window, which ends at a ``synchronize()`` after the last."""


def read(ctx):
    if ctx.kind != "train" or ctx.window_s <= 0:
        return None
    return ctx.calls * ctx.batch_size / ctx.window_s
