"""setup_s: seconds from the process's start to the window's: the
interpreter, torch and CUDA, the model with its weights, the pool's host
plumbing and upload, the first steps or requests (cuDNN's selection, and
in a fresh checkout the kernels' build)."""


def read(ctx):
    return ctx.setup_s
