"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window,
after ``reset_peak_memory_stats()`` at its start."""


def read(ctx):
    return None if ctx.peak_window_bytes is None else ctx.peak_window_bytes / 2 ** 30
