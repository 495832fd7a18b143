"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), weights included, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
