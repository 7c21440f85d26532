"""Device memory the program held at its peak over the window, in GiB:
torch.cuda.max_memory_allocated() after a reset at the window's start."""


def read(ctx):
    return ctx.peak_window_bytes / 2 ** 30 if ctx.peak_window_bytes else None
