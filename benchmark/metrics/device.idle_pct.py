"""Share of the traced window in which no kernel, copy or memset ran on the
device, in %; nothing when no operation ran on a device."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
