"""Device time of device-to-host copies a call, in ms, from the
profiler's trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.op_seconds(lambda n: "DtoH" in n)
    return 1e3 * s / ctx.n_calls if s > 0 else None
