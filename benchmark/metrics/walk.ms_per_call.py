"""Host seconds of the tracebacks (the codes walker or backcal) a call, in
ms: the program's `e2e_traceback` counter over the window's calls."""


def read(ctx):
    c = ctx.counters.get("e2e_traceback")
    return 1e3 * c["seconds"] / ctx.n_calls if c and c["calls"] else None
