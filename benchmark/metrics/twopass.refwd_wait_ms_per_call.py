"""Host seconds the two-pass mode waits on its chunks' re-forwards and
their fetch a call, in ms: the program's `banded8_refwd` counter over the
window's calls."""


def read(ctx):
    c = ctx.counters.get("banded8_refwd")
    return 1e3 * c["seconds"] / ctx.n_calls if c and c["calls"] else None
