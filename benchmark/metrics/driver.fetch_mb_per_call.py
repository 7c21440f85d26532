"""Bytes the align driver copies from the device to the host a call, in
MB: the program's `e2e_fetch` counter over the window's calls."""


def read(ctx):
    c = ctx.counters.get("e2e_fetch")
    return c["cells"] / 1e6 / ctx.n_calls if c and c["calls"] else None
