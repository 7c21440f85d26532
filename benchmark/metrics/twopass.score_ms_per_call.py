"""Host seconds of the two-pass mode's first pass a call, in ms: the
program's `twopass_score` counter (pass 1's first launch until its scores
are read into results) over the window's calls."""


def read(ctx):
    c = ctx.counters.get("twopass_score")
    return 1e3 * c["seconds"] / ctx.n_calls if c and c["calls"] else None
