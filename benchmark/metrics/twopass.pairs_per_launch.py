"""Pairs a launch group of the two-pass mode holds: the program's
`twopass_launch` counter's pairs over its adds (one a group)."""


def read(ctx):
    c = ctx.counters.get("twopass_launch")
    return c["cells"] / c["calls"] if c and c["calls"] else None
