"""Kernel A's share of its roofline, in %: the least time the card needs
for the window's DP work (harness/roofline.py, counted from the DP's
shape) over kernel A's device time in the trace."""
from collections import Counter

from harness import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.op_seconds(lambda n: "banded8" in n)
    if s <= 0:
        return None
    ref = ctx.load_module("references", ctx.config["reference"])
    a = ctx.config["align"]
    pw = ref.piecewise(-a["O"], -a["E"], -a["Q"], -a["P"], 1 << 30)
    ops = nbytes = 0.0
    for ci, n in Counter(ctx.call_index).items():
        o, b, _ = roofline.align_work(
            [(len(q), len(t), ref.band_of(len(q), a["W"]))
             for q, t in ctx.calls[ci]], pw)
        ops += n * o
        nbytes += n * b
    return 100.0 * roofline.bound_s(ops, nbytes)[0] / s
