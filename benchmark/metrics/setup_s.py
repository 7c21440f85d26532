"""Seconds from the process's start to the first timed call: imports, the
card's start, the kernels' build or load, inputs and warm-up."""


def read(ctx):
    return ctx.setup_s
