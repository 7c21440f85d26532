"""Target bases of every pair whose call returned in the window, over the
window's seconds (host clock)."""


def read(ctx):
    return ctx.bases / ctx.window_s
