"""Target bases of every pair whose call returned in the window, over the
window's seconds (host clock): `bases_per_s`, read per layer in cells
whose host's speed spreads their runs too far for it to be held to a
bound end to end."""


def read(ctx):
    return ctx.bases / ctx.window_s
