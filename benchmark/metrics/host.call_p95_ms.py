"""95th percentile (nearest rank) of the host-clock time of every call in
the window, in ms. A caller waits on each call; where the card idles most
of the window, as in both align cells, the host paces it."""
from harness.core import p95


def read(ctx):
    return 1e3 * p95(ctx.call_s)
