"""95th percentile, over the requests that finished inside the window, of
(done - first token) / (tokens - 1), in ms (host clock)."""

from harness.window import p95, tpots


def read(ctx):
    v = p95(tpots(ctx.window))
    return None if v is None else v * 1e3
