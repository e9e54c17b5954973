"""95th percentile of first token minus submit over every request
submitted inside the window; one still waiting at the close counts with
its wait so far (host clock)."""

from harness.window import p95, ttfts


def read(ctx):
    return p95(ttfts(ctx.window))
