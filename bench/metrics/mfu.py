"""Model FLOPs of every token the window processed (prompt and generated;
harness/counts.py states the count) over the window's seconds times the
card's bf16 peak, in %. A traced run leaves its profiled stretch out
(harness/trace.py)."""

from harness.counts import model_flops


def read(ctx):
    if ctx.dispatches is None or ctx.peaks is None:
        return None
    total, _ = model_flops(ctx.shapes, ctx.mixer_flops,
                           ctx.window_dispatches())
    return 100.0 * total / (ctx.seconds() * ctx.peaks["bf16_flops"])
