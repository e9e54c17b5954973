"""Model FLOPs of the prompt tokens the window's prefill dispatches
processed (and the head of their first tokens) over the window's seconds
times the card's bf16 peak, in %: the whole prefill's share of the peak,
which bounds what its kernels can give the first token. A traced run
leaves its profiled stretch out (harness/trace.py)."""

from harness.counts import model_flops


def read(ctx):
    if ctx.dispatches is None or ctx.peaks is None:
        return None
    _, pre = model_flops(ctx.shapes, ctx.mixer_flops,
                         ctx.window_dispatches())
    return 100.0 * pre / (ctx.seconds() * ctx.peaks["bf16_flops"])
