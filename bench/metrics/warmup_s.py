"""Seconds of the engine's warmup() (every dispatch it can need compiled:
CUDA graphs captured on the card), the program's
serving_warmup_seconds_total read at the window's open. None where the
program does not count it."""


def read(ctx):
    return ctx.window.counters_open.get("serving_warmup_seconds_total")
