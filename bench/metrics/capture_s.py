"""Seconds of the engine's dispatch compiles up to the window's open (each
graph's capture with its eager warm call; warmup's and any at first use),
the program's serving_graph_capture_seconds_total read at the window's
open. None where the program does not count them."""


def read(ctx):
    return ctx.window.counters_open.get("serving_graph_capture_seconds_total")
