"""Tokens the program emitted in the engine steps inside the window, over
the window's seconds (host clock)."""

from harness.window import output_tok_s


def read(ctx):
    return output_tok_s(ctx.window)
