"""Share of the token rows the window's prefill dispatches computed that
the prompts needed, in %: the program's serving_prefill_tokens_total over
its serving_prefill_rows_total (slots x bucket a dispatch). A traced run
leaves its profiled stretch out (harness/trace.py). None where the program
does not count its rows."""

ROWS, TOKENS = "serving_prefill_rows_total", "serving_prefill_tokens_total"


def read(ctx):
    if ROWS not in ctx.window.counters_close:
        return None
    rows = ctx.counter(ROWS)
    return 100.0 * ctx.counter(TOKENS) / rows if rows else None
