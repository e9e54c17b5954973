"""Host milliseconds of an engine step outside the device waits: the
program's phase counters (serving_phase_<p>_seconds_total) over the
window, without the two syncs (prefill_sync, decode_sync) and without
page_maint (nested in the others), over the engine steps of the window.
A traced run leaves its profiled stretch out (harness/trace.py)."""

SKIP = ("prefill_sync", "decode_sync", "page_maint")
PREFIX, SUFFIX = "serving_phase_", "_seconds_total"


def read(ctx):
    steps = ctx.counter("serving_engine_steps_total")
    if not steps:
        return None
    host = sum(ctx.counter(k) for k in ctx.window.counters_close
               if k.startswith(PREFIX) and k.endswith(SUFFIX)
               and k[len(PREFIX):-len(SUFFIX)] not in SKIP)
    return host / steps * 1e3
