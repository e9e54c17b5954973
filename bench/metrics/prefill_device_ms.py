"""Device milliseconds of a prefill dispatch: the program's timing events
inside each prefill graph (first node to last), summed over the window's
timed dispatches, over their count. A traced run leaves its profiled
stretch out (harness/trace.py). None where the program does not time its
dispatches. Notes the share of the window's dispatches that were timed."""

SECONDS = "serving_prefill_device_seconds_total"
TIMED = "serving_prefill_device_timed_total"


def read(ctx):
    if TIMED not in ctx.window.counters_close:
        return None
    timed = ctx.counter(TIMED)
    if not timed:
        return None
    dispatches = ctx.counter("serving_prefill_dispatches_total")
    ctx.note(f"prefill_device_ms: {timed:.0f} of {dispatches:.0f} prefill "
             f"dispatches timed")
    return ctx.counter(SECONDS) / timed * 1e3
