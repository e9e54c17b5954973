"""Device milliseconds of a decode step: the program's timing events inside
each decode graph (first node to last; a dispatch runs 1-8 steps), summed
over the window's timed dispatches, over their steps. A traced run leaves
its profiled stretch out (harness/trace.py). None where the program does
not time its dispatches. Notes the share of the window's decode steps that
were timed and, over the profiled stretch, the events' device seconds
beside the device trace's busy seconds."""

SECONDS = "serving_decode_device_seconds_total"
TIMED = "serving_decode_device_timed_total"
PREFILL = "serving_prefill_device_seconds_total"


def read(ctx):
    if TIMED not in ctx.window.counters_close:
        return None
    timed = ctx.counter(TIMED)
    if not timed:
        return None
    steps = ctx.counter("serving_decode_steps_total")
    ctx.note(f"decode_device_ms: {timed:.0f} of {steps:.0f} decode steps "
             f"timed")
    x = ctx.excluded
    if x is not None and ctx.device is not None:
        events = sum(x[3][n] - x[2][n] for n in (SECONDS, PREFILL))
        ctx.note(f"profiled stretch: timing events {events:.6f} s, device "
                 f"trace busy {ctx.device.busy_s():.6f} s of "
                 f"{ctx.device.window_s:.6f} s")
    return ctx.counter(SECONDS) / timed * 1e3
