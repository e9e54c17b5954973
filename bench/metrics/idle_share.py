"""Share of the profiled interval in which no operation ran on the device
(the union of the device trace's operations), in %."""


def read(ctx):
    d = ctx.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s() / d.window_s)
