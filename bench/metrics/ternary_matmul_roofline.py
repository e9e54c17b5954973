"""B3 (ternary_matmul, the tiled kernel of prefill) in the profiled
interval: the least time of its calls at the data-sheet peaks
(harness/counts.py) over the device time of its kernels, in %."""

from harness.counts import roofline


def read(ctx):
    return roofline(ctx, "ternary_matmul", small=False)
