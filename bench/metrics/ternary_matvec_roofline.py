"""B1 (ternary_matvec, the small-m kernel) in the profiled interval: the
least time of its calls at the data-sheet peaks (harness/counts.py) over
the device time of its kernels, in %."""

from harness.counts import roofline


def read(ctx):
    return roofline(ctx, "ternary_matvec", small=True)
