"""Median wait from submit to admission into a slot, over the requests
submitted inside the window, from the program's own stamps (its
RequestHandle's t_submit and t_admit); one not admitted at the close
counts with its wait so far."""

import numpy as np


def read(ctx):
    w = ctx.window
    waits = [(r.t_admit_prog if r.t_admit_prog else w.t_close)
             - r.t_submit_prog for r in w.submitted()]
    return float(np.median(waits)) if waits else None
