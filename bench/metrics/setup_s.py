"""Set-up seconds: from the start of the run's process to the end of the
engine's warm-up (imports, the kernels' build where it is not cached yet,
the seeded weights, the engine, its captured dispatches), host clock."""


def read(ctx):
    return ctx.setup_s
