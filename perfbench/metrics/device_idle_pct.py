"""Device: share of the profiled stretch's wall time in which no kernel,
copy or set runs (the union of their intervals in the device trace)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
