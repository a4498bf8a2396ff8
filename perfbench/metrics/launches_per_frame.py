"""Frame passes (eager passes): CUDA kernels launched a frame, from the
device trace of the profiled frames."""


def read(ctx):
    if ctx.trace is None:
        return None
    _, n = ctx.trace.kernels()
    return n / ctx.frames if n else None
