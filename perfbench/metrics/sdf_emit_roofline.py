"""SDF update (the emit kernel): the least time of a frame's re-emit
(``perfbench/roofline_emit.py``) over ``sdf_emit``'s measured time in the
device trace, in percent; nothing where the kernel did not run."""


def read(ctx):
    least = ctx.least.get("sdf_emit")
    if ctx.trace is None or least is None:
        return None
    busy, n = ctx.trace.kernels("sdf_emit_kernel")
    if not n or busy <= 0:
        return None
    return 100.0 * least * ctx.frames / busy
