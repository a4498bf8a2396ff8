"""Lightloop (kernel M): the least time of the frame's march rays
(``perfbench/roofline.py``, bytes alone) over M's measured time in the
device trace, in percent; nothing where M did not run."""


def read(ctx):
    least = ctx.least.get("march_rays")
    if ctx.trace is None or least is None:
        return None
    busy, n = ctx.trace.kernels("march_rays")
    if not n or busy <= 0:
        return None
    return 100.0 * least * ctx.frames / busy
