"""Visibility (kernel R): the least time of the frame's raster work
(``perfbench/roofline.py``) over R's measured time in the device trace,
in percent; nothing where R did not run."""


def read(ctx):
    least = ctx.least.get("raster_tiles")
    if ctx.trace is None or least is None:
        return None
    busy, n = ctx.trace.kernels("raster_tiles")
    if not n or busy <= 0:
        return None
    return 100.0 * least * ctx.frames / busy
