"""SDF update (the bake after a scroll): device milliseconds of the
program's `sdf.bake` span between its CUDA events, host milliseconds where
no card ran; a frame's mean over the cell's recorded warm-up frames
(`perfbench/traffic/gi_orbit.py`), in which only a scroll makes the
renderer bake.  Nothing where the program has no such span."""


def read(ctx):
    return ctx.spans.get("scroll_bake_ms")
