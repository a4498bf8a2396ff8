"""SDF update (the clipmap scroll): bricks the scroll emitted a frame, in
the entering cells and the layers beside the moved window edges (the
program's `sdf_scroll.bricks` count); a frame's mean over the cell's
recorded warm-up frames (`perfbench/traffic/gi_orbit.py`).  Nothing where
the program counts nothing."""


def read(ctx):
    return ctx.spans.get("scroll_bricks")
