"""SDF update (the clipmap scroll): cells that entered the cascades a
frame (the program's `sdf_scroll.cells` count), re-binned and re-emitted
by the scroll; a frame's mean over the cell's recorded warm-up frames
(`perfbench/traffic/gi_orbit.py`).  Nothing where the program counts
nothing."""


def read(ctx):
    return ctx.spans.get("scroll_cells")
