"""SDF update (the clipmap scroll): device milliseconds of the
`sdf_scroll` span (each moved cascade's re-bin, brick allocation, emit
of the entering cells and the edge layers, and march tables) between its CUDA events, host milliseconds where no
card ran; a frame's mean over the cell's recorded warm-up frames
(`perfbench/traffic/gi_orbit.py`; most frames scroll nothing).  Nothing
where the program has no such span."""


def read(ctx):
    return ctx.spans.get("scroll_ms")
