"""SDF update: device milliseconds of the `sdf_update` span (the bounded
cascade update: re-bin, occupancy, brick allocation, the emit, the march
tables) between its CUDA events, host milliseconds where no card ran;
a frame's median over the cell's recorded warm-up frames
(`perfbench/traffic/gi_anim.py`)."""


def read(ctx):
    return ctx.spans.get("sdf_update_ms")
