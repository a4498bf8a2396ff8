"""SDF update: device milliseconds of the `rebake` span (the partial
radiance re-bake of the re-emitted and lighting-dirty bricks) between
its CUDA events, host milliseconds where no card ran; a frame's median
over the cell's recorded warm-up frames (`perfbench/traffic/gi_anim.py`)."""


def read(ctx):
    return ctx.spans.get("rebake_ms")
