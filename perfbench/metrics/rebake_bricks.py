"""SDF update: bricks the partial radiance re-bake re-baked a frame (the
program's `rebake.bricks` count); a frame's median over the cell's
recorded warm-up frames (`perfbench/traffic/gi_anim.py`).  Nothing where
the program counts nothing."""


def read(ctx):
    return ctx.spans.get("rebake_bricks")
