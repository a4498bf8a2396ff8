"""SDF update: bricks the bounded update re-emitted a frame (the
program's `sdf_update.bricks` count); a frame's median over the cell's
recorded warm-up frames (`perfbench/traffic/gi_anim.py`).  Nothing where
the program counts nothing."""


def read(ctx):
    return ctx.spans.get("update_bricks")
