"""Scene sync (a frame): host milliseconds of the `scene_sync` span, the
Hydra sync of the stage at the frame's time code inside
`Renderer.render_temporal`; a frame's median over the cell's recorded
warm-up frames (`perfbench/traffic/gi_anim.py`).  Nothing where the
program has no such span."""


def read(ctx):
    return ctx.spans.get("scene_sync_ms")
