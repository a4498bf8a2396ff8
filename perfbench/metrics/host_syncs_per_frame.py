"""Frame passes (host): synchronizing operations a frame, counted under
``torch.cuda.set_sync_debug_mode("warn")`` over a few frames."""


def read(ctx):
    if ctx.syncs is None:
        return None
    return ctx.syncs / ctx.sync_frames
