"""Scene sync: seconds of ``Renderer.load_stage`` (harness span, ended by
a synchronize)."""


def read(ctx):
    return ctx.spans.get("sync_s")
