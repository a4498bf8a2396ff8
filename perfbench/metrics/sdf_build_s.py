"""SDF build: seconds of ``Renderer.ensure_cascades()`` at set-up, the
build and the radiance bake (harness span, ended by a synchronize)."""


def read(ctx):
    return ctx.spans.get("sdf_build_s")
