"""Stage breakdown of the PyTorch / CUDA port's GI frame and SDF build on
one CUDA card, at the main path's size (the 49k-triangle kitchen stage,
1920x1080, the "room" SDF preset).

    python3 tools/torch_frame_stages.py

Each stage runs between two ``torch.cuda.synchronize()`` calls and is
timed on the host clock, so the stages add up to more than an unfenced
frame.  The SDF build's stages are timed by wrapping the builder's
binning, occupancy, emit and table functions.  Then one ``render(gi=True)``
runs under ``torch.profiler`` and its device-time table is printed.  The
last line is a JSON object of the stage milliseconds.  Takes about two
minutes on an H100, most of it two SDF builds.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.ops import gi, march_kernel, rasterize, raygen
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build, shading
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    dev = torch.device("cuda")
    times: dict = {}

    def stage(name, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    h, w = 1080, 1920
    cfg = SDFConfig.preset("room")
    r = Renderer(RenderConfig(width=w, height=h, sdf=cfg), device=dev)
    r.load_stage(scenes.kitchen_stress(num_objects=256, tess=4))
    s, cam = r.scene, r.camera

    # -- SDF build, focused where Renderer.ensure_cascades focuses it
    ni = int(s.num_instances)
    lo = s.instance_aabb_lo[:ni].cpu().numpy().min(0)
    hi = s.instance_aabb_hi[:ni].cpu().numpy().max(0)
    world = stage("build.bake_world", bake_world, s)
    centers = sdf_mod.default_centers(cfg, np.clip(cam.eye, lo, hi),
                                      device=dev)
    cfg2 = stage("build.demand_caps", sdf_build.demand_caps, s, world,
                 centers, cfg)
    for name, attr in (("build.bin", "_bin_cascades"),
                       ("build.occupancy", "_occupancy_cells"),
                       ("build.emit", "_emit_bricks"),
                       ("build.tables", "build_march_tables")):
        orig = getattr(sdf_build, attr)
        setattr(sdf_build, attr,
                lambda *a, _n=name, _f=orig, **k: stage(_n, _f, *a, **k))
    cas, st = stage("build.total", sdf_build.build_for_scene, s, world,
                    centers, cfg2)
    cas = stage("build.bake", sdf_mod.bake_brick_lighting, cas, s,
                config=cfg2, alive=st.alive)
    print(f"caps {cfg2.cell_list_cap} / {cfg2.global_list_cap}, "
          f"{int(cas.num_bricks)} bricks")
    build_times = dict(times)

    # -- frame stages, steady state (the last of three passes)
    fp = frame_mod.FrameParams.from_camera(cam, h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cull = frame_mod._cull_sign(s)
    for _ in range(3):
        times.clear()
        wv = stage("frame.bake_world", bake_world, s)
        o, d = stage("frame.camera_rays", raygen.camera_rays,
                     fp.inv_view_proj, fp.eye, h, w)
        prep = stage("frame.raster_prep", rasterize.prepare_sorted, wv,
                     s.tri_vertices, s.num_faces, fp.view_proj, height=h,
                     width=w, cull_sign=cull)
        stage("frame.raster_kernel", rasterize.raster_tiles, prep["coef"],
              prep["lists"], prep["starts"], prep["counts"],
              num_tx=prep["num_tx"], cap=prep["cap"])
        hit, _ = stage("frame.raster_total", rasterize.rasterize_sorted, wv,
                       s.tri_vertices, s.num_faces, fp.view_proj, height=h,
                       width=w, cull_sign=cull)
        gb = stage("frame.resolve_gbuffer", shading.resolve_gbuffer, s, wv,
                   hit, o.reshape(-1, 3), d.reshape(-1, 3), fp.pixel_spread)
        ro, rd, rt = stage("frame.shadow_rays", gi.shadow_rays, gb.position,
                           gb.normal, s, cas, cfg2)
        rays = stage("frame.shadow_ray_table", march_kernel.ray_table, cas,
                     ro, rd, rt, cfg2)
        stage("frame.shadow_march_kernel", march_kernel.march_rays, rays,
              march_kernel.pack_meta(cas, cfg2), cas.march_coarse,
              cas.march_fine0, cas.march_fine1, r=cfg2.cascade_resolution,
              max_steps=cfg2.shadow_steps * 2 + 16)
        stage("frame.direct_radiance", gi.direct_radiance, gb.position,
              gb.normal, s, cas, cfg2)
        stage("frame.indirect_radiance", gi.indirect_radiance, gb, s, cas,
              config=cfg2, samples=1, generator=gen, use_cache=True)
        stage("frame.render_total", r.render, gi=True)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        r.render(gi=True)
        torch.cuda.synchronize()
    # the table ends with the frame's total device time ("Self CUDA time
    # total"); summing its rows would count an op and its kernels twice
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))
    print(json.dumps({"build": build_times, "frame": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
