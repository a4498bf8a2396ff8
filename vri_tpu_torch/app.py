"""Headless application loop of the port -- ``python -m
vri_tpu_torch.app``.

Takes the flags of ``python -m vri_tpu.app`` and runs the paths the port
has: GI frames (``--mode none``), direct-only frames (``--no-gi``) or
G-buffer debug views through the raster tiers (``--backend raster``),
the LBVH (``--backend bvh``) or the brute-force tracer (``--backend
brute``), and the SDF debug views (``--mode sdf_*``), written as PNGs.
``--lod N`` packs N decimated levels per mesh and rasterizes each
instance at the coarsest level within ``--lod-tau`` pixels of error; the
``animated`` builtin advances one time code a frame, its moving props
taking the bounded SDF update.  ``--cache PATH`` loads the scene cache
when the file exists and writes it after the stage loads otherwise;
``--trace DIR`` records a ``torch.profiler`` trace of the frames, each
under the program's ``frame`` span with its stages inside.  Every
tenth frame logs the frame rate and the card's allocated bytes.
``--multichip`` renders one GI frame with its rows sharded over the ranks
of the launch (``parallel.tiling.render_frame_tiled``; the height rounded
down to a multiple of 8 x ranks) and rank 0 writes ``multichip.png``:
without ``torchrun`` it is a mesh of one rank, under ``torchrun
--nproc-per-node N`` each rank takes ``cuda:LOCAL_RANK`` over ``nccl``.
It renders on the CUDA card.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser("vri_tpu_torch", description=__doc__)
    p.add_argument("--stage", help="path to a .usda stage; omit for a "
                                   "built-in scene")
    p.add_argument("--builtin", default="cornell",
                   choices=["cornell", "kitchen", "animated", "city"],
                   help="procedural scene when --stage is not given")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--mode", default="none",
                   help="debug mode: none|mesh_id|prim_id|barycentric|depth|"
                        "albedo|normal|sdf_distance|sdf_uvw|"
                        "sdf_iterations|sdf_grad|sdf_brick_id|"
                        "sdf_cascade_id")
    p.add_argument("--no-gi", action="store_true",
                   help="direct lighting only")
    p.add_argument("--sdf", default="room",
                   choices=["reference", "room", "tiny"],
                   help="SDF cascade preset (scale of the GI structure)")
    p.add_argument("--backend", default="raster",
                   choices=["raster", "bvh", "brute"])
    p.add_argument("--samples", type=int, default=1, help="GI samples/frame")
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera over --frames frames")
    p.add_argument("--out", default="frames",
                   help="output directory for PNG frames")
    p.add_argument("--cache", help="scene cache path: loads it when present, "
                                   "writes it after the stage loads "
                                   "otherwise")
    p.add_argument("--progressive", action="store_true",
                   help="accumulate frames instead of re-rendering")
    p.add_argument("--multichip", action="store_true",
                   help="shard the framebuffer rows over the ranks of the "
                        "launch (torchrun; one card a rank)")
    p.add_argument("--lod", type=int, default=0, metavar="LEVELS",
                   help="pack N decimated LOD levels per mesh; each "
                        "instance renders the coarsest level within "
                        "--lod-tau pixels of geometric error (0 = off)")
    p.add_argument("--lod-tau", type=float, default=0.75,
                   help="LOD screen-space error budget in pixels")
    p.add_argument("--trace", help="write a torch.profiler trace of the "
                                   "frames (Chrome JSON) into this directory")
    p.add_argument("-v", "--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(levelname)s] %(message)s")
    log = logging.getLogger("vri_tpu_torch")

    from vri_tpu_torch.config import DebugMode, RenderConfig, SDFConfig
    from vri_tpu_torch.hydra.camera import FreeCamera
    from vri_tpu_torch.runtime import profiler
    from vri_tpu_torch.usd import scenes
    from vri_tpu_torch.utils.image import write_png
    from vri_tpu_torch.renderer import Renderer

    mode = getattr(DebugMode, args.mode.upper())
    cfg = RenderConfig(width=args.width, height=args.height,
                       sdf=SDFConfig.preset(args.sdf),
                       lod_levels=args.lod, lod_tau=args.lod_tau)
    mesh = None
    if args.multichip:
        from vri_tpu_torch.parallel import make_mesh

        mesh = make_mesh()
    renderer = Renderer(cfg, device=mesh.device if mesh else "cuda")
    if args.cache and os.path.exists(args.cache):
        with profiler.span("load_cache", log_ms=True):
            renderer.load_cache(args.cache)
        # a cache holds no camera: the orbit camera below stands in
    elif args.stage:
        with profiler.span("load_stage", log_ms=True):
            renderer.load_stage(args.stage)
    else:
        builder = {"cornell": scenes.cornell_box,
                   "kitchen": scenes.kitchen_stress,
                   "animated": scenes.animated_stage,
                   "city": scenes.city_stress}[args.builtin]
        with profiler.span("build_stage", log_ms=True):
            renderer.load_stage(builder())
    if args.cache and not os.path.exists(args.cache):
        renderer.save_cache(args.cache)

    os.makedirs(args.out, exist_ok=True)
    stats = profiler.FrameStats()
    free_cam = FreeCamera() if (args.orbit or renderer.camera is None) \
        else None
    aspect = args.width / args.height
    if args.trace:
        profiler.start_trace(args.trace)
    if mesh is not None:
        _multichip(args, renderer, mesh, log)
    elif args.progressive:
        img = renderer.render_progressive(args.frames, samples=args.samples,
                                          backend=args.backend)
        path = os.path.join(args.out, "progressive.png")
        write_png(path, img)
        log.info("wrote %s", path)
    else:
        for i in range(args.frames):
            cam = (free_cam.at_time(i / 30.0, aspect)
                   if free_cam is not None else None)
            stats.tick()
            # authored timeSamples (the "animated" builtin) advance one
            # time code a frame
            tc = float(i) if args.builtin == "animated" else None
            aovs = renderer.render(camera=cam, mode=mode, gi=not args.no_gi,
                                   samples=args.samples,
                                   backend=args.backend, time_code=tc)
            path = os.path.join(args.out, f"frame_{i:04d}.png")
            write_png(path, aovs["color"], tonemapped=mode != DebugMode.NONE)
            if i % 10 == 0 or i == args.frames - 1:
                log.info("frame %d -> %s | %s | device memory %s", i, path,
                         stats.summary(),
                         profiler.device_memory_stats() or "n/a")
    if args.trace:
        profiler.stop_trace()
    log.info("scene device bytes: %d",
             renderer.delegate.registry.device_bytes())
    if mesh is not None:
        from vri_tpu_torch.parallel.mesh import close

        close(mesh)
    return 0


def _multichip(args, renderer, mesh, log) -> None:
    """One GI frame with its rows sharded over ``mesh``; every rank loads
    the stage and builds the cascades itself, rank 0 writes the frame."""
    from vri_tpu_torch.hydra.camera import FreeCamera
    from vri_tpu_torch.parallel import tiling
    from vri_tpu_torch.passes.frame import FrameParams
    from vri_tpu_torch.utils.image import write_png

    n = mesh.size
    h = (args.height // (8 * n)) * 8 * n or 8 * n
    cam = renderer.camera or FreeCamera().at_time(0.0,
                                                  args.width / args.height)
    cascades = renderer.ensure_cascades(eye=cam.eye)
    out = tiling.render_frame_tiled(
        renderer.scene, FrameParams.from_camera(cam, h, device=mesh.device),
        cascades, mesh=mesh, height=h, width=args.width,
        config=renderer.config.sdf, gi=not args.no_gi, samples=args.samples)
    if mesh.rank == 0:
        path = os.path.join(args.out, "multichip.png")
        write_png(path, out["color"].cpu().numpy())
        rays, hits = (int(v) for v in out["stats"].tolist())
        log.info("multichip frame over %d device(s): %s | rays %d hits %d",
                 n, path, rays, hits)


if __name__ == "__main__":
    sys.exit(main())
