"""Headless application loop of the port -- ``python -m
vri_tpu_torch.app``.

Takes the flags of ``python -m vri_tpu.app`` and runs the paths the port
has: GI frames (``--mode none``) or G-buffer debug views through the
sorted raster, written as PNGs.  Flags whose paths are not ported yet
(``--no-gi``, the SDF debug modes, ``--backend bvh|brute``,
``--multichip``, ``--lod``, ``--cache``, ``--trace``, the ``animated``
builtin) exit with an error naming them.  It renders on the CUDA card.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


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
                        "albedo|normal (the sdf_* modes are not ported)")
    p.add_argument("--no-gi", action="store_true",
                   help="direct lighting only (not ported)")
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
    p.add_argument("--cache", help="scene cache path (not ported)")
    p.add_argument("--progressive", action="store_true",
                   help="accumulate frames instead of re-rendering")
    p.add_argument("--multichip", action="store_true",
                   help="shard the framebuffer (not ported)")
    p.add_argument("--lod", type=int, default=0, metavar="LEVELS",
                   help="discrete LOD levels per mesh (not ported; 0)")
    p.add_argument("--lod-tau", type=float, default=0.75,
                   help="LOD screen-space error budget in pixels")
    p.add_argument("--trace", help="profiler trace directory (not ported)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p.parse_args(argv)


def _unported(args) -> list:
    bad = []
    if args.no_gi:
        bad.append("--no-gi")
    if args.mode.lower().startswith("sdf"):
        bad.append(f"--mode {args.mode}")
    if args.backend != "raster":
        bad.append(f"--backend {args.backend}")
    for flag, on in (("--multichip", args.multichip), ("--lod", args.lod),
                     ("--cache", args.cache), ("--trace", args.trace)):
        if on:
            bad.append(flag)
    if args.builtin == "animated" and not args.stage:
        bad.append("--builtin animated")
    return bad


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(levelname)s] %(message)s")
    log = logging.getLogger("vri_tpu_torch")
    bad = _unported(args)
    if bad:
        log.error("not ported yet: %s (see ROADMAP.md)", ", ".join(bad))
        return 2

    from vri_tpu.config import DebugMode, RenderConfig, SDFConfig
    from vri_tpu.hydra.camera import FreeCamera
    from vri_tpu.usd import scenes
    from vri_tpu.utils.image import write_png
    from vri_tpu_torch.renderer import Renderer

    mode = getattr(DebugMode, args.mode.upper())
    cfg = RenderConfig(width=args.width, height=args.height,
                       sdf=SDFConfig.preset(args.sdf), lod_tau=args.lod_tau)
    renderer = Renderer(cfg, device="cuda")
    t0 = time.perf_counter()
    if args.stage:
        renderer.load_stage(args.stage)
    else:
        builder = {"cornell": scenes.cornell_box,
                   "kitchen": scenes.kitchen_stress,
                   "city": scenes.city_stress}[args.builtin]
        renderer.load_stage(builder())
    log.info("stage loaded in %.1f ms", 1e3 * (time.perf_counter() - t0))

    os.makedirs(args.out, exist_ok=True)
    free_cam = FreeCamera() if (args.orbit or renderer.camera is None) \
        else None
    aspect = args.width / args.height
    if args.progressive:
        img = renderer.render_progressive(args.frames, samples=args.samples)
        path = os.path.join(args.out, "progressive.png")
        write_png(path, img)
        log.info("wrote %s", path)
        return 0
    for i in range(args.frames):
        cam = (free_cam.at_time(i / 30.0, aspect)
               if free_cam is not None else None)
        t0 = time.perf_counter()
        aovs = renderer.render(camera=cam, mode=mode, gi=True,
                               samples=args.samples, backend=args.backend)
        path = os.path.join(args.out, f"frame_{i:04d}.png")
        write_png(path, aovs["color"], tonemapped=mode != DebugMode.NONE)
        log.info("frame %d -> %s in %.1f ms (host clock)", i, path,
                 1e3 * (time.perf_counter() - t0))
    log.info("scene device bytes: %d",
             renderer.delegate.registry.device_bytes())
    return 0


if __name__ == "__main__":
    sys.exit(main())
