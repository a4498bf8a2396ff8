"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- one static-stage GI frame as
``vri_tpu_torch.renderer.Renderer.render(gi=True)`` runs it -- at the size
a user runs: the 49k-triangle kitchen stage, 1920x1080, the "room" SDF
preset.  Phases, each fatal on failure:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the kernels in ``vri_tpu_torch/csrc`` with nvcc;
3. kernel R (``raster_tiles``) against its plain PyTorch version on the
   frame's real tile lists: slots, z, u and v bit-equal;
4. kernel M (``march_rays``) against its plain version on the frame's real
   shadow and GI rays: t, hit voxel, iterations and activity exactly equal;
5. main path: build the SDF cascades and render three frames with every
   launch counter reset first; checks zero raster overflow, zero SDF list
   drops, finite colour, >50% coverage, and that the counters account for
   every raster pass and every march;
6. agreement on a small input: Cornell box at 64^2 rendered on the card
   and, with the plain versions, on the CPU.

Prints the per-kernel JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Long compiler output goes to
``chiprun_out/``.  Exits non-zero, printing no result, when any phase
fails or no card is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond, msg: str) -> None:
    if not cond:
        _fail(msg)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(out.returncode == 0 and out.stdout.strip(),
           f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA
    events, after one warm-up call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    card = _card_line()
    print(f"card: {card}")

    from vri_tpu_torch import RenderConfig, SDFConfig, _cuda, scenes
    from vri_tpu_torch.ops import gi, march_kernel, rasterize, shading
    from vri_tpu_torch.ops import raygen
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib_path}) [{card}]")
    if _cuda.build_log:
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(_cuda.build_log)
        for line in _cuda.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    h, w = 1080, 1920
    sdf_cfg = SDFConfig.preset("room")
    r = Renderer(RenderConfig(width=w, height=h, sdf=sdf_cfg), device=dev)
    t0 = time.perf_counter()
    r.load_stage(scenes.kitchen_stress(num_objects=256, tess=4))
    print(f"stage: {int(r.scene.num_faces)} triangles, "
          f"{int(r.scene.num_instances)} instances, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    cam = r.camera
    fp = frame_mod.FrameParams.from_camera(cam, h, device=dev)
    world = bake_world(r.scene)
    kernels = {}

    # -- 3. kernel R on the frame's real tile lists -------------------------------
    prep = rasterize.prepare_sorted(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=h, width=w, cull_sign=frame_mod._cull_sign(r.scene))
    rargs = (prep["coef"], prep["lists"], prep["starts"], prep["counts"])
    rkw = dict(num_tx=prep["num_tx"], cap=prep["cap"])
    got = rasterize.raster_tiles(*rargs, **rkw)
    torch.cuda.synchronize()
    want = rasterize.raster_tiles_reference(*rargs, **rkw)
    for name, g, wv in zip(("z", "slot", "u", "v"), got, want):
        _check(torch.equal(g, wv), f"raster_tiles {name} differs from the "
               "plain version")
    r_err = max(float((g.float() - wv.float()).abs().max())
                for g, wv in zip(got, want))
    kernels["raster_tiles"] = dict(
        route="cuda", source="vri_tpu_torch/csrc/raster_tiles.cu",
        replaces="vri_tpu/ops/rasterize.py:1550",
        also_replaces="vri_tpu/ops/rasterize.py:1879",
        max_abs_err=r_err,
        ms=_time_ms(lambda: rasterize.raster_tiles(*rargs, **rkw), 20),
        plain_ms=_time_ms(lambda: rasterize.raster_tiles_reference(
            *rargs, **rkw), 2))
    print(f"raster_tiles: {int(prep['lists'].shape[0])} pairs over "
          f"{int(prep['counts'].shape[0])} tiles (longest list "
          f"{int(prep['counts'].max())}), equal to the plain version; "
          f"{kernels['raster_tiles']['ms']:.3f} ms vs plain "
          f"{kernels['raster_tiles']['plain_ms']:.1f} ms [{card}]")

    # -- 4. kernel M on the frame's real shadow and GI rays ------------------------
    cas = r.ensure_cascades(eye=cam.eye)
    o, d = raygen.camera_rays(fp.inv_view_proj, fp.eye, h, w)
    hit, _ = rasterize.rasterize_sorted(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=h, width=w, cull_sign=frame_mod._cull_sign(r.scene))
    gb = shading.resolve_gbuffer(r.scene, world, hit, o.reshape(-1, 3),
                                 d.reshape(-1, 3), fp.pixel_spread)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = torch.rand((h * w, 2), generator=gen, device=dev)
    meta = march_kernel.pack_meta(cas, sdf_cfg)
    m_times = {}
    m_err = 0.0
    for label, (ro, rd, rt), steps in (
            ("shadow", gi.shadow_rays(gb.position, gb.normal, r.scene, cas,
                                      sdf_cfg), sdf_cfg.shadow_steps),
            ("gi", gi.gi_rays(gb.position, gb.normal, u, cas, sdf_cfg),
             sdf_cfg.gi_steps)):
        margs = (march_kernel.ray_table(cas, ro, rd, rt, sdf_cfg), meta,
                 cas.march_coarse, cas.march_fine0, cas.march_fine1)
        mkw = dict(r=sdf_cfg.cascade_resolution, max_steps=steps * 2 + 16)
        got = march_kernel.march_rays(*margs, **mkw)
        torch.cuda.synchronize()
        want = march_kernel.march_rays_reference(*margs, **mkw)
        for name, g, wv in zip(("t", "hv", "it", "act"), got, want):
            _check(torch.equal(g, wv), f"march_rays {name} differs from the "
                   f"plain version on the {label} rays")
        m_err = max([m_err] + [float((g.double() - wv.double()).abs().max())
                               for g, wv in zip(got, want)])
        m_times[label] = (
            _time_ms(lambda: march_kernel.march_rays(*margs, **mkw), 10),
            _time_ms(lambda: march_kernel.march_rays_reference(
                *margs, **mkw), 2))
        print(f"march_rays ({label}): {margs[0].shape[1]} rays, "
              f"{float((got[1] >= 0).float().mean()):.3f} hit, mean "
              f"{float(got[2].float().mean()):.1f} steps, equal to the plain "
              f"version; {m_times[label][0]:.3f} ms vs plain "
              f"{m_times[label][1]:.1f} ms [{card}]")
    kernels["march_rays"] = dict(
        route="cuda", source="vri_tpu_torch/csrc/march_rays.cu",
        replaces="vri_tpu/ops/march_kernel.py:259",
        also_replaces="vri_tpu/ops/march_kernel.py:221",
        max_abs_err=m_err,
        ms=sum(v[0] for v in m_times.values()),
        plain_ms=sum(v[1] for v in m_times.values()))
    del r, cas, gb, hit, o, d, u, prep, rargs, margs, got, want
    torch.cuda.empty_cache()

    # -- 5. main path ------------------------------------------------------------
    r2 = Renderer(RenderConfig(width=w, height=h, sdf=sdf_cfg), device=dev)
    r2.load_stage(scenes.kitchen_stress(num_objects=256, tess=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rasterize.raster_tiles.launches = 0
    march_kernel.march_rays.launches = 0
    frames = []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        aovs = r2.render(gi=True)
        stop.record()
        torch.cuda.synchronize()
        frames.append((start.elapsed_time(stop),
                       1e3 * (time.perf_counter() - t0)))
        _check(aovs["color"].shape == (h, w, 3)
               and aovs["instance_id"].shape == (h, w),
               f"frame {i}: AOV shapes {aovs['color'].shape}, "
               f"{aovs['instance_id'].shape}")
        _check(int(aovs["raster_overflow_tiles"]) == 0,
               f"frame {i}: raster overflow")
        _check(np.isfinite(aovs["color"]).all(), f"frame {i}: colour not "
               "finite")
        cov = float((aovs["instance_id"] >= 0).mean())
        _check(cov > 0.5, f"frame {i}: coverage {cov:.3f}")
    launches = {"raster_tiles": rasterize.raster_tiles.launches,
                "march_rays": march_kernel.march_rays.launches}
    peak = torch.cuda.max_memory_allocated()
    _check(r2.list_overflow == 0,
           f"SDF list drops: {r2.list_overflow}")
    n_lights = int(r2.scene.num_lights)
    want_launch = {"raster_tiles": 3,
                   # bake: one shadow march; per frame one shadow march
                   # (all lights in one ray set) and one GI march
                   "march_rays": (1 if n_lights else 0) + 3 * 2}
    _check(launches == want_launch,
           f"launch counts {launches}, expected {want_launch}")
    print(f"main path: SDF build + bake {r2.last_build_ms:.1f} ms (host "
          f"clock), {int(r2.cascades.num_bricks)} bricks, 0 list drops "
          f"[{card}]")
    for i, (ev_ms, host_ms) in enumerate(frames):
        print(f"  frame {i}: {ev_ms:.2f} ms (CUDA events), {host_ms:.2f} ms "
              f"host{' (includes the SDF build)' if i == 0 else ''} [{card}]")
    print(f"  coverage {cov:.4f}, launches {launches}, peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")
    for name in kernels:
        kernels[name]["launches"] = launches[name]
    # the same frame without the host copy of the AOVs (device work only)
    dev_ms = _time_ms(lambda: r2.render(gi=True, to_numpy=False), 3)
    print(f"  frame without the host copy of the AOVs: {dev_ms:.2f} ms "
          f"(CUDA events, mean of 3) [{card}]")

    # -- 6. small-input agreement with the plain versions on the CPU ---------------
    small = SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                      max_bricks=16384, base_voxel_size=0.075,
                      truncation_voxels=3.0, max_triangles_per_brick=16,
                      approx_occlusion=True)
    # one set of GI uniforms for both (the CPU and CUDA generators differ)
    u = np.random.default_rng(0).random((1, 64 * 64, 2), dtype=np.float32)
    outs = []
    for device in (dev, torch.device("cpu")):
        rs = Renderer(RenderConfig(width=64, height=64, sdf=small),
                      device=device)
        rs.load_stage(scenes.cornell_box())
        outs.append(rs.render(gi=True,
                              uniforms=torch.as_tensor(u, device=device)))
    same = outs[0]["instance_id"] == outs[1]["instance_id"]
    col = np.abs(outs[0]["color"] - outs[1]["color"]).max(-1)[same]
    print(f"small input: card vs CPU plain versions, ids equal on "
          f"{same.mean():.4f} of pixels, colour at most {col.max():.2e} "
          "apart where they are")
    _check(same.mean() >= 0.999 and col.max() <= 2e-3,
           "card and CPU renders of the Cornell box disagree")

    print(json.dumps({"kernels": [dict(name=k, **v)
                                  for k, v in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
