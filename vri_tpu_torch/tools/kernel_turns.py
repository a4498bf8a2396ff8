"""Kernels M (``march_rays``) and R (``raster_tiles``) of this tree against
other trees', in turns, on one CUDA card at the main path's shapes.

    python -m vri_tpu_torch.tools.kernel_turns --other DIR [--other DIR2 ...]
        [--reps 20] [--frame-reps 10]

Each ``DIR`` is the root of another checkout of this repository (for
example a parent commit unpacked with ``git archive``); the first is the
one the frame is compared with.  The tool builds this tree's kernels,
each other tree's ``march_rays.cu`` and ``raster_tiles.cu`` (from its
``vri_tpu_torch/csrc``, with this tree's nvcc flags; a source equal to
this tree's is skipped), and variants of this tree's two kernels that
differ in one constant: M's refill interval (``kRefillEvery``), R's
pixels a thread (``kPx``, so 1024 / kPx threads a block) and R's layout
(each pixel its own column terms, as for tiles wider than the block).  On the main
path's stage (the 49k kitchen at 1920x1080, "room" SDF preset) it holds
every build bit-equal to this tree's kernel on the inputs of
``chip_smoke.py``'s phases 3 and 6 (the frame's tile lists, its shadow
and GI rays), then times each build with CUDA events in turns: the other
trees', this tree's, the variants, the variants again, this tree's, the
other trees'.  A timed call allocates what that tree's wrapper allocates
(this tree's M also zeroes its ray counter).  Kernel R is also timed with
its lists cut at 128 and 256 slots (``cap``), which shows how much of its
time the longest lists take.  Last it times the main-path frame without
the host copy, ``render(gi=True, to_numpy=False)``, with the first other
tree's two kernels in place of this tree's and with this tree's, in the
turns other, this, this, other (with an other tree's M that takes no
counter the wrapper still zeroes one).

Prints the card line, one line per timing and, last, a JSON object of
every number, which it also writes to ``chiprun_out/kernel_turns.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import types

from vri_tpu_torch import _cuda
from vri_tpu_torch.tools import card_line, time_ms

#: this tree's variants: (name, source, constant as written, replacement)
VARIANTS = (("M refill every step", "march_rays.cu",
             "kRefillEvery = 4;", "kRefillEvery = 1;"),
            ("M refill every 2", "march_rays.cu",
             "kRefillEvery = 4;", "kRefillEvery = 2;"),
            ("M refill every 8", "march_rays.cu",
             "kRefillEvery = 4;", "kRefillEvery = 8;"),
            ("R 8 pixels a thread", "raster_tiles.cu",
             "kPx = 4;", "kPx = 8;"),
            ("R 2 pixels a thread", "raster_tiles.cu",
             "kPx = 4;", "kPx = 2;"),
            ("R without the shared column", "raster_tiles.cu",
             "kThreads % tile_w == 0 ?", "false ?"))
#: kernel R timed with its lists cut short (not bit-equal: timing only)
CAPS = (128, 256)


def _compile_all(jobs) -> None:
    """``jobs``: (source path, library path); one nvcc each, in parallel."""
    procs = []
    for src, out in jobs:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        procs.append((src, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({os.path.relpath(src)}): {line.strip()}")


def _entry(path: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(path), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def build(others) -> dict:
    """Name -> (march entry or None, raster entry or None, march takes a
    counter) for "this", each other tree (by its directory's name) and
    each variant."""
    this = _cuda.library()
    work = os.path.join(_cuda.BUILD_DIR, "turns")
    shutil.rmtree(work, ignore_errors=True)
    march_args = _cuda._ENTRIES["vri_march_rays"][1]
    raster_args = _cuda._ENTRIES["vri_raster_tiles"][1]
    jobs, entries = [], []    # entries: (name, kernel slot, entry, counter)
    for other in others:
        name = os.path.basename(os.path.normpath(other))
        csrc = os.path.join(other, "vri_tpu_torch", "csrc")
        for slot, src in enumerate(("march_rays.cu", "raster_tiles.cu")):
            with open(os.path.join(csrc, src)) as f:
                text = f.read()
            with open(os.path.join(_cuda.CSRC, src)) as f:
                if text == f.read():
                    continue
            out = os.path.join(work, name, src[:-3] + ".so")
            jobs.append((os.path.join(csrc, src), out))
            if slot == 0:
                counter = "counter" in text
                entries.append((name, 0, (out, "vri_march_rays", march_args
                                          if counter else
                                          march_args[:14] + [_cuda._P]),
                                counter))
            else:
                entries.append((name, 1, (out, "vri_raster_tiles",
                                          raster_args), False))
    for k, (name, src, old, new) in enumerate(VARIANTS):
        d = os.path.join(work, f"v{k}")
        shutil.copytree(_cuda.CSRC, d)
        path = os.path.join(d, src)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"{src} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        out = os.path.join(d, src[:-3] + ".so")
        jobs.append((path, out))
        slot = 0 if src == "march_rays.cu" else 1
        entries.append((name, slot, (out, f"vri_{src[:-3]}",
                                     (march_args, raster_args)[slot]), True))
    _compile_all(jobs)
    builds = {"this": [this.vri_march_rays, this.vri_raster_tiles, True]}
    for name, slot, (out, fn, argtypes), counter in entries:
        b = builds.setdefault(name, [None, None, counter])
        b[slot] = _entry(out, fn, argtypes)
        if slot == 0:
            b[2] = counter
    return builds


def march_call(fn, counter: bool, margs, mkw):
    """One call of a march entry as its tree's wrapper makes it."""
    import torch

    from vri_tpu_torch.ops import march_kernel

    rays, meta, coarse, f0, f1 = margs
    m, dev = rays.shape[1], rays.device
    out = (torch.empty((m,), dtype=torch.float32, device=dev),
           *(torch.empty((m,), dtype=torch.int32, device=dev)
             for _ in range(3)))
    count = [torch.zeros((1,), dtype=torch.int32, device=dev)] \
        if counter else []
    r = mkw["r"]
    _cuda.check(fn(rays.data_ptr(), m, meta.data_ptr(), meta.shape[1], r,
                   march_kernel._log2s(r), coarse.data_ptr(), f0.data_ptr(),
                   f1.data_ptr(), mkw["max_steps"],
                   *(x.data_ptr() for x in (*out, *count)),
                   _cuda.stream_ptr(rays)), "march_rays")
    return out


def raster_call(fn, rargs, rkw):
    """One call of a raster entry as the wrapper makes it."""
    from vri_tpu_torch.ops import rasterize

    coef, lists, starts, counts = rargs
    t = counts.shape[0]
    out = rasterize._outputs(t, 1024, coef.device)
    _cuda.check(fn(coef.data_ptr(), lists.data_ptr(), starts.data_ptr(),
                   counts.data_ptr(), t, rkw["num_tx"], 8, 128, rkw["cap"],
                   *(x.data_ptr() for x in out), _cuda.stream_ptr(coef)),
                "raster_tiles")
    return out


def inputs(dev):
    """The renderer and phases 3 and 6 of chip_smoke.py: the raster's
    tile lists and the march's shadow and GI ray tables."""
    import torch

    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.ops import gi, march_kernel, rasterize, raygen
    from vri_tpu_torch.ops import shading
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    h, w = 1080, 1920
    cfg = SDFConfig.preset("room")
    r = Renderer(RenderConfig(width=w, height=h, sdf=cfg), device=dev)
    r.load_stage(scenes.kitchen_stress(num_objects=256, tess=4))
    fp = frame_mod.FrameParams.from_camera(r.camera, h, device=dev)
    world = bake_world(r.scene)
    cull = frame_mod._cull_sign(r.scene)
    prep = rasterize.prepare_sorted(world, r.scene.tri_vertices,
                                    r.scene.num_faces, fp.view_proj,
                                    height=h, width=w, cull_sign=cull)
    raster = ((prep["coef"], prep["lists"], prep["starts"], prep["counts"]),
              dict(num_tx=prep["num_tx"], cap=prep["cap"]))
    cas = r.ensure_cascades(eye=r.camera.eye)
    o, d = raygen.camera_rays(fp.inv_view_proj, fp.eye, h, w)
    hit, _ = rasterize.rasterize_sorted(world, r.scene.tri_vertices,
                                        r.scene.num_faces, fp.view_proj,
                                        height=h, width=w, cull_sign=cull)
    gb = shading.resolve_gbuffer(r.scene, world, hit, o.reshape(-1, 3),
                                 d.reshape(-1, 3), fp.pixel_spread)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = torch.rand((h * w, 2), generator=gen, device=dev)
    meta = march_kernel.pack_meta(cas, cfg)
    march = {}
    for label, (ro, rd, rt), steps in (
            ("shadow", gi.shadow_rays(gb.position, gb.normal, r.scene, cas,
                                      cfg), cfg.shadow_steps),
            ("gi", gi.gi_rays(gb.position, gb.normal, u, cas, cfg),
             cfg.gi_steps)):
        march[label] = ((march_kernel.ray_table(cas, ro, rd, rt, cfg), meta,
                         cas.march_coarse, cas.march_fine0,
                         cas.march_fine1),
                        dict(r=cfg.cascade_resolution,
                             max_steps=steps * 2 + 16))
    return r, raster, march


def _turns(order, timers: dict, reps: int, dev) -> dict:
    """Times ``timers[name]`` at each name of ``order`` in turn."""
    out: dict = {name: [] for name in timers}
    for name in order:
        out[name].append(time_ms(timers[name], reps, dev))
    return out


def _print(label: str, times: dict, reps: int, card: str) -> None:
    for name, ms in times.items():
        print(f"{label} ({name}): " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms (CUDA events, mean of {reps}) [{card}]", flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--other", required=True, action="append",
                    help="root of another tree (e.g. _archive/parent); "
                         "repeat for more")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frame-reps", type=int, default=10)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false): the tool compares kernels on the card")
    dev = torch.device("cuda")
    card = card_line(dev)
    print(card, flush=True)
    builds = build(a.other)
    others = [n for n in builds if n != "this"
              and n not in {v[0] for v in VARIANTS}]
    r, (rargs, rkw), march = inputs(dev)
    result: dict = {"card": card}

    def order(names):
        mine = [n for n in names if n not in others and n != "this"]
        theirs = [n for n in others if n in names]
        return [*theirs, "this", *mine, *mine[::-1], "this", *theirs[::-1]]

    # kernel R: every build bit-equal to this tree's, then in turns
    rb = {n: b[1] for n, b in builds.items() if b[1] is not None}
    want = raster_call(rb["this"], rargs, rkw)
    for name, fn in rb.items():
        got = raster_call(fn, rargs, rkw)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            f"raster_tiles ({name}) differs from this tree's"
    timers = {n: (lambda fn=fn: raster_call(fn, rargs, rkw))
              for n, fn in rb.items()}
    for cap in CAPS:
        timers[f"this, cap {cap}"] = (
            lambda cap=cap: raster_call(rb["this"], rargs,
                                        dict(rkw, cap=cap)))
    result["raster_tiles"] = _turns(order(timers), timers, a.reps, dev)
    _print("raster_tiles", result["raster_tiles"], a.reps, card)

    # kernel M, on each ray set
    mb = {n: b for n, b in builds.items() if b[0] is not None}
    for label, (margs, mkw) in march.items():
        want = march_call(mb["this"][0], True, margs, mkw)
        for name, (fn, _, counter) in mb.items():
            got = march_call(fn, counter, margs, mkw)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                f"march_rays ({name}) differs from this tree's ({label})"
        timers = {n: (lambda fn=b[0], c=b[2]: march_call(fn, c, margs, mkw))
                  for n, b in mb.items()}
        key = f"march_rays {label}"
        result[key] = _turns(order(timers), timers, a.reps, dev)
        _print(key, result[key], a.reps, card)

    # the main-path frame without the host copy, with either tree's kernels
    this_lib = _cuda.library()
    om, orast, ocounter = builds[others[0]]
    swapped = types.SimpleNamespace(**vars(this_lib))
    if orast is not None:
        swapped.vri_raster_tiles = orast
    if om is not None:
        swapped.vri_march_rays = om if ocounter else (
            lambda *args: om(*args[:14], args[15]))
    libs = {others[0]: swapped, "this": this_lib}

    def frame(name):
        _cuda._lib = libs[name]
        try:
            return time_ms(lambda: r.render(gi=True, to_numpy=False),
                           a.frame_reps, dev)
        finally:
            _cuda._lib = this_lib

    result["frame"] = {others[0]: [], "this": []}
    for name in (others[0], "this", "this", others[0]):
        result["frame"][name].append(frame(name))
    _print("frame without the host copy", result["frame"], a.frame_reps,
           card)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "kernel_turns.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
