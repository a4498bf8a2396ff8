"""This tree's hand-written kernels against other trees', in turns, on one
CUDA card at the main path's shapes and the work-list tools' rows.

    python -m vri_tpu_torch.tools.kernel_turns --other DIR [--other DIR2 ...]
        [--kernels raster_tiles,march_rays,raster_ranged,bvh_traverse,
                   template_walk,setup_walk,grouped_step]
        [--reps 20] [--frame-reps 10]

Each ``DIR`` is the root of another checkout of this repository (for
example a parent commit unpacked with ``git archive``); the first is the
one the frames are compared with.  ``--kernels`` picks the kernels (all
by default): R (``raster_tiles``), M (``march_rays``), K6
(``raster_ranged``), ``bvh_traverse`` and the work-list kernels
``template_walk`` and ``setup_walk`` (both ``csrc/worklist.cu``) and
``grouped_step`` (``csrc/worklist_grouped.cu``).  The tool builds this
tree's kernels, each other tree's source of each picked kernel (from its
``vri_tpu_torch/csrc``, with the headers there that the source includes
and this tree's nvcc flags; a source equal to this tree's, headers
included, is skipped, and an older entry signature -- M or
``bvh_traverse`` without the ray counter, K6 without the pair counts --
is called as that tree's wrapper calls it), and variants of this tree's
sources that differ in one to three tuning constants (:data:`VARIANTS`;
a variant of a source serves every picked kernel built from it).  A
design that lost and left the sources is timed as an other tree: a copy
of ``vri_tpu_torch/csrc`` with that kernel's losing source in its place.
On the main path's stage (the 49k kitchen at 1920x1080, "room" SDF
preset) it holds every build bit-equal to this tree's kernel on the
inputs of ``chip_smoke.py``'s phases 3 (R: the frame's tile lists), 4
(K6: the ranged tier's chunks), 6 (M: the frame's shadow and GI rays)
and 12 (``bvh_traverse``: the 1080p camera rays and 2^18 random rays
with per-ray t_max, visit counts included); the work-list kernels on
the tools' rows of phases 15-17 (``micro_steps`` packed as T5,
``micro_worklist`` full-highest and full-2pass as T4, ``micro_attrib``
s0-s6 as T3, ``micro_pass1`` v0-v3 as T1, ``micro_grouped`` W 8 and 32
as T2), on the same work lists over covering triangle templates, on
the grouped step's forced-tie templates
(``worklist.grouped_tie_inputs``), and on
T5's and T4's runs renumbered longest first (:func:`longest_first`: the
same work without a long run at the launch's end; a ladder's
timing-only rungs are timed, not checked).  Then it times each
build with CUDA events in turns: the other trees', this tree's, the
variants, the variants again, this tree's, the other trees'.  A timed
call allocates what that tree's wrapper allocates (this tree's M and
``bvh_traverse`` also zero their ray counter).  Kernel R is also timed
with its lists cut at 128 and 256 slots (``cap``), which shows how much
of its time the longest lists take.  With a work-list kernel picked it
also times ``tools/lds_probe.cu``: warp-wide shared-memory loads of 4
and 16 bytes at one address, and of 16 bytes a thread.  Last it times
the frames without the host copy with the first other tree's kernels in
place of this tree's and with this tree's, in the turns other, this,
this, other: the main-path frame ``render(gi=True, to_numpy=False)``
when R or M is picked, the ranged frame (``backend="raster_ranged"``)
when K6 is, the BVH frame (``backend="bvh"``) when ``bvh_traverse`` is.

Prints the card line, the registers and spills ptxas reports, one line
per timing and, last, a JSON object of every number, which it also
writes to ``chiprun_out/kernel_turns.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import types

from vri_tpu_torch import _cuda
from vri_tpu_torch.tools import bvh_ray_sets, card_line, time_ms

KERNELS = ("raster_tiles", "march_rays", "raster_ranged", "bvh_traverse",
           "template_walk", "setup_walk", "grouped_step")
#: kernel -> (source under csrc/ without ".cu", C entry point)
SOURCES = {"raster_tiles": ("raster_tiles", "vri_raster_tiles"),
           "march_rays": ("march_rays", "vri_march_rays"),
           "raster_ranged": ("raster_ranged", "vri_raster_ranged"),
           "bvh_traverse": ("bvh_traverse", "vri_bvh_traverse"),
           "template_walk": ("worklist", "vri_worklist_walk"),
           "setup_walk": ("worklist", "vri_worklist_setup"),
           "grouped_step": ("worklist_grouped", "vri_worklist_grouped")}
#: the work-list kernels: timed on the tools' rows, no frame
WORKLIST = ("template_walk", "setup_walk", "grouped_step")
#: text of a source whose entry takes this tree's last pointer argument
#: (M's and bvh_traverse's ray counter, K6's pair counts)
_NEW_ENTRY = {"march_rays": "int* counter,", "raster_ranged": "int* pairs,",
              "bvh_traverse": "int* counter,"}
#: this tree's variants: (name, source, (constant as written,
#: replacement) for each constant changed); a variant of a source serves
#: every picked kernel built from it
VARIANTS = (("M refill every step", "march_rays",
             (("kRefillEvery = 4;", "kRefillEvery = 1;"),)),
            ("M refill every 2", "march_rays",
             (("kRefillEvery = 4;", "kRefillEvery = 2;"),)),
            ("M refill every 8", "march_rays",
             (("kRefillEvery = 4;", "kRefillEvery = 8;"),)),
            ("R 8 pixels a thread", "raster_tiles",
             (("kPx = 4;", "kPx = 8;"),)),
            ("R 2 pixels a thread", "raster_tiles",
             (("kPx = 4;", "kPx = 2;"),)),
            ("R without the shared column", "raster_tiles",
             (("kThreads % tile_w == 0 ?", "false ?"),)),
            ("K6 1 pixel a thread", "raster_ranged",
             (("kPx = 4;", "kPx = 1;"),)),
            ("K6 8 pixels a thread", "raster_ranged",
             (("kPx = 4;", "kPx = 8;"),)),
            ("walks 2 pixels a thread", "worklist",
             (("kPx = 4;", "kPx = 2;"),)),
            ("walks 8 pixels a thread", "worklist",
             (("kPx = 4;", "kPx = 8;"),)),
            ("walks in rows", "worklist",
             (("kColumnFirst = true;", "kColumnFirst = false;"),)),
            ("walks one lane a loop", "worklist",
             (("kLaneUnroll = 4;", "kLaneUnroll = 1;"),)),
            ("walks unrolled by 2 lanes", "worklist",
             (("kLaneUnroll = 4;", "kLaneUnroll = 2;"),)),
            ("grouped 2 pixels a thread", "worklist_grouped",
             (("kGroupPx = 4;", "kGroupPx = 2;"),)),
            ("grouped 8 pixels a thread", "worklist_grouped",
             (("kGroupPx = 4;", "kGroupPx = 8;"),)),
            ("grouped in rows", "worklist_grouped",
             (("kGroupColumnFirst = true;", "kGroupColumnFirst = false;"),)),
            ("grouped one lane a loop", "worklist_grouped",
             (("kGroupLaneUnroll = 4;", "kGroupLaneUnroll = 1;"),)),
            ("grouped unrolled by 2 lanes", "worklist_grouped",
             (("kGroupLaneUnroll = 4;", "kGroupLaneUnroll = 2;"),)))
#: kernel R timed with its lists cut short (not bit-equal: timing only)
CAPS = (128, 256)
#: frames timed with another tree's kernels: (label, kernels that pick
#: it, render arguments)
FRAMES = (("frame", ("raster_tiles", "march_rays"), {}),
          ("ranged frame", ("raster_ranged",),
           {"backend": "raster_ranged"}),
          ("BVH frame", ("bvh_traverse",), {"backend": "bvh"}))


def _entry_name(kernel: str) -> str:
    return SOURCES[kernel][1]


def _source_text(csrc: str, stem: str) -> str:
    """A source and the local headers it includes, as one text: two
    trees' builds of it differ only where this differs."""
    with open(os.path.join(csrc, f"{stem}.cu")) as f:
        text = f.read()
    for name in re.findall(r'#include "([^"]+)"', text):
        with open(os.path.join(csrc, name)) as f:
            text += f.read()
    return text


def _argtypes(kernel: str, new: bool):
    """ctypes argument types of a kernel's entry; ``new`` is false for an
    entry without this tree's last pointer (counter or pair counts)."""
    args = _cuda._ENTRIES[_entry_name(kernel)][1]
    if new or kernel == "raster_tiles":
        return args
    return args[:-2] + args[-1:]


def _old_call(fn):
    """An entry without the last pointer, called with this tree's
    arguments (the pointer dropped): for the frames' swapped library."""
    return lambda *a: fn(*a[:-2], a[-1])


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
        _print_ptxas(os.path.relpath(src), log)


def _print_ptxas(label: str, log: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" \
                in line:
            print(f"  ptxas ({label}): {line.strip()}")


def _entry(path: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(path), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def build(others, kernels) -> dict:
    """Build name ("this", each other tree by its directory's name, each
    variant) -> kernel -> (entry, takes this tree's last pointer)."""
    this = _cuda.library()
    work = os.path.join(_cuda.BUILD_DIR, "turns")
    shutil.rmtree(work, ignore_errors=True)
    builds = {"this": {k: (getattr(this, _entry_name(k)), True)
                       for k in kernels}}
    stems = sorted({SOURCES[k][0] for k in kernels})
    for stem in stems:
        _print_ptxas(f"this tree, {stem}.cu",
                     _cuda.compiler_log(f"{stem}.cu"))
    jobs, pending = [], []
    for other in others:
        name = os.path.basename(os.path.normpath(other))
        csrc = os.path.join(other, "vri_tpu_torch", "csrc")
        for stem in stems:
            text = _source_text(csrc, stem)
            if text == _source_text(_cuda.CSRC, stem):
                continue
            out = os.path.join(work, name, f"{stem}.so")
            jobs.append((os.path.join(csrc, f"{stem}.cu"), out))
            pending.append((name, stem, out, text))
    for i, (name, stem, changes) in enumerate(VARIANTS):
        if stem not in stems:
            continue
        d = os.path.join(work, f"v{i}")
        shutil.copytree(_cuda.CSRC, d)
        path = os.path.join(d, f"{stem}.cu")
        with open(path) as f:
            text = f.read()
        for old, new_text in changes:
            if old not in text:
                raise RuntimeError(f"{stem}.cu no longer holds {old!r}")
            text = text.replace(old, new_text)
        with open(path, "w") as f:
            f.write(text)
        out = os.path.join(d, f"{stem}.so")
        jobs.append((path, out))
        pending.append((name, stem, out, text))
    _compile_all(jobs)
    for name, stem, out, text in pending:
        for k in kernels:
            if SOURCES[k][0] == stem:
                new = _NEW_ENTRY.get(k, "") in text
                builds.setdefault(name, {})[k] = (
                    _entry(out, _entry_name(k), _argtypes(k, new)), new)
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


def raster_call(fn, _new: bool, rargs, rkw):
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


def ranged_call(fn, new: bool, kargs, kkw):
    """One call of a K6 entry as its tree's wrapper makes it (this
    tree's without the pair counts, as the ranged frame calls it)."""
    from vri_tpu_torch.ops import rasterize

    coef, order, ranges, words = kargs
    t = ranges.shape[0]
    out = rasterize._outputs(t, 1024, coef.device)
    _cuda.check(fn(coef.data_ptr(), order.data_ptr(), ranges.data_ptr(),
                   words.data_ptr(), t, kkw["n_global"], words.shape[1],
                   kkw["num_tx"], 8, 128, *(x.data_ptr() for x in out),
                   *([0] if new else []), _cuda.stream_ptr(coef)),
                "raster_ranged")
    return out


def bvh_call(fn, counter: bool, bargs, bkw, visits: bool = False):
    """One call of a ``bvh_traverse`` entry as its tree's wrapper makes
    it; with ``visits`` it also returns the per-ray visit counts."""
    import torch

    nodes, tris, o, d, tm = bargs
    n, dev = o.shape[0], o.device
    out = (torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev))
    if visits:
        out += (torch.empty((n, 2), dtype=torch.int32, device=dev),)
    count = [torch.zeros((1,), dtype=torch.int32, device=dev).data_ptr()] \
        if counter else []
    _cuda.check(fn(o.data_ptr(), d.data_ptr(), tm.data_ptr(), n,
                   nodes.data_ptr(), tris.data_ptr(), bkw["num_leaves"],
                   bkw["leaf_size"], *(x.data_ptr() for x in out[:4]),
                   out[4].data_ptr() if visits else 0, *count,
                   _cuda.stream_ptr(o)), "bvh_traverse")
    return out


def _rows(n: int, p: int, dev):
    """The wrappers' two output fills: (num_tiles, P) miss values."""
    import torch

    from vri_tpu_torch.ops import worklist

    return (torch.full((n, p), worklist.MISS_Z, device=dev),
            torch.full((n, p), -1, dtype=torch.int32, device=dev))


def walk_call(fn, _new: bool, wargs, wkw):
    """One call of a template-walk entry as the wrapper makes it."""
    from vri_tpu_torch.ops import worklist

    wt, wc, fl, chunks = wargs
    k6 = wkw["chunks_k6"]
    out = _rows(wkw["num_tiles"], wkw["p"], chunks.device)
    mode = worklist.WALK_KERNELS.index((wkw["evaluation"], wkw["packed"],
                                        wkw["stage"]))
    _cuda.check(fn(wt.data_ptr(), wc.data_ptr(), fl.data_ptr(), wt.shape[0],
                   chunks.data_ptr(), k6.data_ptr() if k6 is not None
                   else None, wkw["p"], chunks.shape[2] // 3, mode,
                   int(wkw["translate"]), *(x.data_ptr() for x in out),
                   _cuda.stream_ptr(chunks)), "template_walk")
    return out


def setup_call(fn, _new: bool, sargs, skw):
    """One call of a setup-walk entry as the wrapper makes it."""
    wt, wc, fl, chunks = sargs
    out = _rows(skw["num_tiles"], skw["p"], chunks.device)
    _cuda.check(fn(wt.data_ptr(), wc.data_ptr(), fl.data_ptr(), wt.shape[0],
                   chunks.data_ptr(), skw["p"], chunks.shape[2],
                   skw["variant"], *(x.data_ptr() for x in out),
                   _cuda.stream_ptr(chunks)), "setup_walk")
    return out


def grouped_call(fn, _new: bool, gargs, gkw):
    """One call of a grouped-step entry as the wrapper makes it."""
    import torch

    wc, chunks = gargs
    n, tc, w, p = wc.shape[0], chunks.shape[2] // 3, gkw["w"], gkw["p"]
    out = (torch.empty((n, tc // w, p), device=chunks.device),
           torch.empty((n, tc // w, p), dtype=torch.int32,
                       device=chunks.device))
    _cuda.check(fn(wc.data_ptr(), n, chunks.data_ptr(), p, tc, w,
                   *(x.data_ptr() for x in out), _cuda.stream_ptr(chunks)),
                "grouped_step")
    return out


_CALLS = {"raster_tiles": raster_call, "march_rays": march_call,
          "raster_ranged": ranged_call, "bvh_traverse": bvh_call,
          "template_walk": walk_call, "setup_walk": setup_call,
          "grouped_step": grouped_call}


def _defined(kw: dict) -> bool:
    """False for a ladder's timing-only rung (its rows are not checked)."""
    from vri_tpu_torch.ops import worklist

    return (kw.get("stage", worklist.FULL_STAGE) == worklist.FULL_STAGE
            and kw.get("variant", 3) in worklist.PASS1_DEFINED)


def longest_first(wt, wc, fl):
    """The runs of a tool's work list (every step live) with its tiles
    renumbered longest run first, as (wt, wc, fl): the same steps and
    chunks, so the same work, in the order that leaves no long run to the
    end of the launch (the tile ids move the outputs and the translated
    constants, not the work)."""
    import numpy as np
    import torch

    from vri_tpu_torch.ops import worklist

    s, e = (x.cpu().numpy() for x in worklist.work_runs(fl))
    lens = e - s + 1
    order = np.argsort(-lens, kind="stable")
    steps = np.concatenate([np.arange(s[i], e[i] + 1) for i in order])
    new_wt = np.repeat(np.arange(order.shape[0]), lens[order]).astype(
        np.int32)
    return tuple(torch.as_tensor(x, device=wt.device) for x in (
        new_wt, wc.cpu().numpy()[steps], worklist.flags(new_wt)))


def worklist_inputs(dev, kernels):
    """Per picked work-list kernel, {label: (args, kw)}: the tools' rows
    of ``chip_smoke.py``'s phases 15-17 (``micro_steps`` packed,
    ``micro_worklist`` full-highest and full-2pass, ``micro_attrib``
    s0-s6, ``micro_pass1`` v0-v3, ``micro_grouped`` W 8 and 32), the
    same work lists over chunks that cover their tiles, and the grouped
    step's forced-tie templates at W 8 and 32."""
    import torch

    from vri_tpu_torch.ops import worklist
    from vri_tpu_torch.tools import (covering_chunks, grouped_covering,
                                     micro_pass1, micro_steps)

    out = {}
    if "template_walk" in kernels:
        args = micro_steps.inputs(128, 4096, dev)
        covered = (args[0], args[0], args[2], torch.as_tensor(
            covering_chunks(range(2025), p=1024, tc=128), device=dev))
        k6 = worklist.k6_operand(args[3])
        rows = {}

        def row(label, a, evaluation, packed, translate=True, stage=5):
            rows[label] = (a, dict(
                num_tiles=2025, p=1024, evaluation=evaluation,
                translate=translate, packed=packed, stage=stage,
                chunks_k6=(k6 if a is args else worklist.k6_operand(a[3]))
                if evaluation == "k6" else None))

        row("T5 packed", args, "bf16x2", True)
        row("T4 full-highest", args, "f32", False)
        longest = (*longest_first(*args[:3]), args[3])
        row("T5 packed, longest runs first", longest, "bf16x2", True)
        row("T4 full-highest, longest runs first", longest, "f32", False)
        row("T4 full-2pass", args, "bf16x2", False)
        for stage in range(6):
            row(f"T3 s{stage}", args, "bf16x3", True, stage=stage)
        row("T3 s6", args, "k6", True)
        for evaluation, packed in (("f32", False), ("bf16x2", False),
                                   ("bf16x2", True), ("bf16x3", True),
                                   ("k6", True)):
            row(f"covering {evaluation} "
                f"{'packed' if packed else 'per-lane'}", covered,
                evaluation, packed)
        out["template_walk"] = rows
    if "setup_walk" in kernels:
        args = micro_pass1.inputs(dev)
        covered = (args[0], args[0], args[2], torch.as_tensor(
            covering_chunks(range(2025), p=1024, tc=128, setup=True),
            device=dev))
        kw = dict(num_tiles=micro_pass1.NT, p=1024)
        rows = {f"T1 v{v}": (args, dict(kw, variant=v))
                for v in worklist.PASS1_VARIANTS}
        rows["covering v3"] = (covered, dict(kw, num_tiles=2025, variant=3))
        out["setup_walk"] = rows
    if "grouped_step" in kernels:
        wc, chunks = (torch.as_tensor(x, device=dev)
                      for x in worklist.grouped_inputs(2048))
        rows = {f"T2 W {w}": ((wc, chunks), dict(w=w, p=1024))
                for w in (8, 32)}
        rows["covering W 8"] = (tuple(torch.as_tensor(x, device=dev)
                                      for x in grouped_covering(2048)),
                                dict(w=8, p=1024))
        for w in (8, 32):
            rows[f"forced ties W {w}"] = (tuple(
                torch.as_tensor(x, device=dev)
                for x in worklist.grouped_tie_inputs(2048, w=w, seed=w)),
                dict(w=w, p=1024))
        out["grouped_step"] = rows
    return out


def lds_probe(card: str, reps: int) -> dict:
    """Warp-wide shared-memory loads on the card (``tools/lds_probe.cu``):
    ms of a fixed count of loads of 4 bytes at one address for the whole
    warp, 16 bytes at one address, and 16 bytes at each thread's own
    address (4 wavefronts a load: the yardstick)."""
    import torch

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "lds_probe.cu")
    out = os.path.join(_cuda.BUILD_DIR, "turns", "lds_probe.so")
    _compile_all([(src, out)])
    fn = _entry(out, "vri_lds_probe", [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p])
    dev = torch.device("cuda")
    sink = torch.zeros((1,), device=dev)
    labels = ("4-byte broadcast", "16-byte broadcast",
              "16 bytes a thread")
    times = {}
    for mode, label in enumerate(labels):
        times[label] = time_ms(lambda mode=mode: _cuda.check(
            fn(mode, sink.data_ptr(), 0, _cuda.stream_ptr(sink)),
            "lds_probe"), reps, dev)
    loads = fn(0, None, 1, None)   # warp-wide loads a launch
    for label, ms in times.items():
        print(f"lds_probe {label}: {ms:.4f} ms for {loads} warp-wide loads "
              f"({loads / (ms * 1e6) / 132:.3f} a ns a SM) [{card}]",
              flush=True)
    return dict(times, warp_loads=loads)



def inputs(dev, kernels):
    """The renderer and, per picked kernel, {label: (args, kw)}: phases 3
    (R), 4 (K6), 6 (M) and 12 (``bvh_traverse``) of chip_smoke.py."""
    import torch

    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.ops import bvh, gi, march_kernel, rasterize, raygen
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
    rargs = (world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj)
    out = {}
    if "raster_tiles" in kernels:
        prep = rasterize.prepare_sorted(*rargs, height=h, width=w,
                                        cull_sign=cull)
        out["raster_tiles"] = {"lists": (
            (prep["coef"], prep["lists"], prep["starts"], prep["counts"]),
            dict(num_tx=prep["num_tx"], cap=prep["cap"]))}
    if "raster_ranged" in kernels:
        prep = rasterize.prepare_ranged(*rargs, height=h, width=w,
                                        cull_sign=cull)
        out["raster_ranged"] = {"chunks": (
            (prep["coef"], prep["order"], prep["ranges"], prep["words"]),
            dict(n_global=prep["n_global"], num_tx=prep["num_tx"]))}
    if "bvh_traverse" in kernels:
        accel = bvh.build_bvh(world, r.scene.tri_vertices, r.scene.num_faces)
        kw = dict(num_leaves=accel.num_leaves, leaf_size=accel.leaf_size)
        out["bvh_traverse"] = {
            label: ((accel.nodes, accel.tris) + rays, kw)
            for label, rays in bvh_ray_sets(r, h, w).items()}
    if "march_rays" in kernels:
        cas = r.ensure_cascades(eye=r.camera.eye)
        o, d = raygen.camera_rays(fp.inv_view_proj, fp.eye, h, w)
        hit, _ = rasterize.rasterize_sorted(*rargs, height=h, width=w,
                                            cull_sign=cull)
        gb = shading.resolve_gbuffer(r.scene, world, hit, o.reshape(-1, 3),
                                     d.reshape(-1, 3), fp.pixel_spread)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        u = torch.rand((h * w, 2), generator=gen, device=dev)
        meta = march_kernel.pack_meta(cas, cfg)
        march = {}
        for label, (ro, rd, rt), steps in (
                ("shadow", gi.shadow_rays(gb.position, gb.normal, r.scene,
                                          cas, cfg), cfg.shadow_steps),
                ("gi", gi.gi_rays(gb.position, gb.normal, u, cas, cfg),
                 cfg.gi_steps)):
            march[label] = ((march_kernel.ray_table(cas, ro, rd, rt, cfg),
                             meta, cas.march_coarse, cas.march_fine0,
                             cas.march_fine1),
                            dict(r=cfg.cascade_resolution,
                                 max_steps=steps * 2 + 16))
        out["march_rays"] = march
    return r, out


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


def _equal(got, want) -> bool:
    import torch

    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--other", required=True, action="append",
                    help="root of another tree (e.g. _archive/parent); "
                         "repeat for more")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to compare (default: "
                         "all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frame-reps", type=int, default=10)
    a = ap.parse_args(argv)
    kernels = tuple(k for k in KERNELS if k in a.kernels.split(","))
    unknown = set(a.kernels.split(",")) - set(KERNELS)
    if unknown or not kernels:
        raise SystemExit(f"--kernels: unknown {sorted(unknown)}; pick from "
                         f"{', '.join(KERNELS)}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false): the tool compares kernels on the card")
    dev = torch.device("cuda")
    card = card_line(dev)
    print(card, flush=True)
    builds = build(a.other, kernels)
    names = [os.path.basename(os.path.normpath(o)) for o in a.other]
    others = [n for n in names if n in builds]
    render = [k for k in kernels if k not in WORKLIST]
    r, sets = inputs(dev, render) if render else (None, {})
    sets.update(worklist_inputs(dev, kernels))
    result: dict = {"card": card}
    if set(kernels) & set(WORKLIST):
        result["lds_probe"] = lds_probe(card, a.reps)

    def order(names):
        mine = [n for n in names if n not in others and n != "this"]
        theirs = [n for n in others if n in names]
        return [*theirs, "this", *mine, *mine[::-1], "this", *theirs[::-1]]

    for k in kernels:
        call = _CALLS[k]
        kb = {n: b[k] for n, b in builds.items() if k in b}
        for label, (args, kw) in sets[k].items():
            # every build bit-equal to this tree's (bvh_traverse with its
            # visit counts; a ladder's timing-only rungs are not checked)
            extra = {"bvh_traverse": dict(visits=True)}.get(k, {})
            want = call(*kb["this"], args, kw, **extra)
            for name, (fn, new) in kb.items():
                got = call(fn, new, args, kw, **extra)
                assert not _defined(kw) or _equal(got, want), \
                    f"{k} ({name}) differs from this tree's on {label}"
            timers = {n: (lambda fn=fn, new=new: call(fn, new, args, kw))
                      for n, (fn, new) in kb.items()}
            if k == "raster_tiles":
                for cap in CAPS:
                    timers[f"this, cap {cap}"] = (
                        lambda cap=cap: call(*kb["this"], args,
                                             dict(kw, cap=cap)))
            key = f"{k} {label}"
            result[key] = _turns(order(timers), timers, a.reps, dev)
            _print(key, result[key], a.reps, card)
    if "raster_ranged" in kernels:
        from vri_tpu_torch.ops import rasterize

        args, kw = sets["raster_ranged"]["chunks"]
        tested = rasterize.raster_ranged(*args, **kw, pairs=True)[4]
        result["raster_ranged pairs tested"] = int(tested.sum())
        print(f"raster_ranged tests {int(tested.sum())} (tile, slot) pairs "
              f"(this tree)", flush=True)

    # the frames without the host copy, with either tree's kernels
    this_lib = _cuda.library()
    swapped = types.SimpleNamespace(**vars(this_lib))
    theirs = builds.get(others[0], {}) if others else {}
    for k, (fn, new) in theirs.items():
        setattr(swapped, _entry_name(k), fn if new else _old_call(fn))
    libs = {names[0]: swapped, "this": this_lib}
    for label, picked, kw in FRAMES:
        if not set(picked) & set(kernels):
            continue

        def frame(name, kw=kw):
            _cuda._lib = libs[name]
            try:
                return time_ms(lambda: r.render(gi=True, to_numpy=False,
                                                **kw), a.frame_reps, dev)
            finally:
                _cuda._lib = this_lib

        times = {names[0]: [], "this": []}
        for name in (names[0], "this", "this", names[0]):
            times[name].append(frame(name))
        result[label] = times
        _print(f"{label} without the host copy", times, a.frame_reps, card)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "kernel_turns.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
