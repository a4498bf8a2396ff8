"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- one static-stage GI frame as
``vri_tpu_torch.renderer.Renderer.render(gi=True)`` runs it -- at the size
a user runs: the 49k-triangle kitchen stage, 1920x1080, the "room" SDF
preset; then the other paths: the ranged tier, the BVH backend, the app's
default frame, a city-scale stage and the direct-only frame; then the
work-list micro-benchmarks' kernels, each through its tool's own row at
the tool's full shape.  The JAX package and JAX itself are blocked
before the port is imported, so any import of either is fatal.  Phases
(run in the order 1-8, 12, 13, 9-11, 14-17), each fatal on failure:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the kernels in ``vri_tpu_torch/csrc`` with nvcc, one
   process per source, all at once; prints each source's ptxas registers
   and spills (``_cuda.compiler_log``) and fails where there are none;
3. kernel R (``raster_tiles``) against its plain PyTorch version on the
   frame's real tile lists: slots, z, u and v bit-equal; the lists'
   length distribution (mean, p50, p99, longest, the pairs' share in the
   longest 1% of tiles);
4. kernel K6 (``raster_ranged``) against its plain version on the same
   frame's chunks: slots, z, u, v and each tile's tested (tile, slot)
   pairs bit-equal, the pairs equal per tile to the sorted prep's lists
   (K6 culls each slot to its tile span); both times;
5. tiers on the card: on the kitchen at 1080p the sorted and ranged tiers
   give bit-equal ``HitRecord`` tri, t, u and v; on ``kitchen_stress(256,
   tess=1)`` at 512x512 (the binned tier's shape) the sorted, binned and
   ranged tiers do; each tier's whole raster time (setup to HitRecord) at
   both shapes; kernel R on the binned tier's lists at 512x512 (K5's walk)
   bit-equal to its plain version, both times, and its bound on the
   (tile, slot) pairs that overlap;
6. kernel M (``march_rays``) against its plain version on the frame's real
   shadow and GI rays: t, hit voxel, iterations and activity exactly equal;
   per ray set the steps' mean and maximum, the warp step efficiency of
   one ray a lane in launch order (``march_kernel.warp_step_efficiency``)
   and the persistent lanes and refills of the launch;
7. main path: build the SDF cascades and render three frames with every
   launch counter reset first; checks zero raster overflow, zero SDF list
   drops, finite colour, >50% coverage, and that the counters account for
   every raster pass and every march;
8. the ladder's last rung: one ``render(gi=True, backend="raster_ranged")``
   frame of the same stage, counters reset first: exactly one
   ``raster_ranged`` launch, and ``instance_id`` and ``color`` equal to
   the sorted-tier frame's with the same GI uniforms;
9. the app's default frame: the Cornell box at 512x512, room preset,
   through ``render(gi=True)``: the binned tier, its ``raster_tiles``
   launch counted, zero overflow, finite colour;
10. agreement on a small input: Cornell box at 64^2 rendered on the card
    and, with the plain versions, on the CPU;
11. city: ``bench.py``'s city stage (4,500 instanced towers, 1.35M faces)
    at 1920x1080 without LOD chains: frustum-compacted raster frames,
    escalating the capacities as the renderer's ladder does until a frame
    reports no overflow; then three frames at that scale (zero overflow,
    ``raster_tiles`` counted), the compacted ``HitRecord`` equal to an
    uncompacted sorted raster of the frame; the live face count, the
    longest tile list, the ladder, frame times and peak memory;
12. kernel ``bvh_traverse`` against its plain version on the main path's
    stage (LBVH of 8,192 leaves): the 1920x1080 camera rays and 2^18
    random rays with per-ray t_max; t, slot, u, v and the per-ray visit
    counts bit-equal; kernel and plain times, ``build_bvh`` time, node
    pops and triangle tests per ray, the launch's persistent lanes and
    refills, and the bound;
13. the BVH GI frame: ``render(gi=True, backend="bvh")`` on phase 7's
    renderer (no second SDF build) with phase 8's GI uniforms, counters
    reset first: exactly one ``bvh_traverse`` launch, two ``march_rays``
    and no raster launch; finite colour, > 50% coverage, the share of
    pixels whose ``instance_id`` equals the sorted-tier frame's (the BVH
    does no backface culling, so it is printed, not held to equality) and
    the frame time with and without the host copy;
14. the direct-only frame: the Cornell box at 512x512 through
    ``render(gi=False)`` with ``backend="raster"`` and ``"bvh"``: finite
    colour, zero raster overflow, ``instance_id`` equal on >= 99% of the
    pixels;
15. kernel ``template_walk``: the rows of ``vri_tpu_torch.tools.
    micro_steps`` (packed, P 1024, TC 128, 4096 steps), ``micro_worklist``
    (full-highest, full-2pass) and ``micro_attrib`` (s5, s6), each with
    the counters reset first (only ``template_walk`` launched), then held
    bit for bit against its plain version on the row's inputs; then the
    same work list over covering triangle templates in five modes, each
    held the same way and timed beside its share of hits;
16. kernel ``setup_walk``: ``micro_pass1``'s v3 row (5,313 steps), the
    same way, and its work list over covering triangles, timed;
17. kernel ``grouped_step``: ``micro_grouped``'s W = 8 and 32 rows (2,048
    steps), the same way (the entry's ``rows`` list both; its ptxas
    registers and spills are phase 2's ``worklist_grouped.cu`` lines);
    then chunks that cover tile 0 at W = 8 and the forced-tie templates
    (``worklist.grouped_tie_inputs``: key ties won by a larger z, exact z
    ties) at W = 1, 8, 32 and 128, each held bit for bit and timed.

Each kernel's entry in the JSON line carries its time, its plain
version's, its launches on the main path and its bound: the larger of the
bytes it must move (inputs read once, outputs written once) over the
H100's 3.35 TB/s and the FP32 operations this run's data needs over its
67 TFLOP/s (non-tensor peak), from the counts noted at each kernel.  No
single PyTorch call computes any of the seven, so ``library_ms`` is
null.

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

# the port must run without the JAX package and without JAX
sys.modules["vri_tpu"] = None
sys.modules["jax"] = None

#: published H100 SXM peaks (FP32 outside the tensor cores, HBM3)
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


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


def _wrappers() -> dict:
    from vri_tpu_torch.ops import bvh, march_kernel, rasterize, worklist

    return {"raster_tiles": rasterize.raster_tiles,
            "raster_ranged": rasterize.raster_ranged,
            "march_rays": march_kernel.march_rays,
            "bvh_traverse": bvh.bvh_traverse,
            "template_walk": worklist.template_walk,
            "setup_walk": worklist.setup_walk,
            "grouped_step": worklist.grouped_step}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _launches(**nonzero) -> dict:
    """Expected counts: ``nonzero`` for the named kernels, 0 for all."""
    return {name: nonzero.get(name, 0) for name in _wrappers()}


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the FP32 operations over the FP32 peak."""
    t_bytes = 1e3 * nbytes / H100_BYTES_PER_S
    t_ops = 1e3 * ops / H100_FP32_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(nbytes), ops=int(ops))


def _nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


# FP32 operations per unit of work, counted from the kernels' sources:
# a (pixel, slot) test of raster_common.cuh:slot_key (frame offset 2,
# depth field 4, three edge functions 21, their sign tests 6, depth range
# 2); the winner's (u, v) per covered pixel (three fields 12, offsets 2,
# guard and reciprocal 2, two products); one march step of march_rays.cu
# (position 6, cascade search 12 per cascade, six axis exits 36, minima 8,
# advance 10); one node pop of bvh_traverse.cu (one slab test, 25: the
# popped node's, which the kernel runs when the node is pushed) and one
# triangle test (Moller-Trumbore 54).  Tests of children that miss and
# are never pushed are not counted, so the bvh count is a lower bound.
OPS_SLOT_TEST = 35
OPS_UV = 18
OPS_MARCH_STEP = 60
OPS_MARCH_CASCADE = 12
OPS_NODE_POP = 25
OPS_TRI_TEST = 54


def _bound_raster_tiles(coef, starts, counts, cap, out) -> dict:
    used = counts.clamp(max=cap)
    tile_px = out[0].numel() // counts.numel()
    tests = float(used.double().sum()) * tile_px
    covered = float((out[1] >= 0).sum())
    nbytes = (_nbytes(coef, starts, counts) + 4 * float(used.double().sum())
              + _nbytes(*out))
    return _bound(nbytes, OPS_SLOT_TEST * tests + OPS_UV * covered)


def _chunk_slots(prep) -> float:
    """(tile, slot) pairs K6 walks: every slot of the global chunks and of
    the chunks in a tile's range whose bit is set."""
    import torch

    words, ranges = prep["words"], prep["ranges"]
    n_words = words.shape[1]
    bit = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = ((words[:, :, None] >> bit) & 1).reshape(words.shape[0],
                                                   32 * n_words) > 0
    c = torch.arange(32 * n_words, device=words.device)[None, :]
    walked = (c < prep["n_global"]) | ((c >= ranges[:, :1])
                                       & (c < ranges[:, 1:2]))
    return 128 * float((bits & walked).double().sum())


def _bound_raster_ranged(rprep, pair_counts, out) -> dict:
    """K6 computes the sorted raster's function (phase 5 holds the tiers'
    hits equal), so the work it needs is R's on the same frame: the
    (tile, triangle) pairs that overlap, ``pair_counts`` of the sorted
    prep, not the 128-slot chunks that K6 walks.  Its bytes are its own
    inputs and outputs."""
    tile_px = out[0].numel() // pair_counts.numel()
    tests = float(pair_counts.double().sum()) * tile_px
    covered = float((out[1] >= 0).sum())
    nbytes = (_nbytes(rprep["coef"], rprep["order"], rprep["ranges"],
                      rprep["words"]) + _nbytes(*out))
    return _bound(nbytes, OPS_SLOT_TEST * tests + OPS_UV * covered)


def _bound_march(args, out, n_cas: int) -> dict:
    steps = float(out[2].double().sum())
    return _bound(_nbytes(*args) + _nbytes(*out),
                  (OPS_MARCH_STEP + OPS_MARCH_CASCADE * n_cas) * steps)


def _bound_bvh(args, out) -> dict:
    visits = out[4].double().sum(0)
    return _bound(_nbytes(*args) + _nbytes(*out[:4]),
                  OPS_NODE_POP * float(visits[0])
                  + OPS_TRI_TEST * float(visits[1]))


# FP32 operations of one (pixel, lane) test of the work-list walks in
# the FP32 affine form (worklist_common.cuh; the bf16 split emulation is
# not counted): three fields of two products and two sums (12), the
# coverage chain (two minima, a sum, three compares: 6), the select and
# the update compare (2); one lane's triangle setup in the setup walk
# (worklist.cu:setup_lane): 44.
OPS_WORKLIST_TEST = 20
OPS_SETUP_LANE = 44


def _worklist_tests(fl, p: int, tc: int) -> float:
    """(pixel, lane) tests of a work list: its live steps inside tile runs
    times P times TC."""
    from vri_tpu_torch.ops import worklist

    starts, ends = worklist.work_runs(fl)
    return float(worklist.walk_steps(starts, ends, fl).numel()) * p * tc


def _held(name: str, got, plain) -> tuple:
    """Hold kernel outputs ``got`` against ``plain()`` bit for bit; returns
    (the plain version's ms, CUDA events, one run; max abs error)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    stop.record()
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        _check(torch.equal(g, w), f"{name}: output {k} differs from the "
               "plain version")
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    return start.elapsed_time(stop), err


def _drive(name: str, fn):
    """Run one tool's row with every counter reset first; returns the
    row and its launches of ``name`` (and of no other kernel)."""
    _reset_counts()
    row = fn()
    launches = _counts()
    _check(launches[name] > 0 and sum(launches.values()) == launches[name],
           f"{name}: launch counts {launches}")
    return row, launches[name]


def _hold_covered(name: str, call, plain, card: str,
                  inputs: str = "covering triangle templates") -> dict:
    """Hold ``call()`` against ``plain()`` on ``inputs`` (covering triangle
    templates); prints and returns the kernel's time (CUDA events, mean of
    20) beside the share of outputs that hit."""
    got = call()
    _held(name, got, plain)
    ms = _time_ms(call, 20)
    hit = float((got[1] >= 0).double().mean())
    print(f"{name} on {inputs}: {ms:.4f} ms, {hit:.4f} "
          f"of the outputs hit, equal to the plain version [{card}]")
    return dict(ms=ms, hit=hit)


def _ptxas(source: str) -> list:
    """ptxas's register and spill lines from the build of one source."""
    from vri_tpu_torch import _cuda

    return [line.strip() for line in _cuda.compiler_log(source).splitlines()
            if "registers" in line or "spill" in line]


def _worklist(dev, card: str, kernels: dict) -> None:
    """The work-list kernels at their tools' full shapes (phases 15-17):
    each tool's row drives its kernel with the counters reset, then the
    kernel is held bit for bit against its plain version on the row's
    inputs."""
    import torch

    from vri_tpu_torch.ops import worklist
    from vri_tpu_torch.tools import (covering_chunks, grouped_covering,
                                     micro_attrib, micro_grouped,
                                     micro_pass1, micro_steps,
                                     micro_worklist)

    # -- 15. template walk: micro_steps packed, micro_worklist full-highest
    # and full-2pass, micro_attrib s5 and s6 ---------------------------------
    entry, total = None, 0
    rows = (("micro_steps packed P=1024 TC=128 n_work=4096", "bf16x2", True,
             lambda: micro_steps.run(1024, 128, 4096, dev, variant="packed")),
            ("micro_worklist full-highest", "f32", False,
             lambda: micro_worklist.run("full-highest", dev)),
            ("micro_worklist full-2pass", "bf16x2", False,
             lambda: micro_worklist.run("full-2pass", dev)),
            ("micro_attrib s5", "bf16x3", True,
             lambda: micro_attrib.run(5, dev)),
            ("micro_attrib s6", "k6", True, lambda: micro_attrib.run(6, dev)))
    for label, evaluation, packed, fn in rows:
        row, n = _drive("template_walk", fn)
        total += n
        args, k6 = row["args"], row.get("kw", {}).get("chunks_k6")
        kw = dict(num_tiles=micro_steps.NUM_TILES, p=1024,
                  evaluation=evaluation, translate=True, packed=packed,
                  chunks_k6=k6)
        got = worklist.template_walk(*args, **kw)
        plain_ms, err = _held("template_walk", got,
                              lambda: worklist.template_walk_reference(
                                  *args, **kw))
        b = _bound(_nbytes(*args, *([] if k6 is None else [k6]))
                   + _nbytes(*got),
                   OPS_WORKLIST_TEST * _worklist_tests(args[2], 1024, 128))
        print(f"template_walk ({label}): {n} launches, equal to the plain "
              f"version; {row['ms']:.3f} ms vs plain {plain_ms:.1f} ms, "
              f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['ops'] / 1e9:.2f} GFLOP, {b['bytes'] / 1e6:.1f} MB); "
              f"{float((got[1] >= 0).double().mean()):.5f} of pixels hit "
              f"[{card}]")
        if entry is None:
            entry = dict(route="cuda", source="vri_tpu_torch/csrc/worklist.cu",
                         replaces="tools/micro_steps.py:255",
                         also_replaces="tools/micro_steps.py:23, :136; "
                                       "tools/micro_worklist.py:22; "
                                       "tools/micro_attrib.py:44",
                         max_abs_err=err, ms=row["ms"], plain_ms=plain_ms,
                         library_ms=None, rows={}, **b)
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["rows"][label] = dict(
                ms=row["ms"], plain_ms=plain_ms, bound_ms=b["bound_ms"])
    entry["launches"] = total
    kernels["template_walk"] = entry
    # the same work list over chunks that cover its tiles
    wt, _, fl, _ = micro_steps.inputs(128, 4096, dev)
    covered = (wt, wt, fl, torch.as_tensor(
        covering_chunks(range(2025), p=1024, tc=128), device=dev))
    for evaluation, packed in (("f32", False), ("bf16x2", False),
                               ("bf16x2", True), ("bf16x3", True),
                               ("k6", True)):
        kw = dict(num_tiles=2025, p=1024, evaluation=evaluation,
                  translate=True, packed=packed,
                  chunks_k6=worklist.k6_operand(covered[3])
                  if evaluation == "k6" else None)
        label = (f"covering {evaluation} "
                 f"{'packed' if packed else 'per-lane'}")
        entry["rows"][label] = _hold_covered(
            f"template_walk ({label[9:]})",
            lambda: worklist.template_walk(*covered, **kw),
            lambda: worklist.template_walk_reference(*covered, **kw), card)

    # -- 16. setup walk: micro_pass1 v3 ------------------------------------
    row, n = _drive("setup_walk", lambda: micro_pass1.run(3, dev))
    args = row["args"]
    got = micro_pass1.call(args, 3, **row["kw"])
    plain_ms, err = _held("setup_walk", got,
                          lambda: worklist.setup_walk_reference(
                              *args, num_tiles=row["kw"]["nt"], variant=3))
    steps = _worklist_tests(args[2], 1024, 128) / (1024 * 128)
    b = _bound(_nbytes(*args) + _nbytes(*got),
               OPS_WORKLIST_TEST * steps * 1024 * 128
               + OPS_SETUP_LANE * steps * 128)
    print(f"setup_walk (micro_pass1 v3, {int(steps)} live steps): {n} "
          f"launches, equal to the plain version; {row['ms']:.3f} ms vs "
          f"plain {plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']}; {float((got[1] >= 0).double().mean()):.5f} of "
          f"pixels hit [{card}]")
    wt, _, fl, _ = args
    covered = (wt, wt, fl, torch.as_tensor(
        covering_chunks(range(2025), p=1024, tc=128, setup=True),
        device=dev))
    cover = _hold_covered(
        "setup_walk", lambda: worklist.setup_walk(*covered, num_tiles=2025),
        lambda: worklist.setup_walk_reference(*covered, num_tiles=2025),
        card)
    kernels["setup_walk"] = dict(
        route="cuda", source="vri_tpu_torch/csrc/worklist.cu",
        replaces="tools/micro_pass1.py:33", launches=n, max_abs_err=err,
        ms=row["ms"], plain_ms=plain_ms, library_ms=None,
        rows={"covering v3": cover}, **b)

    # -- 17. grouped step: micro_grouped W = 8 and 32 -----------------------
    entry, total = None, 0
    for w in (8, 32):
        row, n = _drive("grouped_step",
                        lambda w=w: micro_grouped.bench(w, 2048, dev))
        total += n
        args, kw = row["args"], row["kw"]
        got = worklist.grouped_step(*args, **kw)
        plain_ms, err = _held("grouped_step", got,
                              lambda: worklist.grouped_step_reference(
                                  *args, **kw))
        b = _bound(_nbytes(*args) + _nbytes(*got),
                   OPS_WORKLIST_TEST * float(args[0].numel()) * 1024 * 128)
        print(f"grouped_step (W={w}, 2048 steps): {n} launches, equal to "
              f"the plain version; {row['ms']:.3f} ms vs plain "
              f"{plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} ({b['ops'] / 1e9:.2f} GFLOP, "
              f"{b['bytes'] / 1e6:.1f} MB); "
              f"{float((got[1] >= 0).double().mean()):.5f} hit [{card}]")
        if entry is None:
            entry = dict(route="cuda",
                         source="vri_tpu_torch/csrc/worklist_grouped.cu",
                         replaces="tools/micro_grouped.py:32",
                         max_abs_err=err, ms=row["ms"], plain_ms=plain_ms,
                         library_ms=None, rows={}, **b)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["rows"][f"W={w}"] = dict(ms=row["ms"], plain_ms=plain_ms,
                                       bound_ms=b["bound_ms"])
    entry["launches"] = total
    kernels["grouped_step"] = entry
    covered = tuple(torch.as_tensor(x, device=dev)
                    for x in grouped_covering(2048))
    entry["rows"]["covering W=8"] = _hold_covered(
        "grouped_step (W=8)", lambda: worklist.grouped_step(*covered, w=8),
        lambda: worklist.grouped_step_reference(*covered, w=8), card)
    # the forced-tie templates: key ties won by a larger z, exact z ties
    for w in (1, 8, 32, 128):
        ties = tuple(torch.as_tensor(x, device=dev) for x in
                     worklist.grouped_tie_inputs(2048, w=w, seed=w))
        entry["rows"][f"forced ties W={w}"] = _hold_covered(
            f"grouped_step (W={w})",
            lambda: worklist.grouped_step(*ties, w=w),
            lambda: worklist.grouped_step_reference(*ties, w=w), card,
            inputs="forced-tie templates")


def _tagged(fn, tag: str, log: list):
    """``fn`` that appends ``tag`` to ``log`` on every call."""
    def run(*args, **kw):
        log.append(tag)
        return fn(*args, **kw)
    return run


def _city(dev, card: str) -> None:
    """bench.py's city row (``bench.py:327-343``) without LOD chains:
    frustum-compacted raster frames at 1920x1080, at the capacities the
    renderer's overflow ladder settles on."""
    import torch

    from vri_tpu_torch import RenderConfig, SceneLimits, scenes
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    h, w = 1080, 1920
    t0 = time.perf_counter()
    stage = scenes.city_stress(num_buildings=4500, tess=5, num_protos=24)
    t1 = time.perf_counter()
    lim = SceneLimits(max_instances=8192, max_vertices=1 << 22,
                      max_faces=1 << 22)
    d = RenderDelegate(RenderConfig(width=w, height=h, limits=lim,
                                    lod_levels=0), device=dev)
    d.populate(stage)
    scene = d.sync()
    t2 = time.perf_counter()
    world = bake_world(scene)
    fp = frame_mod.FrameParams.from_camera(d.camera, h, device=dev)
    pool = int(scene.tri_vertices.shape[0])
    _check(pool >= frame_mod._CULL_COMPACT_MIN_POOL,
           f"city pool of {pool} faces is below the compaction threshold")
    face_ids, live, pair_inst, _ = frame_mod._compact_visible_faces(
        scene, fp.view_proj, 1 << 20)
    inst_sign = frame_mod._cull_sign_instance(scene)
    counts = rasterize.prepare_sorted(
        world, scene.tri_vertices[face_ids.long()], live, fp.view_proj,
        height=h, width=w, cap=4096, pairs_cap=1 << 20, src_map=face_ids,
        cull_sign=(None if inst_sign is None
                   else inst_sign[pair_inst.long()]))["counts"]
    live, longest = int(live), int(counts.max())
    over_4096 = int((counts > 4096).sum())
    del face_ids, pair_inst, counts

    def frame(scale):
        return frame_mod._visibility_raster(
            scene, world, fp, h, w, caps_scale=scale, lod_tau=0.0,
            cull_instances=True, compact_cap=1 << 20)

    # the renderer's ladder: an overflowed frame doubles the capacities
    scale = 1
    ladder = []
    while True:
        over = int(frame(scale).overflow)
        ladder.append((scale, over))
        if not over:
            break
        scale *= 2
        _check(scale <= 4, f"city: overflow at 4x capacities ({ladder})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times = []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        hit = frame(scale)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        _check(int(hit.overflow) == 0, f"city frame {i} at {scale}x: "
               f"overflow {int(hit.overflow)}")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    _check(launches == _launches(raster_tiles=3),
           f"city: launch counts {launches}")
    full, _ = rasterize.rasterize_sorted(
        world, scene.tri_vertices, scene.num_faces, fp.view_proj, height=h,
        width=w, cap=4096, pairs_cap=1 << 22, caps_scale=scale,
        cull_sign=frame_mod._cull_sign(scene))
    _check(int(full.overflow) == 0, "city: the uncompacted raster overflowed")
    for key in ("tri", "t", "u", "v"):
        _check(torch.equal(getattr(hit, key), getattr(full, key)),
               f"city: compacted {key} differs from the uncompacted raster")
    cov = float((hit.tri >= 0).float().mean())
    print(f"city: {int(scene.num_faces)} faces in a pool of {pool}, "
          f"{int(scene.num_instances)} instances; authoring {t1 - t0:.1f} s, "
          f"sync {t2 - t1:.1f} s (host clock); {live} live faces after the "
          f"frustum cull; longest tile list {longest} pairs, {over_4096} "
          f"tiles over 4096; ladder (caps_scale, overflow) {ladder}; "
          f"coverage {cov:.4f}, equal to the uncompacted raster [{card}]")
    print(f"  compacted raster frames at {scale}x: "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms (CUDA events), 0 overflow, launches {launches}, peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")


def _bvh_kernel(r, h: int, w: int, card: str) -> dict:
    """Kernel ``bvh_traverse`` against its plain version on the LBVH of
    renderer ``r``'s stage: the camera rays of the main path's frame and
    2^18 random rays with per-ray t_max."""
    import torch

    from vri_tpu_torch.ops import bvh
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.tools import bvh_ray_sets

    scene = r.scene
    world = bake_world(scene)
    accel = bvh.build_bvh(world, scene.tri_vertices, scene.num_faces)
    build_ms = _time_ms(lambda: bvh.build_bvh(world, scene.tri_vertices,
                                              scene.num_faces), 5)
    nodes, tris = accel.nodes, accel.tris
    ray_sets = bvh_ray_sets(r, h, w)
    kw = dict(num_leaves=accel.num_leaves, leaf_size=accel.leaf_size)
    entry = None
    for label, rays in ray_sets.items():
        args = (nodes, tris) + rays
        got = bvh.bvh_traverse(*args, visits=True, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = bvh.bvh_traverse_reference(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        for name, g, wv in zip(("t", "slot", "u", "v", "visits"), got, want):
            _check(torch.equal(g, wv), f"bvh_traverse {name} differs from "
                   f"the plain version on the {label} rays")
        err = max(float((g.double() - wv.double()).abs().max())
                  for g, wv in zip(got[:4], want[:4]))
        ms = _time_ms(lambda: bvh.bvh_traverse(*args, **kw), 10)
        b = _bound_bvh(args, got)
        vis = got[4].double().mean(0)
        n = rays[0].shape[0]
        lanes = bvh.persistent_lanes(n)
        print(f"bvh_traverse ({label}): {n} rays, "
              f"{float((got[1] >= 0).double().mean()):.3f} hit, mean "
              f"{float(vis[0]):.1f} node pops and {float(vis[1]):.1f} "
              f"triangle tests per ray (longest walk {int(got[4][:, 0].max())}"
              f" pops); {lanes} persistent lanes, {max(n - lanes, 0)} "
              f"refills; t/slot/u/v/visits equal to the plain "
              f"version; {ms:.3f} ms vs plain {plain_ms:.1f} ms (CUDA "
              f"events, kernel mean of 10), bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} [{card}]")
        if entry is None:
            # the main path's shape: the frame's camera rays
            entry = dict(route="cuda", source="vri_tpu_torch/csrc/bvh_traverse.cu",
                         replaces="vri_tpu/ops/bvh_kernel.py:71",
                         also_replaces="vri_tpu/ops/bvh.py:160 (traverse)",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, **b)
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    print(f"build_bvh: {int(scene.num_faces)} triangles, "
          f"{accel.num_leaves} leaves, {build_ms:.3f} ms (CUDA events, mean "
          f"of 5) [{card}]")
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    card = _card_line()
    print(f"card: {card}")

    from vri_tpu_torch import RenderConfig, SDFConfig, _cuda, scenes
    from vri_tpu_torch.hydra.delegate import RenderDelegate
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
    lib_paths = _cuda.build()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(os.path.basename(p) for p in lib_paths.values())}) "
          f"[{card}]")
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for src in _cuda.SOURCES:
            f.write(f"== {src}\n{_cuda.compiler_log(src)}")
    for src in _cuda.SOURCES:
        lines = _ptxas(src)
        _check(lines, f"{src}: no ptxas output beside its library")
        for line in lines:
            print(f"  ptxas ({src}): {line}")

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
        also_replaces="vri_tpu/ops/rasterize.py:1879 (K2), :1712 (K7), "
                      ":658 (K5); tools/prof_worklist.py:111, :141 (T6)",
        max_abs_err=r_err,
        ms=_time_ms(lambda: rasterize.raster_tiles(*rargs, **rkw), 20),
        plain_ms=_time_ms(lambda: rasterize.raster_tiles_reference(
            *rargs, **rkw), 2),
        library_ms=None,
        **_bound_raster_tiles(prep["coef"], prep["starts"], prep["counts"],
                              prep["cap"], got))
    ls = rasterize.list_length_stats(prep["counts"], prep["cap"])
    print(f"raster_tiles: {int(prep['lists'].shape[0])} pairs over "
          f"{ls['tiles']} tiles; list lengths mean {ls['mean']:.2f}, p50 "
          f"{ls['p50']:.1f}, p99 {ls['p99']:.1f}, longest {ls['max']}; the "
          f"longest 1% of tiles hold {ls['top1_share']:.4f} of the pairs; "
          f"equal to the plain version; "
          f"{kernels['raster_tiles']['ms']:.3f} ms vs plain "
          f"{kernels['raster_tiles']['plain_ms']:.1f} ms, bound "
          f"{kernels['raster_tiles']['bound_ms']:.4f} ms by "
          f"{kernels['raster_tiles']['bound_by']} [{card}]")

    # -- 4. kernel K6 on the frame's chunks -----------------------------------
    cull = frame_mod._cull_sign(r.scene)
    rprep = rasterize.prepare_ranged(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=h, width=w, cull_sign=cull)
    kargs = (rprep["coef"], rprep["order"], rprep["ranges"], rprep["words"])
    kkw = dict(n_global=rprep["n_global"], num_tx=rprep["num_tx"])
    got = rasterize.raster_ranged(*kargs, **kkw, pairs=True)
    torch.cuda.synchronize()
    want = rasterize.raster_ranged_reference(*kargs, **kkw, pairs=True)
    for name, g, wv in zip(("z", "slot", "u", "v", "pairs"), got, want):
        _check(torch.equal(g, wv), f"raster_ranged {name} differs from the "
               "plain version")
    _check(torch.equal(got[4], prep["counts"]),
           "raster_ranged: the (tile, slot) pairs tested per tile differ "
           "from the sorted prep's lists")
    kernels["raster_ranged"] = dict(
        route="cuda", source="vri_tpu_torch/csrc/raster_ranged.cu",
        replaces="vri_tpu/ops/rasterize.py:400",
        max_abs_err=max(float((g.float() - wv.float()).abs().max())
                        for g, wv in zip(got[:4], want[:4])),
        ms=_time_ms(lambda: rasterize.raster_ranged(*kargs, **kkw), 10),
        plain_ms=_time_ms(lambda: rasterize.raster_ranged_reference(
            *kargs, **kkw), 1),
        library_ms=None,
        **_bound_raster_ranged(rprep, prep["counts"], got[:4]))
    spans = (rprep["ranges"][:, 1] - rprep["ranges"][:, 0]).clamp(min=0)
    walked = _chunk_slots(rprep)
    needed = float(prep["counts"].double().sum())
    tested = int(got[4].sum())
    print(f"raster_ranged: {int(rprep['order'].shape[0]) // 128} chunks, "
          f"{rprep['n_global']} global, local ranges up to "
          f"{int(spans.max())} chunks (mean {float(spans.float().mean()):.1f})"
          f"; its live chunks hold {walked:.0f} (tile, slot) pairs "
          f"({walked / needed:.1f}x the {needed:.0f} that overlap); it tests "
          f"{tested} after the cull, per tile the sorted prep's lists; "
          f"equal to the plain version; "
          f"{kernels['raster_ranged']['ms']:.3f} ms vs plain "
          f"{kernels['raster_ranged']['plain_ms']:.1f} ms, bound "
          f"{kernels['raster_ranged']['bound_ms']:.4f} ms by "
          f"{kernels['raster_ranged']['bound_by']} [{card}]")
    del rprep, kargs, got, want

    # -- 5. the tiers agree on the card; each tier's whole raster time ---------
    small_stage = RenderDelegate(RenderConfig(width=512, height=512),
                                 device=dev)
    small_stage.populate(scenes.kitchen_stress(num_objects=256, tess=1))
    s_scene = small_stage.sync()
    s_fp = frame_mod.FrameParams.from_camera(small_stage.camera, 512,
                                             device=dev)
    shapes = {
        "kitchen 1920x1080": (r.scene, world, fp, h, w),
        "kitchen_stress(256, tess=1) 512x512": (
            s_scene, bake_world(s_scene), s_fp, 512, 512)}
    for label, (sc, wv_, fpv, hh, ww) in shapes.items():
        args = (wv_, sc.tri_vertices, sc.num_faces, fpv.view_proj)
        kw = dict(height=hh, width=ww, cull_sign=frame_mod._cull_sign(sc))
        tiers = {"sorted": rasterize.rasterize_sorted,
                 "binned": rasterize.rasterize_binned,
                 "ranged": rasterize.rasterize}
        hits = {t: fn(*args, **kw)[0] for t, fn in tiers.items()}
        clean = [t for t, hit in hits.items()
                 if hit.overflow is None or int(hit.overflow) == 0]
        need = ["sorted", "ranged"] + (["binned"] if hh <= 512 else [])
        _check(all(t in clean for t in need),
               f"{label}: a tier overflowed ({clean} without overflow)")
        for t in clean[1:]:
            for key in ("tri", "t", "u", "v"):
                _check(torch.equal(getattr(hits[t], key),
                                   getattr(hits["sorted"], key)),
                       f"{label}: the {t} tier's {key} differs from the "
                       "sorted tier's")
        times = {t: _time_ms(lambda fn=fn: fn(*args, **kw), 5)
                 for t, fn in tiers.items()}
        print(f"tiers, {label} ({int(sc.num_faces)} faces): "
              f"{' = '.join(clean)} bit-equal; whole raster "
              + ", ".join(f"{t} {times[t]:.3f} ms" for t in tiers)
              + "".join(f" ({t} overflows {int(hits[t].overflow)} tiles)"
                        for t in tiers if t not in clean)
              + f" (CUDA events, mean of 5) [{card}]")
        if hh > 512:
            continue
        # kernel R on the binned tier's lists (K5's walk)
        bprep = rasterize.prepare_binned(*args, **kw)
        bargs = (bprep["coef"], bprep["lists"], bprep["starts"],
                 bprep["counts"])
        bkw = dict(num_tx=bprep["num_tx"], cap=bprep["cap"])
        got = rasterize.raster_tiles(*bargs, **bkw)
        torch.cuda.synchronize()
        want = rasterize.raster_tiles_reference(*bargs, **bkw)
        for name, g, wv in zip(("z", "slot", "u", "v"), got, want):
            _check(torch.equal(g, wv), f"raster_tiles on the binned lists: "
                   f"{name} differs from the plain version")
        k_ms = _time_ms(lambda: rasterize.raster_tiles(*bargs, **bkw), 20)
        p_ms = _time_ms(lambda: rasterize.raster_tiles_reference(
            *bargs, **bkw), 2)
        # K5's bound: the (tile, slot) pairs that overlap (the sorted
        # prep's lists at this shape), not the 8-slot groups walked
        sprep = rasterize.prepare_sorted(*args, **kw)
        k5 = _bound_raster_tiles(sprep["coef"], sprep["starts"],
                                 sprep["counts"], sprep["cap"], got)
        kernels["raster_tiles"]["binned"] = dict(ms=k_ms, plain_ms=p_ms, **k5)
        print(f"raster_tiles on the binned lists, {label}: "
              f"{int(bprep['counts'].sum())} slots over "
              f"{int(bprep['counts'].shape[0])} tiles (longest list "
              f"{int(bprep['counts'].max())}), equal to the plain version; "
              f"{k_ms:.3f} ms vs plain {p_ms:.1f} ms; bound "
              f"{k5['bound_ms']:.4f} ms by {k5['bound_by']} "
              f"({int(sprep['counts'].sum())} overlapping pairs, "
              f"{k5['ops'] / 1e9:.3f} GFLOP, {k5['bytes'] / 1e6:.1f} MB) "
              f"[{card}]")
    del small_stage, s_scene, shapes, hits, bprep, sprep, bargs, got, want

    # -- 6. kernel M on the frame's real shadow and GI rays ------------------------
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
    m_work = {"bytes": 0, "ops": 0}
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
        b = _bound_march(margs, got, int(meta.shape[1]))
        m_work["bytes"] += b["bytes"]
        m_work["ops"] += b["ops"]
        m_times[label] = (
            _time_ms(lambda: march_kernel.march_rays(*margs, **mkw), 10),
            _time_ms(lambda: march_kernel.march_rays_reference(
                *margs, **mkw), 2))
        m = margs[0].shape[1]
        eff, mean_it, max_it = march_kernel.warp_step_efficiency(got[2])
        launched = march_kernel.persistent_lanes(int(meta.shape[1]), m)
        print(f"march_rays ({label}): {m} rays, "
              f"{float((got[1] >= 0).float().mean()):.3f} hit, steps mean "
              f"{mean_it:.2f}, max {max_it}; warp step efficiency in launch "
              f"order {eff:.4f}; {launched} persistent lanes, "
              f"{max(m - launched, 0)} refills; equal to the plain "
              f"version; {m_times[label][0]:.3f} ms vs plain "
              f"{m_times[label][1]:.1f} ms [{card}]")
    kernels["march_rays"] = dict(
        route="cuda", source="vri_tpu_torch/csrc/march_rays.cu",
        replaces="vri_tpu/ops/march_kernel.py:259",
        also_replaces="vri_tpu/ops/march_kernel.py:221",
        max_abs_err=m_err,
        ms=sum(v[0] for v in m_times.values()),
        plain_ms=sum(v[1] for v in m_times.values()),
        library_ms=None, **_bound(m_work["bytes"], m_work["ops"]))
    print(f"march_rays: bound {kernels['march_rays']['bound_ms']:.4f} ms by "
          f"{kernels['march_rays']['bound_by']} for both ray sets [{card}]")
    del r, cas, gb, hit, o, d, u, prep, rargs, margs, got, want
    torch.cuda.empty_cache()

    # -- 7. main path ------------------------------------------------------------
    r2 = Renderer(RenderConfig(width=w, height=h, sdf=sdf_cfg), device=dev)
    r2.load_stage(scenes.kitchen_stress(num_objects=256, tess=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
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
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    _check(r2.list_overflow == 0,
           f"SDF list drops: {r2.list_overflow}")
    n_lights = int(r2.scene.num_lights)
    # bake: one shadow march; per frame one shadow march (all lights in
    # one ray set) and one GI march
    want_launch = _launches(raster_tiles=3,
                            march_rays=(1 if n_lights else 0) + 3 * 2)
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
    for name in ("raster_tiles", "march_rays"):
        kernels[name]["launches"] = launches[name]
    # the same frame without the host copy of the AOVs (device work only)
    dev_ms = _time_ms(lambda: r2.render(gi=True, to_numpy=False), 3)
    print(f"  frame without the host copy of the AOVs: {dev_ms:.2f} ms "
          f"(CUDA events, mean of 3) [{card}]")

    # -- 8. the ladder's last rung on the main path's stage -------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    uni = torch.rand((1, h * w, 2), generator=gen, device=dev)
    _reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    ranged = r2.render(gi=True, backend="raster_ranged", uniforms=uni)
    stop.record()
    torch.cuda.synchronize()
    ranged_ms = start.elapsed_time(stop)
    launches = _counts()
    want_launch = _launches(raster_ranged=1, march_rays=2)
    _check(launches == want_launch,
           f"ranged frame: launch counts {launches}, expected {want_launch}")
    kernels["raster_ranged"]["launches"] = launches["raster_ranged"]
    plain = r2.render(gi=True, uniforms=uni)
    _check("raster_overflow_tiles" not in ranged,
           "the ranged frame reported an overflow count")
    for key in ("instance_id", "color"):
        _check(np.array_equal(ranged[key], plain[key]),
               f"ranged frame: {key} differs from the sorted-tier frame's")
    print(f"ranged frame (render(gi=True, backend='raster_ranged')): "
          f"{ranged_ms:.2f} ms (CUDA events, with the host copy), launches "
          f"{launches}, instance_id and color equal to the sorted-tier "
          f"frame's [{card}]")

    # -- 12. kernel bvh_traverse against its plain version -------------------
    kernels["bvh_traverse"] = _bvh_kernel(r2, h, w, card)

    # -- 13. the BVH GI frame on the main path's renderer -------------------
    _reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    bvh_frame = r2.render(gi=True, backend="bvh", uniforms=uni)
    stop.record()
    torch.cuda.synchronize()
    bvh_ms = start.elapsed_time(stop)
    launches = _counts()
    want_launch = _launches(march_rays=2, bvh_traverse=1)
    _check(launches == want_launch,
           f"BVH frame: launch counts {launches}, expected {want_launch}")
    kernels["bvh_traverse"]["launches"] = launches["bvh_traverse"]
    _check(np.isfinite(bvh_frame["color"]).all(), "BVH frame: colour not "
           "finite")
    cov = float((bvh_frame["instance_id"] >= 0).mean())
    _check(cov > 0.5, f"BVH frame: coverage {cov:.3f}")
    _check("raster_overflow_tiles" not in bvh_frame,
           "the BVH frame reported a raster overflow count")
    agree = float((bvh_frame["instance_id"] == plain["instance_id"]).mean())
    bvh_dev_ms = _time_ms(lambda: r2.render(gi=True, backend="bvh",
                                            uniforms=uni, to_numpy=False), 3)
    print(f"BVH GI frame (render(gi=True, backend='bvh')): launches "
          f"{launches}, coverage {cov:.4f}, instance_id equal to the "
          f"sorted-tier frame's on {agree:.4f} of pixels (no backface "
          f"culling on the BVH); {bvh_ms:.2f} ms with the host copy, "
          f"{bvh_dev_ms:.2f} ms without (CUDA events, mean of 3) [{card}]")
    del r2, ranged, plain, uni, bvh_frame
    torch.cuda.empty_cache()

    # -- 9. the app's default frame: Cornell at 512x512, room preset ----------
    ra = Renderer(RenderConfig(width=512, height=512, sdf=sdf_cfg),
                  device=dev)
    ra.load_stage(scenes.cornell_box())
    tiers_run = []
    real_binned, real_sorted = (rasterize.rasterize_binned,
                                rasterize.rasterize_sorted)
    rasterize.rasterize_binned = _tagged(real_binned, "binned", tiers_run)
    rasterize.rasterize_sorted = _tagged(real_sorted, "sorted", tiers_run)
    _reset_counts()
    try:
        app = ra.render(gi=True)
    finally:
        rasterize.rasterize_binned = real_binned
        rasterize.rasterize_sorted = real_sorted
    launches = _counts()
    want_launch = _launches(
        raster_tiles=1,
        march_rays=(1 if int(ra.scene.num_lights) else 0) + 2)
    _check(tiers_run == ["binned"], f"app frame ran the tiers {tiers_run}")
    _check(launches == want_launch,
           f"app frame: launch counts {launches}, expected {want_launch}")
    _check(int(app["raster_overflow_tiles"]) == 0, "app frame: overflow")
    _check(np.isfinite(app["color"]).all(), "app frame: colour not finite")
    app_ms = _time_ms(lambda: ra.render(gi=True, to_numpy=False), 3)
    print(f"app default frame (Cornell 512x512, room): binned tier, "
          f"launches {launches}, coverage "
          f"{float((app['instance_id'] >= 0).mean()):.4f}; {app_ms:.2f} ms "
          f"without the host copy (CUDA events, mean of 3) [{card}]")
    del ra, app

    # -- 10. small-input agreement with the plain versions on the CPU --------------
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

    # -- 11. city: frustum compaction at 1.35M faces ---------------------------
    _city(dev, card)

    # -- 14. the direct-only frame: Cornell 512x512, raster and BVH -----------
    rd = Renderer(RenderConfig(width=512, height=512, sdf=sdf_cfg),
                  device=dev)
    rd.load_stage(scenes.cornell_box())
    direct = {}
    for be in ("raster", "bvh"):
        _reset_counts()
        direct[be] = rd.render(gi=False, backend=be)
        launches = _counts()
        kernel = "raster_tiles" if be == "raster" else "bvh_traverse"
        _check(launches[kernel] == 1 and launches["march_rays"] == 0
               and sum(launches.values()) == 1,
               f"direct {be} frame: launch counts {launches}")
        _check(np.isfinite(direct[be]["color"]).all(),
               f"direct {be} frame: colour not finite")
        _check(int(direct[be].get("raster_overflow_tiles", 0)) == 0,
               f"direct {be} frame: raster overflow")
        d_ms = _time_ms(lambda be=be: rd.render(gi=False, backend=be,
                                                to_numpy=False), 3)
        print(f"direct-only frame (render(gi=False, backend={be!r}), "
              f"Cornell 512x512): launches {launches}, coverage "
              f"{float((direct[be]['instance_id'] >= 0).mean()):.4f}; "
              f"{d_ms:.2f} ms without the host copy (CUDA events, mean of "
              f"3) [{card}]")
    same = float((direct["raster"]["instance_id"]
                  == direct["bvh"]["instance_id"]).mean())
    print(f"  direct-only frames: instance_id equal on {same:.4f} of pixels")
    _check(same >= 0.99, f"direct-only frames: raster and BVH ids agree on "
           f"{same:.4f} of pixels")
    del rd, direct

    # -- 15-17. the work-list kernels at their tools' shapes --------------
    _worklist(dev, card, kernels)

    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, k in kernels.items():
        _check(all(key in k for key in keys),
               f"{name}: kernel entry lacks {set(keys) - set(k)}")
    print(json.dumps({"kernels": [dict(name=k, **v)
                                  for k, v in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
