"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- one static-stage GI frame as
``vri_tpu_torch.renderer.Renderer.render(gi=True)`` runs it -- at the size
a user runs: the 49k-triangle kitchen stage, 1920x1080, the "room" SDF
preset; then the other paths: the ranged tier, the BVH backend, the app's
default frame, a city-scale stage and the direct-only frame; then the
work-list micro-benchmarks' kernels, each through its tool's own row at
the tool's full shape; the production frame (the temporal GI frame at
``gi_scale=2``), the reference preset's frame, the SDF debug views and
the compacted march; the LOD and animated-stage paths: the LOD face
mask through the three raster tiers, the bounded SDF update, the
animated frame, the clipmap scroll and the app's ``--lod`` and
``--builtin animated``; the single-device remainder: band frames,
the dense SDF build of the "tiny" preset, the scene cache and checks,
and the app's ``--sdf tiny``, ``--cache`` and ``--trace``; and the
frames sharded over several ranks (``vri_tpu_torch.parallel``), whose
ranks this script starts as subprocesses of itself (``--phase29 PART
FILE``).  The JAX package and JAX itself are blocked before the port is
imported, so any import of either is fatal.  Phases (run in the order
1-3, 30, 4-6, 21, 7, 8, 12, 13, 31, 18, 25, 20, 23, 29, 24, 27, 26, 19, 9, 28,
10, 11, 22, 14-17; phase 20's small input runs in phase 10, phase 25's
dynamic band frame in phase 23), each fatal on failure:

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
    at 1920x1080, packed as ``bench.py:327-333`` packs it (``lod_levels=3,
    lod_min_faces=64``) and rendered at ``lod_tau=0``: frustum-compacted
    raster frames, escalating the capacities as the renderer's ladder
    does until a frame reports no overflow; then three frames at that
    scale (zero overflow, ``raster_tiles`` counted), the compacted
    ``HitRecord`` equal to an uncompacted sorted raster of the frame; the
    live face count, the longest tile list, the ladder, frame times and
    peak memory;
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
    ties) at W = 1, 8, 32 and 128, each held bit for bit and timed;
18. the production frame, as ``bench.py``'s ``gi_1080p_ms`` row runs it:
    ``render_frame_gi_temporal`` at ``gi_scale=2``, 1 spp, ``use_cache``,
    the raster backend, on phase 7's renderer and cascades (kitchen,
    1920x1080, room preset).  First kernel M against its plain version
    on one frame's own rays, built as the frame builds them (the shadow
    rays of the ``shadow_scale`` subsample, the GI rays at GI
    resolution): t, hit voxel, iterations and activity exactly equal,
    and the kernel's time on each.  Then 10 frames at the stage camera
    from ``init_temporal(1080, 1920, 2)``, counters reset first: each
    frame exactly one ``raster_tiles`` and two ``march_rays``; zero
    overflow, finite colour, coverage > 50%, ``gi_history`` at most 17
    and on at least 90% of the covered pixels equal to the frame count;
    frame times with and without the AOV host copy beside phase 7's,
    peak memory; the frame's stages, each between two synchronizes
    (G-buffer, visibility, direct, indirect, the march, reprojection);
    then 5 frames of ``render_flythrough(temporal=True, gi_scale=2)`` on
    an orbit from the stage camera (mean ``gi_history`` above 1 by the
    third frame);
19. the reference preset's GI frame: ``RenderConfig(sdf=SDFConfig())`` on
    the Cornell box at 1920x1080 through ``render(gi=True)``: one
    ``raster_tiles``, one ``march_rays`` (the shadow rays), the GI rays
    through the trilinear loop; finite colour, coverage > 50%; the SDF
    build time, the frame time; kernel M against its plain version on
    the frame's shadow rays over the preset's 8 cascades, exactly equal
    as in phase 18; and the loop's steps and time per step on the
    frame's GI rays;
20. the SDF debug views (modes 7-12) of phase 7's frame: no kernel
    launch, finite colour, the hit share and time; the Cornell box at
    64^2 in ``SDF_DISTANCE`` on the card and the CPU agree on the hits of
    at least 99.9% of the pixels;
21. ``march_compact`` under ``compact_march`` on phase 6's GI rays: three
    ``march_rays`` launches; t, hit voxel and iterations equal to
    one-phase ``march``; both times;
22. LOD: on phase 11's city, ``_visibility_raster`` frames at
    ``lod_tau=0.75`` (the mask is present, so the uncompacted sorted
    tier), escalating the capacities as phase 11 does: zero overflow at
    the settled scale, one ``raster_tiles`` a frame, no face of a level
    not chosen wins a pixel, kernel R bit-equal to its plain version on
    the frame's lists; the faces selected against the chains, the
    instances per level and the frame times beside phase 11's.  Then the
    masked tiers bit-equal (``tri``, ``t``, ``u``, ``v``): sorted and
    ranged on ``kitchen_stress(256, tess=4)`` at 1080p, sorted, binned
    and ranged on ``kitchen_stress(64, tess=4)`` at 512^2 (at tess 1 no
    mesh reaches ``lod_min_faces=64``), one ``raster_ranged`` launch on
    the ranged tier;
23. the bounded update and the animated frame, on phase 7's renderer and
    cascades (kitchen, 1080p, room): (a) ``update_for_scene`` moving the
    smallest prop by 0.03, as ``bench.py:180-215`` times it:
    ``needs_full`` 0; its time (CUDA events), dirty cells, triangles and
    re-emitted bricks against the room preset's caps, and its host syncs
    (``torch.cuda.set_sync_debug_mode``); (b) 5 frames of
    ``render_frame_gi_dynamic`` with the prop on ``bench.py``'s
    oscillating path (``bench.py:220-280``: ``gi_scale=2``, 1 spp,
    ``use_cache``, raster, from ``init_temporal(1080, 1920, 2)``),
    counters reset first: each frame one ``raster_tiles`` and three
    ``march_rays`` (the partial bake's shadow rays, the frame's shadow and
    GI rays: ``gi.direct_radiance`` marches once a call), ``needs_full``
    0, finite colour, coverage > 50%; the frame times, the re-bake sets
    against ``bake_brick_cap``, the host syncs of a sixth frame and the
    peak memory; (c) kernel M bit-equal to its plain version on the last
    partial bake's shadow rays; (d) ``animated_stage()`` at the room
    preset (update caps raised to hold all 8 props, 64 triangles a brick)
    through ``render(time_code=t)`` for t = 0, 4, 8: rebuilt, then the
    update path twice, and the updated cascades voxel-equal to a full
    build at t = 8 (occupancy, ESD, atlas and albedo per voxel, march
    tables);
24. the clipmap scroll and the app: phase 7's renderer with its focus
    moved by two coarse voxels along -x takes the scroll path (with
    update caps that hold the move; the room preset's 1,024 cells do
    not); its time beside phase 7's full build; on ``animated_stage()``
    a scroll is voxel-equal to a fresh build at the new centers (atlas
    within 2e-6 and one u8 step, no near candidate dropped) and every
    cell list nests in the fresh build's or holds it;
    ``app.main(["--builtin", "animated", "--frames", "4"])`` and
    ``app.main(["--builtin", "kitchen", "--lod", "3"])`` exit 0 and write
    their PNGs under ``chiprun_out/``.
25. bands, on phase 7's renderer and cascades: 10 frames of
    ``render_frame_gi_temporal(height=136, band=(472, 1080),
    gi_scale=2, use_cache=True)`` (``bench.py``'s ``gi_band135_ms``),
    each exactly one ``raster_tiles`` and two ``march_rays``, timed
    beside phase 18's full frame; the band's instance ids and depth
    against rows 472-607 of a full production frame (differences counted,
    at most 0.5%); a Cornell 512^2 band through the binned tier and the
    kitchen band through ``raster_ranged``, each bit-equal to the sorted
    tier's band, the dispatch taking the binned tier on the Cornell band
    and the sorted on the kitchen's; ``raster_tiles`` bit-equal to its
    plain version on each band's sorted lists and the Cornell band's
    binned lists, ``raster_ranged`` on the kitchen band's chunks, and
    ``march_rays`` on the band frame's shadow and GI rays; and, in phase
    23, two ``render_frame_gi_dynamic(band=...)`` frames on its state
    (one ``raster_tiles``, three ``march_rays`` each;
    ``gi_anim_band_ms``), ``march_rays`` bit-equal to its plain version
    on the last one's three ray sets;
26. the dense SDF build: ``Renderer.render(gi=True)`` at 1080p under
    ``SDFConfig.preset("tiny")`` on the Cornell box and the kitchen
    ("rebuilt (dense)"): the build's time, bricks and overflow (the
    occupied voxels past the preset's 8,192 bricks), one ``raster_tiles``
    and two ``march_rays`` (the bake's and the frame's shadow rays), and
    ``march_rays`` bit-equal to its plain version on the frame's shadow
    rays;
27. the scene cache and checks on phase 7's kitchen: saved, loaded into
    a fresh renderer, the scene equal field by field (positions within
    one uint16 step, uvs within float16 rounding), a 1080p GI frame of
    the loaded scene with phase 7's cascades agreeing on at least 99.5%
    of the instance ids, the load time against the stage load, the
    file's bytes; ``validate_scene`` without errors;
28. the app on Cornell 512^2: ``--sdf tiny``, ``--cache`` written then
    read (no stage load), and ``--trace``, whose Chrome trace holds the
    program's ``frame``, ``visibility`` and ``gbuffer`` spans and the
    names of kernel R's and M's CUDA functions;
    ``device_memory_stats()`` reports ``cuda:0``;
29. multi-device, on phase 7's kitchen, cascades and build state (one
    file of CPU tensors the ranks load; no rank builds), the ranks
    started by ``parallel.mesh.launch`` (``torch.distributed.run``):
    (a) one ``nccl`` rank on cuda:0 at 1920x1080: the tiled static,
    temporal (``gi_scale`` 2, two frames) and dynamic frames bit-equal to
    ``render_frame_gi`` / ``_temporal`` / ``_dynamic`` with the same
    uniforms and the same R / M launches; (b) four ``gloo`` ranks
    sharing cuda:0 at 1920x1056 (the app's rounding): the tiled frame at
    ``samples`` 0 and 1 (each rank its own uniforms) with its ids off the
    single-card frame's on at most 0.05% of the pixels, one R and one M
    a sample a rank; the temporal frame (``gi_scale`` 2, ``halo_rows``
    2, a small vertical pan) carrying its history on more than half the
    pixels of every band border row; R and M bit-equal to their plain
    versions on rank 0's and rank 3's band lists and rays; each rank's
    frame ms (CUDA events around the call, its gathers included) and
    peak allocated memory; (d) on those ranks ``esd_sharded`` on cascade
    0's occupancy equal to ``esd_map``, ``scroll_slab`` (by 2 and past
    one slab) equal to ``torch.roll``, ``merge_scene_partitions``
    rebuilding the kitchen from two hosts' partial scenes and
    ``render_frame_tiled_2d`` on a 2 x 2 mesh with the 1-D frame's ids;
    (c) two ``gloo`` ranks: the tiled dynamic frame with phase 23's prop
    moved, ``atlas`` and ``voxel_shade`` bit-equal to the single-card
    dynamic frame's, ``needs_full`` 0, each rank's share of the emit,
    its re-bake launches, ms and peak.  A rank that fails, or writes no
    result, fails the phase;
30. the sorted tier's prep kernels (``raster_prep``, the pipeline of
    ``csrc/raster_prep.cu``) against its plain version on phase 3's
    inputs (the kitchen at 1920x1080): the slot table bit for bit, src,
    starts, counts, overflow and the live lists exactly equal, no host
    sync under ``set_sync_debug_mode("error")``; the kernels' device ms
    and launches of one call, by kernel (``torch.profiler``), the ms of
    back-to-back calls and of the plain version (CUDA events), the host
    ms of one call (the enqueue), the bound and ptxas's registers;
    phases 7 and 18 check one pipeline a frame;
31. the SDF emit kernel (``sdf_emit``, ``csrc/sdf_emit.cu``) against its
    plain version (``sdf_build._emit_blocks``) on the same CUDA tensors,
    at phase 7's kitchen build (the kernel's call over every live brick,
    held on every 16th) and at the animated cell's first bounded update
    (the smallest prop moved to code 1 of ``kitchen_anim``'s circle, all
    its bricks): every output bit-equal, one launch a call, no host sync
    under ``set_sync_debug_mode("error")``; the kernel's ms at both, the
    plain version's at the update, the bound from the update's bricks;
    phase 7 counts one emit in its build, phase 9 one, phases 23 and 25
    one in each dynamic frame.

Each kernel's entry in the JSON line carries its time, its plain
version's, its launches on the main path and its bound: the larger of the
bytes it must move (inputs read once, outputs written once) over the
H100's 3.35 TB/s and the FP32 operations this run's data needs over its
67 TFLOP/s (non-tensor peak), from the counts noted at each kernel.  No
single PyTorch call computes any of the nine, so ``library_ms`` is
null.  ``raster_prep``'s entry counts its pipelines on the main path and
carries its kernels' launches a call; ``sdf_emit``'s counts the main
path's build (one launch) and carries the build's bricks and ms.
``raster_tiles`` and ``march_rays`` also carry their launches in one
production frame (phase 18), all three in one dynamic frame (phase 23),
and ``raster_tiles`` and ``march_rays`` per rank in one tiled frame (phase 29(b); ``march_rays`` also per
rank in the sharded re-bake, phase 29(c)), ``raster_ranged`` its
launches on the masked ranged tier (phase 22).
The script prints its total seconds.

Prints the per-kernel JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Long compiler output goes to
``chiprun_out/``.  Exits non-zero, printing no result, when any phase
fails, no card is present, or the port's package is not importable
beside it (the script alone, outside the repository).
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
    from vri_tpu_torch.ops import (bvh, march_kernel, rasterize, sdf_build,
                                   worklist)

    return {"raster_tiles": rasterize.raster_tiles,
            "raster_ranged": rasterize.raster_ranged,
            "march_rays": march_kernel.march_rays,
            "sdf_emit": sdf_build._emit_kernel,
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


def _settle(frame, label: str) -> tuple:
    """The renderer's ladder: ``frame(caps_scale)`` at doubling
    capacities until it reports no overflow (at most 4x).  Returns the
    settled scale and the (scale, overflow) rungs."""
    scale, ladder = 1, []
    while True:
        over = int(frame(scale).overflow)
        ladder.append((scale, over))
        if not over:
            return scale, ladder
        scale *= 2
        _check(scale <= 4, f"{label}: overflow at 4x capacities ({ladder})")


def _city(dev, card: str) -> dict:
    """bench.py's city row (``bench.py:327-343``, LOD chains packed with
    ``lod_levels=3, lod_min_faces=64``, rendered at ``lod_tau=0``):
    frustum-compacted raster frames at 1920x1080, at the capacities the
    renderer's overflow ladder settles on.  Returns the stage and its
    frame times for phase 22."""
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
                                    lod_levels=3, lod_min_faces=64),
                       device=dev)
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

    scale, ladder = _settle(frame, "city")
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
    print(f"city: {int(scene.num_faces)} base faces, "
          f"{int(scene.num_faces_total)} with the LOD chains, in a pool of "
          f"{pool}, "
          f"{int(scene.num_instances)} instances; authoring {t1 - t0:.1f} s, "
          f"sync {t2 - t1:.1f} s (host clock); {live} live faces after the "
          f"frustum cull; longest tile list {longest} pairs, {over_4096} "
          f"tiles over 4096; ladder (caps_scale, overflow) {ladder}; "
          f"coverage {cov:.4f}, equal to the uncompacted raster [{card}]")
    print(f"  compacted raster frames at {scale}x: "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms (CUDA events), 0 overflow, launches {launches}, peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")
    return dict(scene=scene, world=world, fp=fp, times=times, pool=pool)


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


def _hold_march(cas, rays, cfg, steps: int, label: str) -> tuple:
    """Holds ``march_rays`` on one ray set (origins, dirs, range) to its
    plain version, with the budget ``sdf_trace`` gives the kernel tier
    for ``steps``: t, hit voxel, iterations and activity exactly equal.
    Returns the launch's arguments, keywords and outputs and the largest
    difference."""
    import torch

    from vri_tpu_torch.ops import march_kernel, sdf_trace

    ro, rd, rt = rays
    margs = (march_kernel.ray_table(cas, ro, rd, rt, cfg),
             march_kernel.pack_meta(cas, cfg), cas.march_coarse,
             cas.march_fine0, cas.march_fine1)
    mkw = dict(r=cfg.cascade_resolution,
               max_steps=sdf_trace._kernel_steps(steps, cfg))
    got = march_kernel.march_rays(*margs, **mkw)
    torch.cuda.synchronize()
    want = march_kernel.march_rays_reference(*margs, **mkw)
    for name, g, wv in zip(("t", "hv", "it", "act"), got, want):
        _check(torch.equal(g, wv), f"march_rays {name} differs from the "
               f"plain version on the {label} rays")
    err = max(float((g.double() - wv.double()).abs().max())
              for g, wv in zip(got, want))
    return margs, mkw, got, err


def _raster_prep(args, kw, card: str) -> dict:
    """Phase 30: ``raster_prep`` against ``prepare_sorted_reference`` on
    one frame's inputs; returns its entry of the kernels' JSON line."""
    import torch

    from vri_tpu_torch.ops import rasterize

    def call():
        return rasterize.raster_prep(*args, **kw)

    def plain():
        return rasterize.prepare_sorted_reference(*args, **kw)

    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = rasterize.raster_prep.launches
        got = call()
        _check(rasterize.raster_prep.launches == before + 1,
               "raster_prep: the pipeline was not counted")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = plain()
    n = int(want["starts"][-1])
    _check(torch.equal(got["coef"].view(torch.int32),
                       want["coef"].view(torch.int32)),
           "raster_prep: the slot table differs from the plain version")
    for k in ("src", "starts", "counts", "overflow"):
        _check(torch.equal(got[k], want[k]),
               f"raster_prep: {k} differs from the plain version")
    _check(torch.equal(got["lists"][:n], want["lists"][:n]),
           "raster_prep: the lists differ from the plain version")
    _check(int(got["overflow"]) == 0, "raster_prep: overflow")
    wall_ms = _time_ms(call, 50)
    plain_ms = _time_ms(plain, 5)
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    reps = 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    # the pipeline's own kernels: device us a call, by kernel
    per_kernel = {e.key.split("prep_")[1].split("(")[0]:
                  (e.count / reps, e.device_time_total / reps)
                  for e in prof.key_averages() if "prep_" in e.key}
    launches = sum(c for c, _ in per_kernel.values())
    ms = 1e-3 * sum(us for _, us in per_kernel.values())
    world, tri, _, vp = args
    nbytes = (_nbytes(world, tri, vp, kw["cull_sign"]) + _nbytes(
        got["coef"], got["src"], got["starts"], got["counts"],
        got["overflow"]) + 4 * n)
    regs = _ptxas("raster_prep.cu")
    entry = dict(
        route="cuda", source="vri_tpu_torch/csrc/raster_prep.cu",
        replaces=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        library_ms=None, wall_ms=wall_ms, host_ms=float(np.median(host)),
        launches_per_call=launches, pairs=n, slots=int(got["coef"].shape[0]),
        **_bound(nbytes, 0.0))
    print(f"raster_prep: {entry['slots']} slots, {n} pairs of "
          f"{int(got['lists'].shape[0])}; equal to the plain version, no "
          f"host sync; {ms:.4f} ms of kernels a call (torch.profiler, "
          f"mean of {reps}), {wall_ms:.4f} ms a call back to back (CUDA "
          f"events, mean of 50) vs plain {plain_ms:.3f} ms; host "
          f"{entry['host_ms']:.4f} ms a call (median of 20); {launches:g} "
          f"kernel launches a call; bound {entry['bound_ms']:.4f} ms by "
          f"{entry['bound_by']} [{card}]")
    print("  raster_prep kernels (launches, us a call): " + ", ".join(
        f"{k} {c:g} x {us:.2f}" for k, (c, us) in per_kernel.items()))
    for line in regs:
        print(f"  ptxas (raster_prep.cu): {line}")
    return entry


#: FP32 operations of one point-triangle distance in ``sdf_emit``
#: (``geometry.point_triangle_distance``, as ``perfbench/roofline_emit.py``
#: counts it); a texel takes one a candidate of its brick's k nearest
EMIT_FLOP_PER_DISTANCE = 90


def _sdf_emit(r, card: str) -> dict:
    """Phase 31 on renderer ``r`` (phase 7's kitchen, room preset, its
    cascades and build state): kernel E (``sdf_emit``) against its plain
    version (``sdf_build._emit_blocks``) on the same CUDA tensors, at the
    inputs of (a) the kitchen's full build (the kernel's call over every
    live brick, held on every 16th brick: the plain version takes about
    half a millisecond a brick) and (b) the animated cell's first bounded
    update (the smallest prop moved from its place to code 1 of
    ``scenes.kitchen_anim``'s circle): atlas rows, albedo, emissive,
    normal and the near-candidate drops bit-equal, one launch a call and
    no host sync under ``set_sync_debug_mode("error")``; the kernel's ms
    at both, the plain version's at (b), the bound from (b)'s bricks.
    Returns its entry of the kernels' JSON line."""
    import math

    import torch

    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.registry import bake_world

    dev = r.device
    eff = r._sdf_cfg_effective or r.config.sdf
    scene = r.scene.base_view()
    world = bake_world(scene)
    real, real_bricks = sdf_build._emit_kernel, sdf_build._emit_bricks
    calls = []

    def capture(*args):
        calls.append(args)
        return real_bricks(*args)

    def hold(args, label):
        """The kernel against the plain version on ``args``; returns the
        kernel's outputs."""
        torch.cuda.synchronize()
        before = real.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = real(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _check(real.launches == before + 1,
               f"sdf_emit ({label}): {real.launches - before} launches")
        want = sdf_build._emit_blocks(*args)
        names = ("atlas", "albedo", "emissive", "normal", "near_drop")
        for name, x, y in zip(names, got, want):
            _check(x.dtype == y.dtype and torch.equal(x, y),
                   f"sdf_emit ({label}): {name} differs from the plain "
                   f"version on {int((x != y).sum())} values")
        return got

    # -- (a) the full build's emit -------------------------------------------
    centers = sdf_mod.default_centers(eff, r._cascade_focus, device=dev)
    sdf_build._emit_bricks = capture
    try:
        sdf_build.build_for_scene(scene, world, centers, eff)
    finally:
        sdf_build._emit_bricks = real_bricks
    _check(len(calls) == 1, f"sdf_emit: {len(calls)} emits in one build")
    bids, *rest = calls.pop()
    n_build = int(bids.shape[0])
    sample = bids[::16]
    got = hold((sample, *rest), f"the build's every 16th of {n_build} "
                                "bricks")
    whole = real(bids, *rest)
    for name, x, y in zip(("atlas", "albedo", "emissive", "normal"),
                          whole, got):
        _check(torch.equal(x[::16], y), f"sdf_emit (the build): {name} of "
               "the whole call differs from the sampled call's")
    build_ms = _time_ms(lambda: real(bids, *rest), 3)
    del whole, got, rest

    # -- (b) the animated cell's first update --------------------------------
    k = _smallest_instance(scene)
    tf = scene.instance_transform.clone()
    ang = 2.0 * math.pi / 9.0
    off = torch.tensor([0.03 * math.cos(ang), 0.0, 0.03 * math.sin(ang)],
                       device=dev)
    tf[k, :3, 3] += off
    s1 = scene.replace(instance_transform=tf)
    lo0, hi0 = scene.instance_aabb_lo[k], scene.instance_aabb_hi[k]
    dlo = torch.stack([lo0, lo0 + off])
    dhi = torch.stack([hi0, hi0 + off])
    sdf_build._emit_bricks = capture
    try:
        _, _, nf = sdf_build.update_for_scene(
            r.cascades, r._build_state, s1, bake_world(s1),
            scene.tri_instance == k, dlo, dhi, eff)
    finally:
        sdf_build._emit_bricks = real_bricks
    _check(int(nf) == 0 and len(calls) == 1,
           f"sdf_emit: the update's needs_full {int(nf)}, {len(calls)} "
           "emits")
    args = calls.pop()
    n = int(args[0].shape[0])
    _check(n > 0, "sdf_emit: the update re-emitted no brick")
    got = hold(args, f"the update's {n} bricks")
    ms = _time_ms(lambda: real(*args), 20)
    plain_ms = _time_ms(lambda: sdf_build._emit_blocks(*args), 1)
    bsz = eff.brick_size
    texels = bsz ** 3
    ops = n * texels * eff.max_triangles_per_brick * EMIT_FLOP_PER_DISTANCE
    # outputs written once (atlas rows, three colour rows, the drop
    # count), the brick ids and voxels read once; the candidate scan is
    # left out (its size depends on the program's lists)
    nbytes = _nbytes(*got) + _nbytes(args[0]) + 4 * n
    regs = _ptxas("sdf_emit.cu")
    entry = dict(
        route="cuda", source="vri_tpu_torch/csrc/sdf_emit.cu",
        replaces=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        library_ms=None, bricks=n, build_ms=build_ms, build_bricks=n_build,
        **_bound(nbytes, ops))
    print(f"sdf_emit: the kitchen's build, {n_build} bricks, "
          f"{build_ms:.3f} ms (CUDA events, mean of 3), equal to the plain "
          f"version on every 16th brick; the animated cell's first update, "
          f"{n} bricks: {ms:.3f} ms (mean of 20) vs plain {plain_ms:.1f} ms "
          f"on the same bricks, equal to it; one launch a call, no host "
          f"sync; bound {entry['bound_ms']:.4f} ms by {entry['bound_by']} "
          f"({ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) [{card}]")
    for line in regs:
        print(f"  ptxas (sdf_emit.cu): {line}")
    return entry


def _hold_raster_tiles(prep, label: str) -> tuple:
    """Holds ``raster_tiles`` on one prep's tile lists (sorted or binned)
    to its plain version: z, slot, u and v exactly equal.  Returns the
    launch's arguments, keywords and outputs and the largest
    difference."""
    import torch

    from vri_tpu_torch.ops import rasterize

    rargs = (prep["coef"], prep["lists"], prep["starts"], prep["counts"])
    rkw = dict(num_tx=prep["num_tx"], cap=prep["cap"])
    got = rasterize.raster_tiles(*rargs, **rkw)
    torch.cuda.synchronize()
    want = rasterize.raster_tiles_reference(*rargs, **rkw)
    for name, g, wv in zip(("z", "slot", "u", "v"), got, want):
        _check(torch.equal(g, wv), f"raster_tiles {name} differs from the "
               f"plain version on {label}")
    err = max(float((g.float() - wv.float()).abs().max())
              for g, wv in zip(got, want))
    return rargs, rkw, got, err


def _hold_raster_ranged(rprep, counts, label: str) -> tuple:
    """Holds ``raster_ranged`` on one ranged prep's chunks to its plain
    version: z, slot, u, v and the (tile, slot) pairs tested per tile
    exactly equal, and those pairs equal to the sorted prep's list
    lengths ``counts`` on the same inputs.  Returns the launch's
    arguments, keywords and outputs and the largest difference."""
    import torch

    from vri_tpu_torch.ops import rasterize

    kargs = (rprep["coef"], rprep["order"], rprep["ranges"], rprep["words"])
    kkw = dict(n_global=rprep["n_global"], num_tx=rprep["num_tx"])
    got = rasterize.raster_ranged(*kargs, **kkw, pairs=True)
    torch.cuda.synchronize()
    want = rasterize.raster_ranged_reference(*kargs, **kkw, pairs=True)
    for name, g, wv in zip(("z", "slot", "u", "v", "pairs"), got, want):
        _check(torch.equal(g, wv), f"raster_ranged {name} differs from the "
               f"plain version on {label}")
    _check(torch.equal(got[4], counts), f"raster_ranged on {label}: the "
           "(tile, slot) pairs tested per tile differ from the sorted "
           "prep's lists")
    err = max(float((g.float() - wv.float()).abs().max())
              for g, wv in zip(got[:4], want[:4]))
    return kargs, kkw, got, err


def _frame_rays(scene, fp, cas, cfg, h: int, w: int, gen, lod_tau: float,
                what: str, y0: int = 0, proj_height=None) -> dict:
    """Holds ``march_rays`` to its plain version on one GI frame's own
    rays at ``gi_scale=2``, built as the frame builds them from its
    raster G-buffer (rows [y0, y0 + h) of a ``proj_height``-row frame on
    a band): the shadow rays of the ``shadow_scale`` subsample and the GI
    rays of the GI-resolution view.  Returns label -> (arguments,
    keywords, outputs)."""
    import torch

    from vri_tpu_torch.ops import gi
    from vri_tpu_torch.passes import frame as frame_mod

    _, gb = frame_mod._gbuffer(scene, fp, h, w, "raster", lod_tau, y0=y0,
                               proj_height=proj_height)
    sub_s, _ = frame_mod._subsample_pn(gb, h, w, cfg.shadow_scale)
    sub_g, _ = frame_mod._subsample_pn(gb, h, w, 2)
    u = torch.rand((sub_g.position.shape[0], 2), generator=gen,
                   device=sub_g.position.device)
    held = {}
    for label, rays, steps in (
            ("shadow", gi.shadow_rays(sub_s.position, sub_s.normal, scene,
                                      cas, cfg), cfg.shadow_steps),
            ("gi", gi.gi_rays(sub_g.position, sub_g.normal, u, cas, cfg),
             cfg.gi_steps)):
        margs, mkw, got, _ = _hold_march(cas, rays, cfg, steps,
                                         f"{what}'s {label}")
        held[label] = (margs, mkw, got)
    return held


def _hold_partial_bake(cas, st, scene, dlo, dhi, cfg, what: str) -> tuple:
    """Holds ``march_rays`` to its plain version on the shadow rays of a
    dynamic frame's partial bake (its re-emitted bricks and those whose
    lighting the dirty boxes touch, up to ``bake_brick_cap``).  Returns
    the rays and bricks held."""
    import torch

    from vri_tpu_torch.ops import gi
    from vri_tpu_torch.ops import sdf as sdf_mod

    mask = st.emit_bricks | sdf_mod.lighting_dirty_bricks(
        cas, scene, dlo, dhi, config=cfg)
    pos = torch.nonzero(mask & st.alive).reshape(-1)[:cfg.bake_brick_cap]
    _check(pos.shape[0] > 0, f"{what}: no brick re-baked")
    centers = sdf_mod.brick_positions(cas, cfg)[0][pos]
    nrm = cas.brick_normal[pos]
    pts = centers + nrm * gi.surface_bias(centers, cas, cfg)[:, None]
    margs, _, _, _ = _hold_march(
        cas, gi.shadow_rays(pts, nrm, scene, cas, cfg), cfg, 32,
        f"{what}'s partial bake's shadow")
    return int(margs[0].shape[1]), int(pos.shape[0])


def _stages(call, targets: dict, reps: int) -> dict:
    """Host milliseconds of each stage of ``call()``, a mean over
    ``reps`` calls after one warm-up: each ``targets`` entry, name ->
    (module, attribute), is wrapped to run between two
    ``torch.cuda.synchronize()`` calls (a stage called twice a frame
    adds up; a nested stage counts inside its caller too).  ``frame`` is
    the whole call between two synchronizes."""
    import torch

    times = dict.fromkeys(["frame", *targets], 0.0)
    real = {name: getattr(*where) for name, where in targets.items()}

    def fenced(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return timed

    for name, (mod, attr) in targets.items():
        setattr(mod, attr, fenced(name, real[name]))
    try:
        fenced("frame", call)()
        times.update(dict.fromkeys(times, 0.0))
        for _ in range(reps):
            fenced("frame", call)()
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, real[name])
    return {name: t / reps for name, t in times.items()}


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _compact(cas, rays, cfg, card: str) -> None:
    """Phase 21: ``sdf_trace.march(approx=True, compact=True)`` under
    ``compact_march`` -- ``march_kernel.march_compact``, three
    ``march_rays`` launches -- on the frame's GI rays, held bit-equal to
    one-phase ``march`` (t, hit voxel, iterations)."""
    import dataclasses

    import torch

    from vri_tpu_torch.ops import march_kernel, sdf_trace

    ro, rd, rt = rays
    ccfg = dataclasses.replace(cfg, compact_march=True)
    ks = cfg.gi_steps * 2 + 16

    def one():
        return march_kernel.march(cas, ro, rd, rt, config=cfg, max_steps=ks)

    def compact():
        return sdf_trace.march(cas, ro, rd, rt, config=ccfg,
                               max_steps=cfg.gi_steps, approx=True,
                               compact=True)

    want = one()
    _reset_counts()
    got = compact()
    torch.cuda.synchronize()
    launches = _counts()
    _check(launches == _launches(march_rays=3),
           f"march_compact: launch counts {launches}")
    for key in ("t", "voxel", "iterations"):
        _check(torch.equal(getattr(got, key), getattr(want, key)),
               f"march_compact: {key} differs from one-phase march")
    act = march_kernel.march_rays(
        march_kernel.ray_table(cas, ro, rd, rt, cfg),
        march_kernel.pack_meta(cas, cfg), cas.march_coarse,
        cas.march_fine0, cas.march_fine1, r=cfg.cascade_resolution,
        max_steps=24)[3]
    m = ro.shape[0]
    one_ms, comp_ms = _time_ms(one, 10), _time_ms(compact, 10)
    print(f"march_compact (GI rays, {m} rays, budget {ks}): {launches} "
          f"launches; {int(act.sum())} rays active after 24 steps, buffer "
          f"{((m // 4) + 1023) // 1024 * 1024}; t, hit voxel and iterations "
          f"equal to one-phase march; {comp_ms:.3f} ms against one phase "
          f"{one_ms:.3f} ms (CUDA events, mean of 10) [{card}]")


def _production(r, h: int, w: int, cfg, card: str, gi1_ms: float) -> dict:
    """Phase 18: ``bench.py``'s ``gi_1080p_ms`` frame -- the temporal GI
    frame at ``gi_scale=2``, 1 spp, ``use_cache``, the raster backend --
    10 frames at the stage camera from an empty history on renderer
    ``r`` (phase 7's, its cascades reused), after kernel M is held to
    its plain version on one frame's shadow and GI rays; the frame's
    stages; then 5 frames of ``render_flythrough(temporal=True,
    gi_scale=2)`` on an orbit that starts at the stage camera.  Returns
    the launches of one frame and the 10 frames' times."""
    import torch

    from vri_tpu_torch.hydra.camera import FreeCamera
    from vri_tpu_torch.ops import gi, march_kernel, rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    cam = r.camera
    builds = r.last_build_ms
    cas = r.ensure_cascades(eye=cam.eye)
    _check(r.last_build_ms == builds, "production frame: the cascades "
           "were rebuilt")
    fp = frame_mod.FrameParams.from_camera(cam, h, device=r.device)
    kw = dict(height=h, width=w, config=cfg, backend="raster", samples=1,
              use_cache=True, gi_scale=2, lod_tau=r.config.lod_tau)
    gen = torch.Generator(device=r.device)
    gen.manual_seed(18)

    # kernel M on one frame's own rays, built as the frame builds them
    held = _frame_rays(r.scene, fp, cas, cfg, h, w, gen, r.config.lod_tau,
                       "production frame")
    m_ms = {}
    for label, at in (("shadow", f"shadow_scale {cfg.shadow_scale}"),
                      ("gi", "gi_scale 2")):
        margs, mkw, got = held[label]
        m_ms[label] = _time_ms(lambda: march_kernel.march_rays(
            *margs, **mkw), 10)
        print(f"  march_rays on the production frame's {label} rays ({at}): "
              f"{margs[0].shape[1]} rays, "
              f"{float((got[1] >= 0).float().mean()):.3f} hit, steps mean "
              f"{float(got[2].float().mean()):.2f}, max "
              f"{int(got[2].max())}; equal to the plain version; "
              f"{m_ms[label]:.3f} ms (CUDA events, mean of 10) [{card}]")
    del held, margs, got

    state = frame_mod.init_temporal(h, w, 2, device=r.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, shares = [], []
    per_frame = _launches(raster_tiles=1, march_rays=2)
    for i in range(10):
        before = _counts()
        prep_before = rasterize.raster_prep.launches
        start, stop = _events()
        start.record()
        aovs, state = frame_mod.render_frame_gi_temporal(
            r.scene, fp, cas, state, generator=gen, **kw)
        out = {k: v.cpu().numpy() for k, v in aovs.items()}
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        step = {k: v - before[k] for k, v in _counts().items()}
        _check(step == per_frame, f"production frame {i}: launches {step}")
        _check(rasterize.raster_prep.launches == prep_before + 1,
               f"production frame {i}: raster_prep pipelines "
               f"{rasterize.raster_prep.launches - prep_before}")
        _check(int(out["raster_overflow_tiles"]) == 0,
               f"production frame {i}: raster overflow")
        _check(np.isfinite(out["color"]).all(),
               f"production frame {i}: colour not finite")
        cov = out["instance_id"] >= 0
        _check(cov.mean() > 0.5, f"production frame {i}: coverage "
               f"{cov.mean():.3f}")
        hist = out["gi_history"]
        _check(hist.max() <= 17.0, f"production frame {i}: gi_history "
               f"{hist.max()} beyond the cap")
        # a fixed camera: every covered pixel that keeps its history
        # holds the frame count (bilinear weights round within 1e-3)
        shares.append(float((np.abs(hist[cov] - (i + 1)) <= 1e-3).mean()))
        _check(shares[-1] >= 0.9, f"production frame {i}: {shares[-1]:.4f} "
               f"of covered pixels hold {i + 1} frames of history")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    dev_ms = _time_ms(lambda: frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, state, generator=gen, **kw), 5)
    st = _stages(lambda: frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, state, generator=gen, **kw), {
            "gbuffer": (frame_mod, "_gbuffer"),
            "visibility": (frame_mod, "_visibility"),
            "direct": (frame_mod, "_direct_lighting"),
            "indirect": (gi, "indirect_radiance"),
            "march": (march_kernel, "march"),
            "reproject": (frame_mod, "_reproject")}, 5)
    rest = st["frame"] - sum(st[k] for k in ("gbuffer", "direct",
                                            "indirect", "reproject"))
    print(f"production frame (render_frame_gi_temporal, gi_scale=2, 1 spp, "
          f"use_cache, raster; kitchen 1920x1080, room): frames 1-10 "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms with the host copy (CUDA events); {dev_ms:.2f} ms without "
          f"(mean of 5), against the gi_scale=1 frame's {gi1_ms:.2f} ms "
          f"(phase 7); launches {launches}; coverage {cov.mean():.4f}; "
          f"share of covered pixels holding the frame count "
          + ", ".join(f"{x:.4f}" for x in shares)
          + f"; peak memory {peak / 2 ** 30:.2f} GiB [{card}]")
    print(f"  production frame's stages (host clock between synchronizes, "
          f"mean of 5 frames, ms): frame {st['frame']:.2f} = G-buffer "
          f"{st['gbuffer']:.2f} (visibility {st['visibility']:.2f}) + "
          f"direct {st['direct']:.2f} + indirect {st['indirect']:.2f} + "
          f"reproject {st['reproject']:.2f} + blend, pack and compose "
          f"{rest:.2f}; march_kernel.march (ray setup, kernel, payload; "
          f"inside direct and indirect) {st['march']:.2f}, of it the "
          f"kernel {m_ms['shadow'] + m_ms['gi']:.3f} [{card}]")

    class Orbit(FreeCamera):
        """An 8 s orbit about the kitchen's camera target (0, 0.6, 0) at
        the authored camera's radius and height, started at 45 degrees,
        where it meets the authored eye (3.36, 2.4, 3.36): the cascades'
        focus stays within a coarse voxel, so nothing is rebuilt."""

        def at_time(self, t, aspect, orbit_period=8.0):
            return super().at_time(t + orbit_period / 8.0, aspect,
                                   orbit_period)

    orbit = Orbit(center=(0.0, 0.6, 0.0), radius=float(np.hypot(3.36, 3.36)),
                  height=1.8, fov_y_deg=55.0, far=200.0)
    t0 = time.perf_counter()
    fly = r.render_flythrough(5, orbit, dt=1.0 / 60.0, temporal=True,
                              gi_scale=2)
    fly_s = time.perf_counter() - t0
    means = [float(f["gi_history"][f["instance_id"] >= 0].mean())
             for f in fly]
    _check(all(np.isfinite(f["color"]).all() for f in fly),
           "flythrough: colour not finite")
    _check(means[2] > 1.0, f"flythrough: mean gi_history {means[2]:.3f} "
           "by the third frame")
    print(f"  render_flythrough(5, orbit, dt=1/60, temporal=True, "
          f"gi_scale=2): mean gi_history over covered pixels "
          + ", ".join(f"{x:.3f}" for x in means)
          + f"; {1e3 * fly_s / 5:.1f} ms a frame (host clock, host copy "
          f"included); SDF rebuilds: {int(r.last_build_ms != builds)} "
          f"[{card}]")
    return {name: n for name, n in per_frame.items() if n}, times


def _sdf_views(r, card: str) -> None:
    """Phase 20: each SDF debug view of renderer ``r``'s frame: camera
    rays marched by the trilinear loop, no kernel launched."""
    import torch

    from vri_tpu_torch.config import DebugMode

    for mode in range(DebugMode.SDF_DISTANCE, DebugMode.SDF_CASCADE_ID + 1):
        _reset_counts()
        start, stop = _events()
        start.record()
        out = r.render(mode=mode)
        stop.record()
        torch.cuda.synchronize()
        launches = _counts()
        _check(sum(launches.values()) == 0,
               f"SDF view {mode}: launch counts {launches}")
        _check(set(out) == {"color", "depth"} and
               np.isfinite(out["color"]).all(),
               f"SDF view {mode}: AOVs {sorted(out)} or colour not finite")
        hit = float((out["depth"] < 1e30).mean())
        print(f"SDF debug view {mode}: {hit:.4f} of pixels hit; {start.elapsed_time(stop):.1f} ms with the "
              f"host copy (CUDA events, one frame), no kernel launch "
              f"[{card}]")


def _reference_preset(dev, h: int, w: int, card: str) -> None:
    """Phase 19: the reference preset's GI frame (``SDFConfig()``:
    8 cascades, ``approx_occlusion=False``) on the Cornell box at
    1920x1080 through ``render(gi=True)``: the shadow rays launch
    ``march_rays`` once (held to its plain version on them), the GI rays
    march the trilinear loop."""
    import torch

    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.ops import gi, march_kernel, sdf_trace
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.renderer import Renderer

    cfg = SDFConfig()
    rq = Renderer(RenderConfig(width=w, height=h, sdf=cfg), device=dev)
    rq.load_stage(scenes.cornell_box())
    cas = rq.ensure_cascades()
    _reset_counts()
    start, stop = _events()
    start.record()
    out = rq.render(gi=True)
    stop.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(stop)
    launches = _counts()
    _check(launches == _launches(raster_tiles=1, march_rays=1),
           f"reference preset frame: launch counts {launches}")
    _check(np.isfinite(out["color"]).all(),
           "reference preset frame: colour not finite")
    cov = float((out["instance_id"] >= 0).mean())
    _check(cov > 0.5, f"reference preset frame: coverage {cov:.3f}")
    dev_ms = _time_ms(lambda: rq.render(gi=True, to_numpy=False), 3)
    # kernel M on the frame's shadow rays (8 cascades) against its plain
    # version; then the GI rays through the trilinear loop alone
    fp = frame_mod.FrameParams.from_camera(rq.camera, h, device=dev)
    _, gb = frame_mod._gbuffer(rq.scene, fp, h, w, "raster",
                               rq.config.lod_tau)
    margs, mkw, got, _ = _hold_march(
        cas, gi.shadow_rays(gb.position, gb.normal, rq.scene, cas, cfg),
        cfg, cfg.shadow_steps, "reference preset's shadow")
    shadow_ms = _time_ms(lambda: march_kernel.march_rays(*margs, **mkw), 10)
    print(f"  march_rays on the reference preset's shadow rays "
          f"({int(margs[1].shape[1])} cascades): {margs[0].shape[1]} rays, "
          f"{float((got[1] >= 0).float().mean()):.3f} hit, steps mean "
          f"{float(got[2].float().mean()):.2f}, max {int(got[2].max())}; "
          f"equal to the plain version; {shadow_ms:.3f} ms (CUDA events, "
          f"mean of 10) [{card}]")
    del margs, got
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    u = torch.rand((h * w, 2), generator=gen, device=dev)
    go, gd, grange = gi.gi_rays(gb.position, gb.normal, u, cas, cfg)

    def loop():
        return sdf_trace.march(cas, go, gd, grange, config=cfg,
                               max_steps=cfg.gi_steps, approx=False)

    _reset_counts()
    rec = loop()
    torch.cuda.synchronize()
    _check(sum(_counts().values()) == 0, "the trilinear loop launched a "
           "kernel")
    max_it = int(rec.iterations.max())
    # the loop tests for a live ray every _CHECK_EVERY steps
    every = sdf_trace._CHECK_EVERY
    steps = min(cfg.gi_steps, -(-max_it // every) * every)
    loop_ms = _time_ms(loop, 3)
    print(f"reference preset frame (SDFConfig(), Cornell 1920x1080, "
          f"render(gi=True)): SDF build + bake {rq.last_build_ms:.1f} ms "
          f"(host clock), {int(cas.num_bricks)} bricks; frame "
          f"{frame_ms:.2f} ms with the host copy, {dev_ms:.2f} ms without "
          f"(CUDA events, mean of 3); launches {launches}; coverage "
          f"{cov:.4f} [{card}]")
    print(f"  trilinear loop on the frame's {go.shape[0]} GI rays: "
          f"{loop_ms:.2f} ms (CUDA events, mean of 3), {steps} steps "
          f"(iterations mean {float(rec.iterations.float().mean()):.2f}, "
          f"max {max_it}), {loop_ms / max(steps, 1):.3f} ms a step; "
          f"{float(rec.hit.float().mean()):.4f} hit [{card}]")



def _syncs(fn):
    """``fn()`` with torch's sync debug mode warning on every host sync;
    returns (its result, the number of host syncs it made)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(c.message) for c in caught)


def _focal(fp):
    import torch

    return 1.0 / torch.clamp(fp.pixel_spread, min=1e-8)


def _lod_city(city: dict, card: str) -> None:
    """Phase 22 on phase 11's city: one ``_visibility_raster`` frame at
    ``lod_tau=0.75`` (the mask is present, so the uncompacted sorted
    tier), the capacities escalated as the renderer's ladder does; kernel
    R held bit-equal to its plain version on that frame's lists."""
    import torch

    from vri_tpu_torch.ops import lod, rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    scene, world, fp = city["scene"], city["world"], city["fp"]
    h, w = 1080, 1920
    mask, levels = lod.face_mask(scene, fp.eye, _focal(fp), 0.75)
    ni = int(scene.num_instances)
    hist = torch.bincount(levels[:ni].long(), minlength=4).tolist()

    def frame(scale):
        return frame_mod._visibility_raster(scene, world, fp, h, w,
                                            caps_scale=scale, lod_tau=0.75)

    scale, ladder = _settle(frame, "LOD city")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times = []
    for i in range(3):
        start, stop = _events()
        start.record()
        hit = frame(scale)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        _check(int(hit.overflow) == 0, f"LOD city frame {i}: overflow")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    _check(launches == _launches(raster_tiles=3),
           f"LOD city: launch counts {launches}")
    _check(bool(mask[hit.tri[hit.tri >= 0].long()].all()),
           "LOD city: a face of a level not chosen won a pixel")
    prep = rasterize.prepare_sorted(
        world, scene.tri_vertices, scene.num_faces_total, fp.view_proj,
        height=h, width=w, caps_scale=scale,
        cull_sign=frame_mod._cull_sign(scene), face_mask=mask)
    _hold_raster_tiles(prep, "the LOD city's lists")
    print(f"LOD city (lod_levels=3, lod_tau=0.75, 1920x1080): "
          f"{int(mask.sum())} faces selected of {int(scene.num_faces_total)}"
          f" in the chains ({int(scene.num_faces)} base, pool "
          f"{city['pool']}); instances per level {hist}; ladder (caps_scale,"
          f" overflow) {ladder}; {int(prep['lists'].shape[0])} pairs, "
          f"raster_tiles equal to the plain version on them; uncompacted "
          f"sorted frames " + ", ".join(f"{t:.2f}" for t in times)
          + " ms against phase 11's lod_tau=0 compacted frames "
          + ", ".join(f"{t:.2f}" for t in city["times"])
          + f" (CUDA events); launches {launches}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")


def _lod_tiers(dev, card: str) -> int:
    """Phase 22's tiers: the LOD-masked sorted and ranged tiers on
    ``kitchen_stress(256, tess=4)`` at 1080p, and the masked sorted,
    binned and ranged tiers on ``kitchen_stress(64, tess=4)`` at 512^2
    (at tess 1 and 2 no mesh reaches ``lod_min_faces``, so no chain is
    packed), each with ``lod_levels=3, lod_min_faces=64`` at the stage
    camera and ``lod_tau=0.75``, bit-equal.  Returns the masked ranged
    tier's ``raster_ranged`` launches at 1080p."""
    import torch

    from vri_tpu_torch import RenderConfig, scenes
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import lod, rasterize
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    k6 = 0
    for n_obj, h, w, tiers in ((256, 1080, 1920, ("sorted", "ranged")),
                               (64, 512, 512,
                                ("sorted", "binned", "ranged"))):
        d = RenderDelegate(RenderConfig(width=w, height=h, lod_levels=3,
                                        lod_min_faces=64), device=dev)
        t0 = time.perf_counter()
        d.populate(scenes.kitchen_stress(num_objects=n_obj, tess=4))
        sc = d.sync()
        pack_s = time.perf_counter() - t0
        fp = frame_mod.FrameParams.from_camera(d.camera, h, device=dev)
        mask, levels = lod.face_mask(sc, fp.eye, _focal(fp), 0.75)
        ni = int(sc.num_instances)
        hist = torch.bincount(levels[:ni].long(), minlength=4).tolist()
        args = (bake_world(sc), sc.tri_vertices, sc.num_faces_total,
                fp.view_proj)
        kw = dict(height=h, width=w, cull_sign=frame_mod._cull_sign(sc),
                  face_mask=mask)
        fns = {"sorted": rasterize.rasterize_sorted,
               "binned": rasterize.rasterize_binned,
               "ranged": rasterize.rasterize}
        hits = {}
        for t in tiers:
            _reset_counts()
            hits[t] = fns[t](*args, **kw)[0]
            if t == "ranged":
                torch.cuda.synchronize()
                n = _counts()["raster_ranged"]
                _check(n == 1, f"masked ranged tier: {n} launches")
                if h == 1080:
                    k6 = n
            _check(hits[t].overflow is None or int(hits[t].overflow) == 0,
                   f"masked {t} tier, {n_obj} objects: overflow")
        for t in tiers[1:]:
            for key in ("tri", "t", "u", "v"):
                _check(torch.equal(getattr(hits[t], key),
                                   getattr(hits["sorted"], key)),
                       f"masked {t} tier, {n_obj} objects: {key} differs from "
                       "the sorted tier's")
        tri = hits["sorted"].tri
        _check(bool(mask[tri[tri >= 0].long()].all()),
               f"masked tiers, {n_obj} objects: a masked face won a "
               "pixel")
        times = {t: _time_ms(lambda fn=fns[t]: fn(*args, **kw), 5)
                 for t in tiers}
        print(f"LOD-masked tiers, kitchen_stress({n_obj}, tess=4) {w}x{h}: "
              f"{int(mask.sum())} faces selected of "
              f"{int(sc.num_faces_total)} ({int(sc.num_faces)} base; LOD "
              f"pack and sync {pack_s:.1f} s, host clock); instances per "
              f"level {hist}; {' = '.join(tiers)} bit-equal; "
              + ", ".join(f"{t} {times[t]:.3f} ms" for t in tiers)
              + f" (CUDA events, mean of 5) [{card}]")
    return k6


def _smallest_instance(scene) -> int:
    ni = int(scene.num_instances)
    ext = (scene.instance_aabb_hi - scene.instance_aabb_lo)[:ni].max(-1)
    return int(ext.values.argmin())


def _dirty_boxes(lo, hi, moves, dev):
    """(64, 3) dirty boxes: the instance's box at each offset of
    ``moves``, dead (+BIG/-BIG) rows after them."""
    import torch

    dlo = torch.full((64, 3), 3.0e38, device=dev)
    dhi = torch.full((64, 3), -3.0e38, device=dev)
    for j, off in enumerate(moves):
        dlo[j], dhi[j] = lo + off, hi + off
    return dlo, dhi


def _voxel_equal(a, b, label: str, atol: float = 0.0) -> None:
    """Occupancy, ESD, atlas (within ``atol`` plus one u8 step when
    ``atol`` > 0) and albedo per voxel of two cascade sets, and their
    march tables when ``atol`` is 0."""
    import torch

    ba, bb = a.brick_map.reshape(-1), b.brick_map.reshape(-1)
    occ = ba >= 0
    _check(torch.equal(occ, bb >= 0), f"{label}: occupancy differs")
    _check(torch.equal(torch.where(occ, 0, ba), torch.where(occ, 0, bb)),
           f"{label}: ESD differs")
    ia, ib = ba[occ].long(), bb[occ].long()
    if atol:
        da = a.atlas[ia].float() / 255.0 - b.atlas[ib].float() / 255.0
        _check(float(da.abs().max()) <= atol + 1.0 / 255.0,
               f"{label}: atlas differs")
        return
    _check(torch.equal(a.atlas[ia], b.atlas[ib]), f"{label}: atlas differs")
    _check(torch.equal(a.brick_albedo[ia], b.brick_albedo[ib]),
           f"{label}: albedo differs")
    for f in ("march_coarse", "march_fine0", "march_fine1"):
        _check(torch.equal(getattr(a, f), getattr(b, f)),
               f"{label}: {f} differs")


def _animated(r, h: int, w: int, card: str) -> dict:
    """Phase 23 on renderer ``r`` (phase 7's kitchen, 1080p, room preset,
    its cascades reused): (a) ``update_for_scene`` moving the smallest
    prop; (b) 5 frames of ``render_frame_gi_dynamic`` with the prop on
    ``bench.py``'s oscillating path (``bench.py:220-280``); (c) kernel M
    held to its plain version on the last partial bake's shadow rays;
    (d) ``animated_stage()`` through ``render(time_code=t)``.  Returns
    the launches of one dynamic frame."""
    import dataclasses
    import math

    import torch

    from vri_tpu_torch import RenderConfig, scenes
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    dev = r.device
    eff = r._sdf_cfg_effective or r.config.sdf
    scene = r.scene.base_view()
    k = _smallest_instance(scene)
    lo0, hi0 = scene.instance_aabb_lo[k], scene.instance_aabb_hi[k]
    tf0 = scene.instance_transform
    dirty_tri = scene.tri_instance == k

    def moved(off):
        tf = tf0.clone()
        tf[k, :3, 3] += off
        return scene.replace(instance_transform=tf)

    def offset(i):
        ph = 0.7 * (i + 1)
        return torch.tensor([0.03 * math.sin(ph), 0.0, 0.03 * math.cos(ph)],
                            device=dev)

    # -- (a) the bounded update on its own ----------------------------------
    cells = []
    real_apply = sdf_build._apply_dirty_cells

    def counted(cas, st, cell_ids, *a, **kw):
        cells.append(int(cell_ids.shape[0]))
        return real_apply(cas, st, cell_ids, *a, **kw)

    off = offset(0)
    s1 = moved(off)
    world1 = bake_world(s1)
    dlo, dhi = _dirty_boxes(lo0, hi0, (0.0, off), dev)

    def update():
        return sdf_build.update_for_scene(r.cascades, r._build_state, s1,
                                          world1, dirty_tri, dlo, dhi, eff)

    sdf_build._apply_dirty_cells = counted
    try:
        (_, st1, nf), n_sync = _syncs(update)
        torch.cuda.synchronize()
        start, stop = _events()
        t0 = time.perf_counter()
        start.record()
        _, _, nf2 = update()
        stop.record()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        sdf_build._apply_dirty_cells = real_apply
    upd_ms = start.elapsed_time(stop)
    _check(int(nf) == 0 and int(nf2) == 0,
           f"bounded update: needs_full {int(nf)}")
    print(f"bounded SDF update (update_for_scene, the smallest prop moved by "
          f"{float(off.norm()):.3f}; K {eff.cell_list_cap}, Kg "
          f"{eff.global_list_cap}): needs_full 0; {cells[0]} dirty cells "
          f"(cap {eff.update_cell_cap}), {int(dirty_tri.sum())} dirty "
          f"triangles (cap {eff.update_tri_cap}), "
          f"{int(st1.emit_bricks.sum())} bricks re-emitted (cap "
          f"{eff.update_brick_cap}); {upd_ms:.1f} ms (CUDA events), "
          f"{host_ms:.1f} ms host clock, against the full build + bake "
          f"{r.last_build_ms:.1f} ms (phase 7, host clock); {n_sync} host "
          f"syncs [{card}]")
    del st1

    # -- (b) 5 animated frames ------------------------------------------------
    fp = frame_mod.FrameParams.from_camera(r.camera, h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rebake = []
    real_partial = sdf_mod.bake_brick_lighting_partial

    def recorded(cas, sc, mask, alive, **kw):
        rebake.append(int((mask & alive).sum()))
        return real_partial(cas, sc, mask, alive, **kw)

    cas, st = r.cascades, r._build_state
    state = frame_mod.init_temporal(h, w, 2, device=dev)
    kw = dict(height=h, width=w, config=eff, backend="raster", samples=1,
              use_cache=True, gi_scale=2, lod_tau=r.config.lod_tau,
              generator=gen)
    per_frame = _launches(raster_tiles=1, march_rays=3, sdf_emit=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, covs = [], []
    sdf_mod.bake_brick_lighting_partial = recorded

    def step(i):
        prev = offset(i - 1) if i else torch.zeros(3, device=dev)
        dl, dh = _dirty_boxes(lo0, hi0, (prev, offset(i)), dev)
        s_i = moved(offset(i))
        return frame_mod.render_frame_gi_dynamic(
            s_i, fp, cas, st, state, dirty_tri, dl, dh, **kw), s_i, dl, dh

    try:
        for i in range(5):
            before = _counts()
            start, stop = _events()
            start.record()
            (aovs, state, cas, st, nf), s_i, dl, dh = step(i)
            out = {key: v.cpu().numpy() for key, v in aovs.items()}
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
            got = {key: v - before[key] for key, v in _counts().items()}
            _check(got == per_frame, f"dynamic frame {i}: launches {got}")
            _check(int(nf) == 0, f"dynamic frame {i}: needs_full {int(nf)}")
            _check(np.isfinite(out["color"]).all(),
                   f"dynamic frame {i}: colour not finite")
            covs.append(float((out["instance_id"] >= 0).mean()))
            _check(covs[-1] > 0.5, f"dynamic frame {i}: coverage {covs[-1]}")
        peak = torch.cuda.max_memory_allocated()
        ((_, state, cas, st, nf), s_i, dl, dh), n_sync = _syncs(
            lambda: step(5))
    finally:
        sdf_mod.bake_brick_lighting_partial = real_partial
    print(f"dynamic frames (render_frame_gi_dynamic, gi_scale=2, 1 spp, "
          f"use_cache, raster; kitchen 1920x1080, room; the smallest prop on "
          f"bench.py's path): frames 1-5 "
          + ", ".join(f"{t:.1f}" for t in times)
          + f" ms with the host copy (CUDA events); launches per frame "
          f"{ {n: c for n, c in per_frame.items() if c} }; needs_full 0; "
          f"coverage {min(covs):.4f}; re-bake sets "
          + ", ".join(str(n) for n in rebake[:5])
          + f" bricks of cap {eff.bake_brick_cap}; {n_sync} host syncs in "
          f"one frame (frame 6); peak memory {peak / 2 ** 30:.2f} GiB "
          f"[{card}]")

    # -- phase 25's dynamic band frames on this state -------------------------
    bstate = [frame_mod.init_temporal(BAND_H, w, 2, device=dev), cas, st]
    last = {}

    def band_frame(j):
        dl7, dh7 = _dirty_boxes(lo0, hi0, (offset(5 + j), offset(6 + j)),
                                dev)
        s7 = moved(offset(6 + j))
        last.update(scene=s7, dlo=dl7, dhi=dh7)
        aovs_, bstate[0], bstate[1], bstate[2], nf_ = \
            frame_mod.render_frame_gi_dynamic(
                s7, fp, bstate[1], bstate[2], bstate[0],
                dirty_tri, dl7, dh7, band=(BAND_Y0, h),
                **dict(kw, height=BAND_H))
        return aovs_, nf_

    _band_dynamic(band_frame, per_frame, times, card)
    # kernel M on the last dynamic band frame's three ray sets: its
    # partial bake's shadow rays and its band's shadow and GI rays
    n_rays, n_bricks = _hold_partial_bake(
        bstate[1], bstate[2], last["scene"], last["dlo"], last["dhi"], eff,
        "the last dynamic band frame")
    held = _frame_rays(last["scene"], fp, bstate[1], eff, BAND_H, w, gen,
                       r.config.lod_tau, "dynamic band frame", y0=BAND_Y0,
                       proj_height=h)
    print(f"  march_rays on the last dynamic band frame's partial bake "
          f"({n_rays} shadow rays, {n_bricks} bricks), its "
          f"{held['shadow'][0][0].shape[1]} shadow rays and "
          f"{held['gi'][0][0].shape[1]} GI rays: equal to the plain version"
          f" [{card}]")
    del bstate, held, last

    # -- (c) kernel M on the partial bake's shadow rays -----------------------
    n_rays, n_bricks = _hold_partial_bake(cas, st, s_i, dl, dh, eff,
                                          "the last dynamic frame")
    print(f"  march_rays on the partial bake's {n_rays} shadow rays "
          f"({n_bricks} bricks): equal to the plain version [{card}]")
    del cas, st, state

    # -- (d) animated_stage through render(time_code=) ----------------------
    # the room preset with update capacities that hold all 8 props moving
    # at once (the preset's 1,024 cells and 8,192 bricks hold about one
    # prop: (a)) and 64 triangles a brick, so that no near candidate is
    # dropped and the update is exactly a rebuild
    acfg = dataclasses.replace(r.config.sdf, update_cell_cap=6 * 4096,
                               update_brick_cap=1 << 18,
                               max_triangles_per_brick=64)
    ra = Renderer(RenderConfig(width=w, height=h, sdf=acfg), device=dev)
    ra.load_stage(scenes.animated_stage())
    labels, build_ms = [], []
    cells.clear()
    emitted = []

    def counted_emit(cas_, st_, cell_ids, *a, **kw_):
        cells.append(int(cell_ids.shape[0]))
        out_ = real_apply(cas_, st_, cell_ids, *a, **kw_)
        emitted.append(int(out_[1].emit_bricks.sum()))
        return out_

    sdf_build._apply_dirty_cells = counted_emit
    try:
        for t in (0.0, 4.0, 8.0):
            out = ra.render(gi=True, time_code=t)
            labels.append(ra.last_build_label)
            build_ms.append(ra.last_build_ms)
            _check(np.isfinite(out["color"]).all(),
                   f"animated stage at t={t}: colour not finite")
    finally:
        sdf_build._apply_dirty_cells = real_apply
    _check(labels[0] == "rebuilt"
           and all(x.startswith("updated (") for x in labels[1:]),
           f"animated stage: cascade paths {labels} (dirty cells {cells}, "
           f"bricks re-emitted {emitted})")
    fresh = Renderer(RenderConfig(width=w, height=h, sdf=acfg), device=dev)
    fresh.load_stage(scenes.animated_stage())
    fresh._sdf_cfg_effective = ra._sdf_cfg_effective
    fresh.sync(time_code=8.0)
    fresh.ensure_cascades(eye=ra.camera.eye)
    _check(int(fresh.cascades.near_drop) == 0,
           f"animated stage: {int(fresh.cascades.near_drop)} near "
           "candidates dropped")
    _voxel_equal(ra.cascades, fresh.cascades,
                 "animated stage: update against a full build at t=8")
    print(f"animated stage (animated_stage(), 1920x1080, room with update "
          f"caps {acfg.update_cell_cap} cells and {acfg.update_brick_cap} "
          f"bricks, 64 triangles a brick) through render(time_code=0, 4, "
          f"8): {labels}; {cells} dirty cells, {emitted} bricks "
          f"re-emitted; cascade ms (host clock, bake included) "
          + ", ".join(f"{t:.1f}" for t in build_ms)
          + f", a full build at t=8 {fresh.last_build_ms:.1f}; the updated "
          f"cascades voxel-equal to it (occupancy, ESD, atlas, albedo, march "
          f"tables), no near candidate dropped [{card}]")
    return {n: c for n, c in per_frame.items() if c}


def _scroll_and_app(r, h: int, w: int, card: str, out_dir: str) -> None:
    """Phase 24: the clipmap scroll through ``ensure_cascades`` on
    renderer ``r`` (its focus moved by two coarse voxels along x), the
    scroll on ``animated_stage()`` against a fresh build, and the app's
    ``--builtin animated`` and ``--lod 3``."""
    import dataclasses

    import torch

    from vri_tpu_torch import RenderConfig, app, scenes
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    eff = r._sdf_cfg_effective or r.config.sdf
    coarse = eff.voxel_size(eff.num_cascades - 1)
    # a two-coarse-voxel move enters more cells than the room preset's
    # update_cell_cap (1,024; about 768 in cascade 0 alone), where the
    # renderer would rebuild: the scroll runs with capacities that hold it
    r._sdf_cfg_effective = dataclasses.replace(
        eff, update_cell_cap=6 * 4096, update_brick_cap=1 << 18)
    entering, emitted = [], []
    real_apply = sdf_build._apply_dirty_cells

    def counted(cas, st, cell_ids, *a, **kw):
        entering.append(int(cell_ids.shape[0]))
        out = real_apply(cas, st, cell_ids, *a, **kw)
        emitted.append(int(out[1].emit_bricks.sum()))
        return out

    # toward the room's center (the stage camera's eye lies outside the
    # stage's box, so the focus sits on its +x face)
    focus = r._cascade_focus - np.asarray([2.0 * coarse, 0.0, 0.0],
                                          np.float32)
    build_ms = r.last_build_ms
    sdf_build._apply_dirty_cells = counted
    try:
        r.ensure_cascades(focus=focus)
    finally:
        sdf_build._apply_dirty_cells = real_apply
    _check(r.last_build_label.startswith("scrolled "),
           f"scroll: the cascades were {r.last_build_label} (entering "
           f"cells {entering}, bricks re-emitted {emitted})")
    print(f"clipmap scroll (focus moved {2.0 * coarse:.2f} along -x): "
          f"{r.last_build_label}, {entering[0]} entering cells (the room "
          f"preset's cap {eff.update_cell_cap}), {emitted[0]} bricks emitted "
          f"(its cap {eff.update_brick_cap}); scroll + bake "
          f"{r.last_build_ms:.1f} ms against the full build + bake "
          f"{build_ms:.1f} ms (host clock) [{card}]")

    # the scroll on the animated stage against a fresh build, both
    # without scene colours (tests/test_sdf_build.py's contract)
    ra = Renderer(RenderConfig(width=w, height=h, sdf=r.config.sdf),
                  device=r.device)
    ra.load_stage(scenes.animated_stage())
    sc = ra.scene
    world = bake_world(sc)
    # capacities that hold the scroll, 64 triangles a brick (no near
    # candidate dropped, so the top-k does not depend on list order)
    cfg = dataclasses.replace(r.config.sdf, update_cell_cap=6 * 4096,
                              update_brick_cap=1 << 18,
                              max_triangles_per_brick=64)
    c0 = sdf_mod.default_centers(cfg, np.zeros(3, np.float32),
                                 device=r.device)
    cfg = sdf_build.demand_caps(sc, world, c0, cfg)
    c1 = sdf_mod.default_centers(
        cfg, np.asarray([-2.0 * coarse, 0.0, 0.0], np.float32),
        device=r.device)
    scrolled = tuple(bool(x) for x in (c0 != c1).any(-1).tolist())
    args = (world, sc.tri_vertices, sc.num_faces)
    cas0, st0 = sdf_build.build_cascades_binned(*args, c0, config=cfg)
    cas1, st1, nf = sdf_build.scroll_cascades(
        cas0, st0, c1, *args, config=cfg, scrolled=scrolled)
    _check(int(nf) == 0, f"animated stage scroll: needs_full {int(nf)}")
    ref, refst = sdf_build.build_cascades_binned(*args, c1, config=cfg)
    # with near candidates past max_triangles_per_brick the top-k choice
    # depends on the candidates' list order, which a scroll keeps from the
    # old window: the voxel contract holds where no candidate is dropped
    _check(int(cas0.near_drop) == 0 and int(ref.near_drop) == 0,
           f"animated stage scroll: near candidates dropped "
           f"({int(cas0.near_drop)}, {int(ref.near_drop)})")
    _voxel_equal(cas1, ref, "animated stage scroll", atol=2e-6)
    a, b = st1.cell_tris, refst.cell_tris
    differ = (a != b).any(-1).nonzero().tolist()
    for n, cell in differ:
        sa = set(a[n, cell][a[n, cell] >= 0].tolist())
        sb = set(b[n, cell][b[n, cell] >= 0].tolist())
        _check(sa <= sb or sb <= sa, f"animated stage scroll: the lists of "
               f"cell {cell} of cascade {n} do not nest")
    print(f"  animated stage scroll ({sum(scrolled)} cascades scrolled): "
          f"voxel-equal to a fresh build at the new centers (atlas within "
          f"2e-6 and one u8 step); {len(differ)} cell lists differ, each "
          f"nesting [{card}]")
    del ra, cas0, st0, cas1, st1, ref, refst
    torch.cuda.empty_cache()

    for argv, tag in ((["--builtin", "animated", "--frames", "4"],
                       "animated"),
                      (["--builtin", "kitchen", "--lod", "3"], "lod")):
        d = os.path.join(out_dir, f"app_{tag}")
        t0 = time.perf_counter()
        rc = app.main(argv + ["--out", d])
        pngs = sorted(f for f in os.listdir(d) if f.endswith(".png")) \
            if os.path.isdir(d) else []
        _check(rc == 0 and len(pngs) == (4 if tag == "animated" else 1),
               f"app {' '.join(argv)}: exit {rc}, PNGs {pngs}")
        print(f"app {' '.join(argv)}: exit 0, {len(pngs)} PNGs in "
              f"{time.perf_counter() - t0:.1f} s (host clock) [{card}]")

#: the band of ``bench.py``'s ``gi_band135_ms`` (``bench.py:286-287``):
#: 136 rows at y0 = 472 of the 1080-row frame
BAND_Y0, BAND_H = 472, 136


def _bands(r, h: int, w: int, cfg, card: str, prod_ms: list) -> dict:
    """Phase 25 on renderer ``r`` (phase 7's kitchen, room preset, its
    cascades reused): (a) ``bench.py``'s ``gi_band135_ms`` frame, 10
    frames of ``render_frame_gi_temporal(band=(472, 1080))`` at
    ``gi_scale=2`` from an empty band history, each one ``raster_tiles``
    and two ``march_rays``, beside phase 18's full frame; (b) the band's
    instance ids and depth against rows 472-607 of a full production
    frame; (c) a Cornell 512^2 band through the binned tier and the
    kitchen band through ``raster_ranged``, each bit-equal to the sorted
    tier's band, the dispatch taking the binned tier on the Cornell band
    and the sorted tier on the kitchen's, and ``raster_tiles`` and
    ``raster_ranged`` held to their plain versions on each band's own
    lists and chunks; (d) ``march_rays`` held to its plain version on the
    band frame's shadow and GI rays.  Returns the launches of one band
    frame."""
    import torch

    from vri_tpu_torch import RenderConfig, scenes
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    dev = r.device
    cas = r.ensure_cascades(eye=r.camera.eye)
    fp = frame_mod.FrameParams.from_camera(r.camera, h, device=dev)
    kw = dict(width=w, config=cfg, backend="raster", samples=1,
              use_cache=True, gi_scale=2, lod_tau=r.config.lod_tau)
    band = dict(height=BAND_H, band=(BAND_Y0, h))
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)

    # -- (a) the band frame --------------------------------------------------
    state = frame_mod.init_temporal(BAND_H, w, 2, device=dev)
    per_frame = _launches(raster_tiles=1, march_rays=2)
    _reset_counts()
    times = []
    for i in range(10):
        before = _counts()
        start, stop = _events()
        start.record()
        aovs, state = frame_mod.render_frame_gi_temporal(
            r.scene, fp, cas, state, generator=gen, **band, **kw)
        out = {k: v.cpu().numpy() for k, v in aovs.items()}
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        step = {k: v - before[k] for k, v in _counts().items()}
        _check(step == per_frame, f"band frame {i}: launches {step}")
        _check(out["color"].shape == (BAND_H, w, 3),
               f"band frame {i}: colour shape {out['color'].shape}")
        _check(int(out["raster_overflow_tiles"]) == 0,
               f"band frame {i}: raster overflow")
        _check(np.isfinite(out["color"]).all(),
               f"band frame {i}: colour not finite")
        cov = out["instance_id"] >= 0
        _check(cov.mean() > 0.5, f"band frame {i}: coverage {cov.mean():.3f}")
        _check(out["gi_history"].max() <= 17.0,
               f"band frame {i}: gi_history beyond the cap")
    launches = _counts()
    dev_ms = _time_ms(lambda: frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, state, generator=gen, **band, **kw), 5)
    from vri_tpu_torch.ops import gi, march_kernel

    st = _stages(lambda: frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, state, generator=gen, **band, **kw), {
            "gbuffer": (frame_mod, "_gbuffer"),
            "visibility": (frame_mod, "_visibility"),
            "direct": (frame_mod, "_direct_lighting"),
            "indirect": (gi, "indirect_radiance"),
            "march": (march_kernel, "march"),
            "reproject": (frame_mod, "_reproject")}, 5)
    print(f"band frame (render_frame_gi_temporal(height=136, band=(472, "
          f"1080)), gi_scale=2, 1 spp, use_cache, raster; kitchen 1920 wide, "
          f"room; bench.py's gi_band135_ms): frames 1-10 "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms with the host copy (CUDA events); {dev_ms:.2f} ms without "
          f"(mean of 5); the full 1080-row production frame (phase 18): "
          f"{float(np.mean(prod_ms)):.2f} ms with the host copy (mean of "
          f"10); launches {launches}; coverage {cov.mean():.4f} [{card}]")
    rest = st["frame"] - sum(st[k] for k in ("gbuffer", "direct",
                                            "indirect", "reproject"))
    print(f"  band frame's stages (host clock between synchronizes, mean of "
          f"5 frames, ms): frame {st['frame']:.2f} = G-buffer "
          f"{st['gbuffer']:.2f} (visibility {st['visibility']:.2f}) + direct "
          f"{st['direct']:.2f} + indirect {st['indirect']:.2f} + reproject "
          f"{st['reproject']:.2f} + blend, pack and compose {rest:.2f}; "
          f"march_kernel.march {st['march']:.2f} [{card}]")

    # -- (b) against the rows of a full production frame ---------------------
    full, _ = frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, frame_mod.init_temporal(h, w, 2, device=dev),
        height=h, generator=gen, **kw)
    rows = slice(BAND_Y0, BAND_Y0 + BAND_H)
    ids_f, dep_f = full["instance_id"][rows], full["depth"][rows]
    ids_b, dep_b = aovs["instance_id"], aovs["depth"]
    diff = (ids_b != ids_f) | ((ids_b >= 0)
                               & ((dep_b - dep_f).abs()
                                  > 1e-5 * dep_f.abs()))
    n_diff = int(diff.sum())
    print(f"  band against rows 472-607 of a full production frame: "
          f"instance id or depth (rtol 1e-5) differ on {n_diff} of "
          f"{diff.numel()} pixels; bound 0.5% [{card}]")
    _check(n_diff <= 0.005 * diff.numel(),
           f"band frame: {n_diff} pixels differ from the full frame's rows")
    del full, aovs, state

    # -- (c) the binned and ranged tiers on a band ----------------------------
    rc = Renderer(RenderConfig(width=512, height=512, sdf=cfg), device=dev)
    rc.load_stage(scenes.cornell_box())
    cases = {"Cornell 512x512, rows [192, 328)": (
                 rc.scene, rc.camera, 512, 512, 192, "binned",
                 rasterize.rasterize_binned, "raster_tiles"),
             "kitchen 1920x1080, rows [472, 608)": (
                 r.scene, r.camera, h, w, BAND_Y0, "ranged",
                 rasterize.rasterize, "raster_ranged")}
    real = {"binned": rasterize.rasterize_binned,
            "sorted": rasterize.rasterize_sorted}
    for label, (sc, cam, fh, fw, y0, tier, fn, kernel) in cases.items():
        fpc = frame_mod.FrameParams.from_camera(cam, fh, device=dev)
        world = bake_world(sc)
        args = (world, sc.tri_vertices, sc.num_faces, fpc.view_proj)
        bkw = dict(height=BAND_H, width=fw, proj_height=fh,
                   y_offset=float(y0), cull_sign=frame_mod._cull_sign(sc))
        ran = []
        rasterize.rasterize_binned = _tagged(real["binned"], "binned", ran)
        rasterize.rasterize_sorted = _tagged(real["sorted"], "sorted", ran)
        try:
            frame_mod._visibility_raster(sc, world, fpc, BAND_H, fw, y0=y0,
                                         proj_height=fh)
        finally:
            rasterize.rasterize_binned = real["binned"]
            rasterize.rasterize_sorted = real["sorted"]
        want_tier = "binned" if tier == "binned" else "sorted"
        _check(ran == [want_tier], f"{label}: the dispatch ran {ran}")
        _reset_counts()
        got = fn(*args, **bkw)[0]
        n = _counts()[kernel]
        want = rasterize.rasterize_sorted(*args, **bkw)[0]
        _check(n == 1, f"{label}: {n} {kernel} launches")
        _check(want.overflow is not None and int(want.overflow) == 0
               and (got.overflow is None or int(got.overflow) == 0),
               f"{label}: a tier overflowed")
        for key in ("tri", "t", "u", "v"):
            _check(torch.equal(getattr(got, key), getattr(want, key)),
                   f"{label}: the {tier} band's {key} differs from the "
                   "sorted band's")
        # each kernel on the band's own lists and chunks (band-local
        # slots, ty offset by the band's first row) against its plain
        # version
        sprep = rasterize.prepare_sorted(*args, **bkw)
        _hold_raster_tiles(sprep, f"{label}'s sorted lists")
        if tier == "binned":
            _hold_raster_tiles(rasterize.prepare_binned(*args, **bkw),
                               f"{label}'s binned lists")
        else:
            _hold_raster_ranged(rasterize.prepare_ranged(*args, **bkw),
                                sprep["counts"], f"{label}'s chunks")
        t_ms = _time_ms(lambda: fn(*args, **bkw), 5)
        s_ms = _time_ms(lambda: rasterize.rasterize_sorted(*args, **bkw), 5)
        print(f"  {label}: the dispatch takes the {want_tier} tier; the "
              f"{tier} tier ({kernel}) bit-equal to the sorted tier on the "
              f"band; raster_tiles on the band's sorted"
              + (" and binned lists" if tier == "binned" else
                 " lists and raster_ranged on its chunks")
              + f" equal to their plain versions; whole raster {tier} "
              f"{t_ms:.3f} ms, sorted {s_ms:.3f} ms (CUDA events, mean of "
              f"5) [{card}]")
    del rc, sprep

    # -- (d) kernel M on the band frame's own shadow and GI rays ---------------
    held = _frame_rays(r.scene, fp, cas, cfg, BAND_H, w, gen,
                       r.config.lod_tau, "band frame", y0=BAND_Y0,
                       proj_height=h)
    print(f"  march_rays on the band frame's "
          f"{held['shadow'][0][0].shape[1]} shadow rays (shadow_scale "
          f"{cfg.shadow_scale}) and {held['gi'][0][0].shape[1]} GI rays "
          f"(gi_scale 2): equal to the plain version [{card}]")
    del held
    return {name: c for name, c in per_frame.items() if c}


def _band_dynamic(frame_fn, per_frame: dict, anim_ms: list, card: str):
    """Phase 25's last step, on phase 23's state: two
    ``render_frame_gi_dynamic(band=(472, 1080))`` frames (``frame_fn(i)``
    runs frame i and returns its AOVs and ``needs_full``), each one
    ``raster_tiles`` and three ``march_rays`` launches, beside phase
    23's whole dynamic frames."""
    import torch

    times = []
    for i in range(2):
        before = _counts()
        start, stop = _events()
        start.record()
        aovs, nf = frame_fn(i)
        out = {k: v.cpu().numpy() for k, v in aovs.items()}
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        step = {k: v - before[k] for k, v in _counts().items()}
        _check(step == per_frame, f"dynamic band frame {i}: launches {step}")
        _check(int(nf) == 0, f"dynamic band frame {i}: needs_full {int(nf)}")
        _check(out["color"].shape[0] == BAND_H
               and np.isfinite(out["color"]).all(),
               f"dynamic band frame {i}: colour shape or values")
        cov = float((out["instance_id"] >= 0).mean())
        _check(cov > 0.5, f"dynamic band frame {i}: coverage {cov:.3f}")
    print(f"dynamic band frames (phase 25; render_frame_gi_dynamic(height="
          f"136, band=(472, 1080)) on phase 23's state; bench.py's "
          f"gi_anim_band_ms): "
          + ", ".join(f"{t:.1f}" for t in times)
          + " ms with the host copy (CUDA events) against the whole "
          f"frames' " + ", ".join(f"{t:.1f}" for t in anim_ms)
          + f"; launches per frame {per_frame}; needs_full 0; coverage "
          f"{cov:.4f} [{card}]")


def _dense(dev, card: str) -> dict:
    """Phase 26: the dense SDF build under ``SDFConfig.preset("tiny")``
    (r 16, truncation past one cell), through ``Renderer.render(gi=True)``
    on the Cornell box and on ``kitchen_stress(256, tess=4)`` at 1080p:
    the build's label, time, bricks and the occupied voxels past the
    preset's 8,192 bricks (counted, not raised), the frame's launches (one
    ``raster_tiles``, ``march_rays`` for the bake's and the frame's
    shadow rays; the preset marches GI rays with the trilinear loop), and
    kernel M bit-equal to its plain version on the frame's shadow rays.
    The build's time is also taken alone (CUDA events).  Returns the
    launches of the kitchen's frame."""
    import torch

    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.ops import gi
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    tiny = SDFConfig.preset("tiny")
    h, w = 1080, 1920
    launches = {}
    for label, make in (("Cornell", scenes.cornell_box),
                        ("kitchen_stress(256, tess=4)",
                         lambda: scenes.kitchen_stress(num_objects=256,
                                                       tess=4))):
        rd = Renderer(RenderConfig(width=w, height=h, sdf=tiny), device=dev)
        rd.load_stage(make())
        _reset_counts()
        start, stop = _events()
        start.record()
        out = rd.render(gi=True)
        stop.record()
        torch.cuda.synchronize()
        launches = _counts()
        cas = rd.cascades
        lights = int(rd.scene.num_lights)
        want = _launches(raster_tiles=1, march_rays=2 if lights else 0)
        _check(rd.last_build_label == "rebuilt (dense)",
               f"{label}, tiny: cascades {rd.last_build_label}")
        _check(launches == want, f"{label}, tiny: launches {launches}")
        _check(np.isfinite(out["color"]).all(),
               f"{label}, tiny: colour not finite")
        cov = float((out["instance_id"] >= 0).mean())
        _check(cov > 0.5, f"{label}, tiny: coverage {cov:.3f}")
        _check(int(out["raster_overflow_tiles"]) == 0,
               f"{label}, tiny: raster overflow")
        fp = frame_mod.FrameParams.from_camera(rd.camera, h, device=dev)
        _, gb = frame_mod._gbuffer(rd.scene, fp, h, w, "raster",
                                   rd.config.lod_tau)
        margs, _, got, _ = _hold_march(
            cas, gi.shadow_rays(gb.position, gb.normal, rd.scene, cas, tiny),
            tiny, tiny.shadow_steps, f"{label} tiny-preset shadow")
        scene_b = rd.scene.base_view()
        world = bake_world(scene_b)
        focus = rd._cascade_focus
        build_ms = _time_ms(lambda: sdf_mod.build_for_scene(
            scene_b, world, focus=focus, config=tiny), 2)
        print(f"dense SDF build ({label}, 1920x1080, preset tiny: "
              f"{tiny.num_cascades} cascades of {tiny.cascade_resolution}^3, "
              f"truncation {tiny.truncation_voxels} voxels): "
              f"{rd.last_build_label}, {int(cas.num_bricks)} bricks, "
              f"{int(cas.overflow)} occupied voxels past max_bricks "
              f"{tiny.max_bricks}; build {build_ms:.1f} ms (CUDA events, "
              f"mean of 2), build + bake {rd.last_build_ms:.1f} ms (host "
              f"clock); first frame {start.elapsed_time(stop):.1f} ms with "
              f"the build and the host copy; launches {launches}; "
              f"march_rays on the frame's {margs[0].shape[1]} shadow rays "
              f"equal to the plain version; coverage {cov:.4f} [{card}]")
        del rd, cas, gb, margs, got
        torch.cuda.empty_cache()
    return {name: c for name, c in launches.items() if c}


def _cache_and_checks(r, h: int, w: int, card: str, out_dir: str,
                      stage_s: float) -> None:
    """Phase 27 on renderer ``r`` (phase 7's kitchen): the scene cache
    saved and loaded into a fresh renderer, the scene equal field by
    field (positions within one uint16 quantization step, uvs within
    float16 rounding, textures within one u8 step, every other field
    exactly), a 1080p GI frame of the loaded scene against the original's
    with the same cascades and uniforms (instance ids on at least 99.5% of
    the pixels), the load time against the stage load, the file's bytes,
    and ``validate_scene`` on the kitchen without errors."""
    import dataclasses

    import torch

    from vri_tpu_torch import RenderConfig
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.renderer import Renderer
    from vri_tpu_torch.runtime import checks

    path = os.path.join(out_dir, "smoke_scene_cache.npz")
    t0 = time.perf_counter()
    r.save_cache(path)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    r3 = Renderer(RenderConfig(width=w, height=h, sdf=r.config.sdf),
                  device=r.device)
    t0 = time.perf_counter()
    r3.load_cache(path, camera=r.camera)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    os.remove(path)
    a, b = r.scene, r3.scene
    pos = a.positions
    step = float((pos.max(0).values - pos.min(0).values).max()) / 65535.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "mip_atlas" or not torch.is_tensor(x):
            _check(f.name == "mip_atlas" or x == y,
                   f"cache: {f.name} {x} against {y}")
            continue
        _check(torch.is_tensor(y) and x.shape == y.shape
               and x.dtype == y.dtype,
               f"cache: {f.name} shape or type differs")
        if x.numel() == 0:
            ok = True
        elif f.name == "positions":
            ok = float((x - y).abs().max()) <= 1.01 * step
        elif f.name == "tri_uv":
            ok = bool(((x - y).abs() <= 2.0 ** -11
                       * torch.clamp(x.abs(), min=1.0)).all())
        elif f.name == "textures":
            ok = float((x - y).abs().max()) <= 1.0 / 255.0 + 1e-6
        else:
            ok = torch.equal(x, y)
        _check(ok, f"cache: {f.name} differs after the round trip")
    cfg = r._sdf_cfg_effective or r.config.sdf
    fp = frame_mod.FrameParams.from_camera(r.camera, h, device=r.device)
    gen = torch.Generator(device=r.device)
    gen.manual_seed(27)
    uni = torch.rand((1, h * w, 2), generator=gen, device=r.device)
    kw = dict(height=h, width=w, config=cfg, use_cache=True, uniforms=uni,
              lod_tau=r.config.lod_tau)
    fa = frame_mod.render_frame_gi(a, fp, r.cascades, **kw)
    fb = frame_mod.render_frame_gi(b, fp, r.cascades, **kw)
    same = float((fa["instance_id"] == fb["instance_id"]).float().mean())
    _check(same >= 0.995, f"cache: the loaded scene's frame agrees on "
           f"{same:.4f} of pixels")
    _check(bool(torch.isfinite(fb["color"]).all()),
           "cache: the loaded scene's colour is not finite")
    t0 = time.perf_counter()
    findings = checks.validate_scene(a)
    check_ms = 1e3 * (time.perf_counter() - t0)
    _check(not [x for x in findings if x.severity == "error"],
           f"validate_scene: {[str(x) for x in findings]}")
    print(f"scene cache (kitchen_stress(256, tess=4)): {nbytes} bytes, "
          f"saved in {save_s:.2f} s, loaded into a fresh renderer in "
          f"{load_s:.2f} s against the stage load's {stage_s:.2f} s (host "
          f"clock); the scene equal field by field (positions within "
          f"{step:.2e}); the 1080p GI frame of the loaded scene with the "
          f"same cascades agrees on {same:.4f} of pixels; validate_scene "
          f"{[str(x) for x in findings]} in {check_ms:.1f} ms [{card}]")
    del r3, fa, fb, uni


def _app_runtime(card: str, out_dir: str) -> None:
    """Phase 28: ``python -m vri_tpu_torch.app`` on Cornell 512^2 with
    ``--sdf tiny``, with ``--cache`` (written, then read without loading
    the stage) and with ``--trace`` (at the tiny preset, which keeps the
    trace of the first frame's SDF build small): each exits 0 with its
    PNG; the trace holds the program's ``frame``, ``visibility`` and
    ``gbuffer`` spans and the names of kernel R's and kernel M's CUDA
    functions, and ``device_memory_stats()`` reports
    ``cuda:0``."""
    import glob

    from vri_tpu_torch import app
    from vri_tpu_torch import renderer as renderer_mod
    from vri_tpu_torch.runtime import profiler

    root = os.path.join(out_dir, "app_runtime")
    cpath = os.path.join(root, "cornell.cache.npz")
    tdir = os.path.join(root, "trace")
    os.makedirs(root, exist_ok=True)
    real_load = renderer_mod.Renderer.load_stage
    for tag, extra in (("tiny", ["--sdf", "tiny"]),
                       ("cache_write", ["--cache", cpath]),
                       ("cache_read", ["--cache", cpath]),
                       ("trace", ["--sdf", "tiny", "--trace", tdir])):
        d = os.path.join(root, tag)
        loads = []
        renderer_mod.Renderer.load_stage = (
            lambda self, *a: loads.append(a) or real_load(self, *a))
        t0 = time.perf_counter()
        try:
            rc = app.main(["--builtin", "cornell", "--width", "512",
                           "--height", "512", "--out", d, *extra])
        finally:
            renderer_mod.Renderer.load_stage = real_load
        pngs = glob.glob(os.path.join(d, "*.png"))
        _check(rc == 0 and len(pngs) == 1, f"app {tag}: exit {rc}, {pngs}")
        _check(len(loads) == (0 if tag == "cache_read" else 1),
               f"app {tag}: {len(loads)} stage loads")
        if tag == "cache_write":
            _check(os.path.exists(cpath), "app --cache wrote no file")
        print(f"app {' '.join(extra)} (Cornell 512x512): exit 0, 1 PNG, "
              f"{len(loads)} stage loads, {time.perf_counter() - t0:.1f} s "
              f"(host clock) [{card}]")
    (trace,) = glob.glob(os.path.join(tdir, "*.json"))
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    tbytes = os.path.getsize(trace)
    os.remove(trace)
    os.remove(cpath)
    kernels = {k: any(k in n for n in names)
               for k in ("raster_tiles_kernel", "march_rays_kernel")}
    spans = {k: k in names for k in ("frame", "visibility", "gbuffer")}
    _check(all(spans.values()) and all(kernels.values()),
           f"app --trace: spans {spans}, kernels {kernels}")
    mem = profiler.device_memory_stats()
    _check("cuda:0" in mem, f"device_memory_stats: {mem}")
    print(f"  app --trace: a {tbytes}-byte Chrome trace holding the frame, "
          f"visibility and gbuffer spans, raster_tiles_kernel and "
          f"march_rays_kernel; "
          f"device_memory_stats {mem} [{card}]")



# -- 29. multi-device: the row-sharded frames over torch.distributed ------------

#: the moved prop's first offset of phase 23 (``_animated.offset(0)``)
P29_OFFSET = (0.03 * 0.644217687237691, 0.0, 0.03 * 0.7648421872844885)
#: the frame of phase 29 (the app rounds the height to 8 x ranks in (b))
P29_H, P29_W = 1080, 1920


def _move(tree, dev):
    """A dataclass (nested) of tensors, its tensors on ``dev``."""
    import dataclasses

    import torch

    if torch.is_tensor(tree):
        return tree.to(dev)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _move(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _pan(cam, dy: float):
    """``cam`` moved up by ``dy`` (world units), looking the same way."""
    import dataclasses

    t = np.eye(4, dtype=np.float32)
    t[1, 3] = -dy
    return dataclasses.replace(cam, eye=cam.eye + np.float32([0, dy, 0]),
                               view=(cam.view @ t).astype(np.float32))


def _moved_prop(scene, dev):
    """(the scene with phase 23's prop moved, dirty triangles, dirty
    boxes)."""
    import torch

    k = _smallest_instance(scene)
    off = torch.tensor(P29_OFFSET, device=dev)
    tf = scene.instance_transform.clone()
    tf[k, :3, 3] += off
    dlo, dhi = _dirty_boxes(scene.instance_aabb_lo[k],
                            scene.instance_aabb_hi[k], (0.0, off), dev)
    return (scene.replace(instance_transform=tf), scene.tri_instance == k,
            dlo, dhi)


def _multi_device(r, h: int, w: int, card: str, kernels: dict) -> None:
    """Phase 29 on renderer ``r`` (phase 7's kitchen, room preset, its
    cascades and build state): the row-sharded frames of
    ``vri_tpu_torch.parallel``, their ranks started by ``mesh.launch``
    (``torch.distributed.run``) as subprocesses of this script
    (``--phase29 PART FILE``), each loading the scene, cascades and build
    state from one file of CPU tensors written here (no rank builds).
    (a) one ``nccl`` rank on cuda:0: the tiled static, temporal and
    dynamic frames at 1920x1080 bit-equal to ``render_frame_gi``,
    ``render_frame_gi_temporal`` and ``render_frame_gi_dynamic`` with the
    same uniforms and the same R / M launches; (b) four ``gloo`` ranks
    sharing cuda:0 at 1920x1056 (the app's rounding): the tiled frame at
    ``samples`` 0 and 1 against the single-card frame, the temporal frame
    carrying its history across the band borders, R and M held to their
    plain versions on rank 0's and rank 3's band inputs, each rank's band
    ms and peak memory; (d) on those ranks, ``esd_sharded`` and
    ``scroll_slab`` on cascade 0's occupancy and the 2 x 2 mesh's frame
    and scene merge; (c) two ``gloo`` ranks: the tiled dynamic frame's
    ``atlas`` and ``voxel_shade`` bit-equal to the single-card dynamic
    frame's (computed here), each rank's share of the emit and its
    re-bake launches."""
    import tempfile

    import torch

    from vri_tpu_torch.parallel import mesh as mesh_mod
    from vri_tpu_torch.passes import frame as frame_mod

    t_phase = time.perf_counter()
    dev = r.device
    eff = r._sdf_cfg_effective or r.config.sdf
    scene = r.scene.base_view()
    s1, dirty, dlo, dhi = _moved_prop(scene, dev)
    fp = frame_mod.FrameParams.from_camera(r.camera, h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    _, _, cas1, _, nf = frame_mod.render_frame_gi_dynamic(
        s1, fp, r.cascades, r._build_state,
        frame_mod.init_temporal(h, w, 2, device=dev), dirty, dlo, dhi,
        height=h, width=w, config=eff, samples=1, use_cache=True,
        gi_scale=2, lod_tau=r.config.lod_tau, generator=gen)
    _check(int(nf) == 0, f"phase 29: the single-card dynamic frame's "
           f"needs_full {int(nf)}")
    # the build state (its cell rows are most of the bytes) in a file of
    # its own, which only the dynamic frames' parts (a) and (c) load
    payload = dict(scene=_move(scene, "cpu"),
                   cascades=_move(r.cascades, "cpu"), config=eff,
                   camera=r.camera, lod_tau=r.config.lod_tau)
    build = dict(build_state=_move(r._build_state, "cpu"),
                 want_atlas=cas1.atlas.cpu(),
                 want_shade=cas1.voxel_shade.cpu())
    del cas1
    torch.cuda.empty_cache()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase29.pt")
        t0 = time.perf_counter()
        torch.save(payload, path)
        torch.save(build, path + ".build")
        del payload, build
        print(f"phase 29: the ranks' inputs written in "
              f"{time.perf_counter() - t0:.1f} s (host clock): "
              f"{os.path.getsize(path) / 2 ** 20:.0f} MiB scene and "
              f"cascades, {os.path.getsize(path + '.build') / 2 ** 20:.0f} "
              f"MiB build state and reference [{card}]")
        for part, nproc in (("a", 1), ("b", 4), ("c", 2)):
            t0 = time.perf_counter()
            proc = mesh_mod.launch(
                nproc, [os.path.abspath(__file__), "--phase29", part, path],
                capture=True, timeout=600)
            print(proc.stdout, end="")
            got = []
            for i in range(nproc):
                res_path = f"{path}.{part}{i}.json"
                if os.path.exists(res_path):
                    with open(res_path) as f:
                        got.append(json.load(f))
            _check(proc.returncode == 0,
                   f"phase 29({part}): a rank failed (exit "
                   f"{proc.returncode}):\n{proc.stderr[-4000:]}")
            _check(sorted(g["rank"] for g in got) == list(range(nproc)),
                   f"phase 29({part}): results from ranks "
                   f"{[g['rank'] for g in got]} of {nproc}")
            results[part] = sorted(got, key=lambda g: g["rank"])
            print(f"phase 29({part}): {nproc} rank(s) in "
                  f"{time.perf_counter() - t0:.1f} s with start-up (host "
                  f"clock); per rank: " + "; ".join(_p29_summary(g)
                                                    for g in got)
                  + f" [{card}]")
    per_rank = results["b"][0]["static1"]["launches"]
    kernels["raster_tiles"]["launches_tiled_frame_per_rank"] = \
        per_rank["raster_tiles"]
    kernels["march_rays"]["launches_tiled_frame_per_rank"] = \
        per_rank["march_rays"]
    kernels["march_rays"]["launches_sharded_rebake_per_rank"] = [
        g["rebake_launches"] for g in results["c"]]
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s in all (host "
          f"clock) [{card}]")


def _p29_summary(g: dict) -> str:
    """One rank's times (CUDA events, ms, the tiled call with its
    gathers) and peak memory."""
    times = ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in g.items()
                      if isinstance(v, dict) and "ms" in v)
    if "ms" in g:
        times = (f"dynamic {g['ms']:.1f} ms, emit share {g['share']} of "
                 f"{g['emitted']} bricks, {g['rebake_launches']} re-bake "
                 "march_rays")
    return (f"rank {g['rank']} ({g['backend']}): {times}; peak "
            f"{g['peak_gib']:.2f} GiB allocated")


def _p29_frame(fn, warm: bool = False):
    """(``fn()``, its launches, its CUDA-event ms); ``warm`` runs ``fn``
    once untimed first (the process's first frame allocates)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    _reset_counts()
    start, stop = _events()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _counts().items() if v}, \
        start.elapsed_time(stop)


def _p29_equal(a: dict, b: dict, keys, label: str) -> None:
    import torch

    for k in keys:
        _check(torch.equal(a[k], b[k]), f"{label}: {k} differs from the "
               "single-card frame's")


def _p29_part_a(mesh, scene, cas, st, cfg, cam, lod_tau, res,
                card: str) -> None:
    """(a): world size 1 over nccl, each tiled frame bit-equal to the
    single-card one with the same launches."""
    import torch

    from vri_tpu_torch.parallel import tiling
    from vri_tpu_torch.passes import frame as frame_mod

    dev = mesh.device
    h, w = P29_H, P29_W
    fp = frame_mod.FrameParams.from_camera(cam, h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(291)
    u = torch.rand((1, h * w, 2), generator=gen, device=dev)
    ug = torch.rand((1, (h // 2) * (w // 2), 2), generator=gen, device=dev)
    kw = dict(height=h, width=w, config=cfg)
    tiled, lt, t_ms = _p29_frame(lambda: tiling.render_frame_tiled(
        scene, fp, cas, mesh=mesh, uniforms=u, **kw), warm=True)
    single, ls, s_ms = _p29_frame(lambda: frame_mod.render_frame_gi(
        scene, fp, cas, uniforms=u, use_cache=True, lod_tau=lod_tau, **kw),
        warm=True)
    _p29_equal(tiled, single, ("color", "depth", "instance_id"),
               "(a) static")
    _check(lt == ls, f"(a) static: launches {lt} against {ls}")
    res["static"] = dict(ms=t_ms, single_ms=s_ms, launches=lt)
    tk = dict(gi_scale=2, uniforms=ug, **kw)
    states = [frame_mod.init_temporal(h, w, 2, device=dev)
              for _ in range(2)]
    for i, c in enumerate((cam, _pan(cam, 0.002))):
        fpi = frame_mod.FrameParams.from_camera(c, h, device=dev)
        (tiled, states[0]), lt, t_ms = _p29_frame(
            lambda: tiling.render_frame_tiled_temporal(
                scene, fpi, cas, states[0], mesh=mesh, **tk))
        (single, states[1]), ls, s_ms = _p29_frame(
            lambda: frame_mod.render_frame_gi_temporal(
                scene, fpi, cas, states[1], use_cache=True, lod_tau=lod_tau,
                **tk))
        _p29_equal(tiled, single, ("color", "depth", "gi_history",
                                   "instance_id"), f"(a) temporal {i}")
        _check(torch.equal(states[0].data, states[1].data),
               f"(a) temporal {i}: the history differs")
        _check(lt == ls, f"(a) temporal {i}: launches {lt} against {ls}")
    res["temporal"] = dict(ms=t_ms, single_ms=s_ms, launches=lt)
    s1, dirty, dlo, dhi = _moved_prop(scene, dev)
    outs = []
    for fn in (tiling.render_frame_tiled_dynamic,
               frame_mod.render_frame_gi_dynamic):
        extra = (dict(mesh=mesh) if fn is tiling.render_frame_tiled_dynamic
                 else dict(use_cache=True, lod_tau=lod_tau))
        outs.append(_p29_frame(lambda: fn(
            s1, fp, cas, st, frame_mod.init_temporal(h, w, 2, device=dev),
            dirty, dlo, dhi, **tk, **extra)))
    (ta, _, tc, _, tn), lt, t_ms = outs[0]
    (sa, _, sc, _, sn), ls, s_ms = outs[1]
    _p29_equal(ta, sa, ("color", "depth", "gi_history", "instance_id"),
               "(a) dynamic")
    for f in ("atlas", "voxel_shade", "brick_irradiance", "brick_map"):
        _check(torch.equal(getattr(tc, f), getattr(sc, f)),
               f"(a) dynamic: {f} differs from the single-card update's")
    _check(int(tn) == int(sn) == 0, f"(a) dynamic: needs_full {int(tn)}, "
           f"{int(sn)}")
    _check(lt == ls, f"(a) dynamic: launches {lt} against {ls}")
    res["dynamic"] = dict(ms=t_ms, single_ms=s_ms, launches=lt)
    print(f"phase 29(a) nccl, 1 rank on {dev}, kitchen {w}x{h}: the tiled "
          "static, temporal (gi_scale 2, 2 frames) and dynamic frames "
          "bit-equal to render_frame_gi / _temporal / _dynamic with the same"
          " launches; tiled against single-card ms (CUDA events, with the "
          "gathers): " + ", ".join(
              f"{k} {v['ms']:.1f} vs {v['single_ms']:.1f} {v['launches']}"
              for k, v in res.items()) + f" [{card}]", flush=True)


def _p29_part_b(mesh, scene, cas, cfg, cam, lod_tau, res,
                card: str) -> None:
    """(b) and (d) on four gloo ranks sharing the card, 1920x1056."""
    import torch

    from vri_tpu_torch.ops import rasterize, sdf_build
    from vri_tpu_torch.parallel import halo, multihost, tiling
    from vri_tpu_torch.parallel import mesh as mesh_mod
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    dev, rank, n = mesh.device, mesh.rank, mesh.size
    ax = mesh.axis()
    w = P29_W
    h = (P29_H // (8 * n)) * 8 * n
    band = h // n
    fp = frame_mod.FrameParams.from_camera(cam, h, device=dev)
    kw = dict(height=h, width=w, config=cfg)

    def band_u(i):
        return torch.rand((1, band * w, 2), generator=mesh_mod.band_generator(
            29, i, dev), device=dev)

    bound = 0.0005
    for smp in (0, 1):
        out, launches, ms = _p29_frame(lambda: tiling.render_frame_tiled(
            scene, fp, cas, mesh=mesh, samples=smp,
            uniforms=band_u(rank) if smp else None, **kw), warm=smp == 0)
        res[f"static{smp}"] = dict(ms=ms, launches=launches)
        _check(launches == {"raster_tiles": 1, "march_rays": 1 + smp},
               f"(b) static, samples {smp}: launches {launches}")
        _check(float(out["stats"][0]) == h * w, "(b) stats: rays")
        if rank == 0:
            uni = torch.cat([band_u(i) for i in range(n)], 1) if smp else None
            single = frame_mod.render_frame_gi(
                scene, fp, cas, samples=smp, uniforms=uni, use_cache=True,
                lod_tau=lod_tau, **kw)
            same = out["instance_id"] == single["instance_id"]
            off = float((~same).float().mean())
            col = float((out["color"] - single["color"]).abs().amax(-1)[
                same].max())
            res[f"static{smp}"].update(ids_differ=off, colour=col)
            _check(off <= bound, f"(b) static, samples {smp}: ids differ on "
                   f"{off:.6f} of the pixels")
            if smp == 0:
                res["ids_1d"] = out["instance_id"].cpu()
    # temporal at gi_scale 2, halo 2 rows, over a small vertical pan
    state = frame_mod.init_temporal(band, w, 2, device=dev)
    gen = mesh_mod.band_generator(292, rank, dev)
    for i, c in enumerate((cam, _pan(cam, 0.002))):
        fpi = frame_mod.FrameParams.from_camera(c, h, device=dev)
        (aovs, state), launches, ms = _p29_frame(
            lambda: tiling.render_frame_tiled_temporal(
                scene, fpi, cas, state, mesh=mesh, gi_scale=2, halo_rows=2,
                uniforms=torch.rand((1, (band // 2) * (w // 2), 2),
                                    generator=gen, device=dev), **kw))
    hist, cov = aovs["gi_history"], aovs["instance_id"] >= 0
    carried = float((hist[cov] >= 2.0).float().mean())
    borders = [float((hist[y][cov[y]] >= 2.0).float().mean())
               for b in range(1, n) for y in (b * band - 1, b * band)]
    res["temporal"] = dict(ms=ms, launches=launches, carried=carried,
                           borders=min(borders))
    _check(carried > 0.5 and min(borders) > 0.5,
           f"(b) temporal: history carried on {carried:.4f} of the pixels, "
           f"{min(borders):.4f} on the worst border row")
    # R and M on the band's own inputs, on the first and the last rank
    if rank in (0, n - 1):
        y0 = rank * band
        world = bake_world(scene)
        prep = rasterize.prepare_sorted(
            world, scene.tri_vertices, scene.num_faces, fp.view_proj,
            height=band, width=w, proj_height=h, y_offset=float(y0),
            cull_sign=frame_mod._cull_sign(scene))
        _hold_raster_tiles(prep, f"rank {rank}'s band lists")
        held = _frame_rays(scene, fp, cas, cfg, band, w,
                           mesh_mod.band_generator(293, rank, dev), lod_tau,
                           f"rank {rank}'s band", y0=y0, proj_height=h)
        res["held"] = dict(lists=int(prep["counts"].sum()),
                           shadow=int(held["shadow"][0][0].shape[1]),
                           gi=int(held["gi"][0][0].shape[1]))
        del prep, held
    # -- (d) the halo functions and the 2 x 2 mesh -------------------------
    occ = cas.brick_map[0] >= 0
    r = occ.shape[0]
    dense = sdf_build.esd_map(occ[None]).reshape(occ.shape)
    sharded = mesh_mod.gather_rows(
        halo.esd_sharded(mesh_mod.shard_rows(occ, mesh), ax, 15), mesh)
    _check(torch.equal(sharded, dense), "(d) esd_sharded differs from "
           "esd_map on cascade 0")
    vol = occ.to(torch.float32)
    for shift in (2, r // n + 3):
        rolled = mesh_mod.gather_rows(halo.scroll_slab(
            mesh_mod.shard_rows(vol, mesh), shift, 0, ax), mesh)
        _check(torch.equal(rolled, torch.roll(vol, -shift, 0)),
               f"(d) scroll_slab by {shift} differs from torch.roll")
    mesh2 = multihost.make_mesh_2d(2, n // 2, backend="gloo", device=dev)
    owner = torch.arange(scene.instance_transform.shape[0], device=dev) % 2
    host = mesh2.coords[0]
    own_i = owner == host
    part = {}
    for name, idx in (("positions", scene.vertex_instance),
                      ("tri_vertices", scene.tri_instance),
                      ("tri_uv", scene.tri_instance),
                      ("tri_face", scene.tri_instance),
                      ("instance_transform", None),
                      ("instance_material", None),
                      ("instance_aabb_lo", None),
                      ("instance_aabb_hi", None)):
        a = getattr(scene, name)
        if a is None or (scene.tri_proto is not None
                         and name in ("positions", "tri_uv", "tri_face")):
            continue
        own = own_i if idx is None else own_i[idx.long()]
        part[name] = torch.where(
            own.reshape(own.shape + (1,) * (a.dim() - 1)), a,
            torch.zeros((), dtype=a.dtype, device=dev))
    merged = multihost.merge_scene_partitions(scene.replace(**part), owner,
                                              mesh2)
    for name in part:
        _check(torch.equal(getattr(merged, name), getattr(scene, name)),
               f"(d) merge_scene_partitions: {name} differs")
    out2, launches2, ms2 = _p29_frame(lambda: multihost.render_frame_tiled_2d(
        merged, fp, cas, mesh=mesh2, samples=0, **kw))
    if rank == 0:
        _check(torch.equal(out2["instance_id"].cpu(), res.pop("ids_1d")),
               "(d) the 2-D frame's ids differ from the 1-D frame's")
    res["mesh2d"] = dict(ms=ms2, launches=launches2, merged=sorted(part))
    print(f"phase 29(b, d) gloo rank {rank}/{n} on {dev}, kitchen "
          f"{w}x{h}: {json.dumps(res)} [{card}]", flush=True)


def _p29_part_c(mesh, scene, cas, st, cfg, cam, lod_tau, want, res,
                card: str) -> None:
    """(c): the tiled dynamic frame on two gloo ranks sharing the card."""
    import torch

    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.parallel import tiling
    from vri_tpu_torch.passes import frame as frame_mod

    dev, rank, n = mesh.device, mesh.rank, mesh.size
    h, w = P29_H, P29_W
    fp = frame_mod.FrameParams.from_camera(cam, h, device=dev)
    s1, dirty, dlo, dhi = _moved_prop(scene, dev)
    rebake = []
    real = sdf_mod.bake_brick_lighting_partial

    def counted(*a, **kw):
        before = _counts()["march_rays"]
        out = real(*a, **kw)
        rebake.append(_counts()["march_rays"] - before)
        return out

    sdf_mod.bake_brick_lighting_partial = counted
    try:
        (aovs, _, cas1, st1, nf), launches, ms = _p29_frame(
            lambda: tiling.render_frame_tiled_dynamic(
                s1, fp, cas, st, frame_mod.init_temporal(h // n, w, 2,
                                                         device=dev),
                dirty, dlo, dhi, mesh=mesh, height=h, width=w, config=cfg,
                gi_scale=2, halo_rows=2, seed=29))
    finally:
        sdf_mod.bake_brick_lighting_partial = real
    _check(int(nf) == 0, f"(c) needs_full {int(nf)}")
    _check(torch.equal(cas1.atlas.cpu(), want["atlas"]),
           "(c) atlas differs from the single-card dynamic frame's")
    _check(torch.equal(cas1.voxel_shade.cpu(), want["shade"]),
           "(c) voxel_shade differs from the single-card dynamic frame's")
    _check(bool(torch.isfinite(aovs["color"]).all()), "(c) colour not finite")
    emitted = int(st1.emit_bricks.sum())
    per = (-(-cfg.update_brick_cap // 256) // n) * 256
    share = max(0, min(per, emitted - rank * per))
    res.update(ms=ms, launches=launches, emitted=emitted, share=share,
               rebake_launches=rebake[0])
    print(f"phase 29(c) gloo rank {rank}/{n} on {dev}, kitchen {w}x{h}, the "
          f"prop moved: atlas and voxel_shade bit-equal to the single-card "
          f"dynamic frame's, needs_full 0; {json.dumps(res)} [{card}]",
          flush=True)


def _phase29_rank(part: str, path: str) -> int:
    """One rank of phase 29 (started by ``_multi_device`` through
    ``mesh.launch``): part ``a`` over nccl, ``b`` (with ``d``) and ``c``
    over gloo on cuda:0.  Prints its lines and writes its result to
    ``<path>.<part><rank>.json``."""
    import torch

    from vri_tpu_torch.parallel import make_mesh
    from vri_tpu_torch.parallel.mesh import close

    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(backend="nccl" if part == "a" else "gloo",
                     device="cuda:0")
    payload = torch.load(path, weights_only=False)
    if part in ("a", "c"):
        payload.update(torch.load(path + ".build", weights_only=False))
    dev = mesh.device
    scene = _move(payload["scene"], dev)
    cas = _move(payload["cascades"], dev)
    st = _move(payload.get("build_state"), dev)
    args = (payload["config"], payload["camera"], payload["lod_tau"])
    torch.cuda.reset_peak_memory_stats()
    res = {}
    if part == "a":
        _p29_part_a(mesh, scene, cas, st, *args, res, card)
    elif part == "b":
        _p29_part_b(mesh, scene, cas, *args, res, card)
    else:
        want = {"atlas": payload["want_atlas"],
                "shade": payload["want_shade"]}
        _p29_part_c(mesh, scene, cas, st, *args, want, res, card)
    res.update(part=part, rank=mesh.rank, world=mesh.size,
               backend=mesh.backend or "none", card=card,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for name in ("jax", "vri_tpu"):
        _check(sys.modules.get(name) is None, f"a rank imported {name}")
    with open(f"{path}.{part}{mesh.rank}.json", "w") as f:
        json.dump(res, f)
    close(mesh)
    return 0


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        import vri_tpu_torch  # noqa: F401
    except ImportError as e:
        # run from a directory without the repository (the script alone)
        _fail(f"the port's package is not importable beside this script "
              f"({e}); run it from the repository's root")
    card = _card_line()
    print(f"card: {card}")

    from vri_tpu_torch import RenderConfig, SDFConfig, _cuda, scenes
    from vri_tpu_torch.config import DebugMode
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
    rargs, rkw, got, r_err = _hold_raster_tiles(prep, "the frame's lists")
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
    print(f"raster_tiles: {int(prep['starts'][-1])} pairs over "
          f"{ls['tiles']} tiles; list lengths mean {ls['mean']:.2f}, p50 "
          f"{ls['p50']:.1f}, p99 {ls['p99']:.1f}, longest {ls['max']}; the "
          f"longest 1% of tiles hold {ls['top1_share']:.4f} of the pairs; "
          f"equal to the plain version; "
          f"{kernels['raster_tiles']['ms']:.3f} ms vs plain "
          f"{kernels['raster_tiles']['plain_ms']:.1f} ms, bound "
          f"{kernels['raster_tiles']['bound_ms']:.4f} ms by "
          f"{kernels['raster_tiles']['bound_by']} [{card}]")

    # -- 30. the sorted prep's kernels on the same inputs -----------------------
    kernels["raster_prep"] = _raster_prep(
        (world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj),
        dict(height=h, width=w, cull_sign=frame_mod._cull_sign(r.scene)),
        card)

    # -- 4. kernel K6 on the frame's chunks -----------------------------------
    cull = frame_mod._cull_sign(r.scene)
    rprep = rasterize.prepare_ranged(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=h, width=w, cull_sign=cull)
    kargs, kkw, got, k_err = _hold_raster_ranged(rprep, prep["counts"],
                                                 "the frame's chunks")
    kernels["raster_ranged"] = dict(
        route="cuda", source="vri_tpu_torch/csrc/raster_ranged.cu",
        replaces="vri_tpu/ops/rasterize.py:400",
        max_abs_err=k_err,
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
    del rprep, kargs, got

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
        bargs, bkw, got, _ = _hold_raster_tiles(
            bprep, f"the binned lists, {label}")
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
    del small_stage, s_scene, shapes, hits, bprep, sprep, bargs, got

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
    ray_sets = {"shadow": gi.shadow_rays(gb.position, gb.normal, r.scene,
                                         cas, sdf_cfg),
                "gi": gi.gi_rays(gb.position, gb.normal, u, cas, sdf_cfg)}
    for label, steps in (("shadow", sdf_cfg.shadow_steps),
                         ("gi", sdf_cfg.gi_steps)):
        margs, mkw, got, err = _hold_march(cas, ray_sets[label], sdf_cfg,
                                           steps, label)
        m_err = max(m_err, err)
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

    # -- 21. march_compact on the frame's GI rays ----------------------------
    _compact(cas, ray_sets["gi"], sdf_cfg, card)
    del r, cas, gb, hit, o, d, u, prep, rargs, margs, got, ray_sets
    torch.cuda.empty_cache()

    # -- 7. main path ------------------------------------------------------------
    r2 = Renderer(RenderConfig(width=w, height=h, sdf=sdf_cfg), device=dev)
    t0 = time.perf_counter()
    r2.load_stage(scenes.kitchen_stress(num_objects=256, tess=4))
    stage_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    prep_before = rasterize.raster_prep.launches
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
    # the build: one emit; bake: one shadow march; per frame one shadow
    # march (all lights in one ray set) and one GI march
    want_launch = _launches(raster_tiles=3, sdf_emit=1,
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
    kernels["sdf_emit"] = dict(launches=launches["sdf_emit"])
    kernels["raster_prep"]["launches"] = (rasterize.raster_prep.launches
                                          - prep_before)
    _check(kernels["raster_prep"]["launches"] == 3,
           f"main path: raster_prep pipelines "
           f"{kernels['raster_prep']['launches']}, expected 3")
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
    del ranged, plain, uni, bvh_frame

    # -- 31. kernel E, the SDF emit, against its plain version ----------------
    kernels["sdf_emit"].update(_sdf_emit(r2, card))
    torch.cuda.empty_cache()

    # -- 18. the production frame: the temporal GI frame at gi_scale 2 --------
    prod_launches, prod_ms = _production(r2, h, w, sdf_cfg, card, dev_ms)
    for name, n in prod_launches.items():
        kernels[name]["launches_production_frame"] = n

    # -- 25. bands: bench.py's gi_band135_ms frame, the tiers on a band ------
    for name, n in _bands(r2, h, w, sdf_cfg, card, prod_ms).items():
        kernels[name]["launches_band_frame"] = n

    # -- 20. the SDF debug views on the main path's renderer ------------------
    _sdf_views(r2, card)

    # -- 23. the bounded update and the animated frame ------------------------
    for name, n in _animated(r2, h, w, card).items():
        kernels[name]["launches_dynamic_frame"] = n
    torch.cuda.empty_cache()

    # -- 29. multi-device: the row-sharded frames over torch.distributed ------
    _multi_device(r2, h, w, card, kernels)
    torch.cuda.empty_cache()

    # -- 24. the clipmap scroll and the app's animated and LOD runs -----------
    _scroll_and_app(r2, h, w, card, out_dir)

    # -- 27. the scene cache and the checks on the main path's stage ----------
    _cache_and_checks(r2, h, w, card, out_dir, stage_s)
    del r2
    torch.cuda.empty_cache()

    # -- 26. the dense SDF build: the tiny preset at 1080p --------------------
    for name, n in _dense(dev, card).items():
        kernels[name]["launches_dense_tiny_frame"] = n

    # -- 19. the reference preset's GI frame: Cornell at 1920x1080 ------------
    _reference_preset(dev, h, w, card)
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
        raster_tiles=1, sdf_emit=1,
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

    # -- 28. the app's --sdf tiny, --cache and --trace --------------------------
    _app_runtime(card, out_dir)

    # -- 10. small-input agreement with the plain versions on the CPU --------------
    small = SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                      max_bricks=16384, base_voxel_size=0.075,
                      truncation_voxels=3.0, max_triangles_per_brick=16,
                      approx_occlusion=True)
    # one set of GI uniforms for both (the CPU and CUDA generators differ)
    u = np.random.default_rng(0).random((1, 64 * 64, 2), dtype=np.float32)
    outs, views = [], []
    for device in (dev, torch.device("cpu")):
        rs = Renderer(RenderConfig(width=64, height=64, sdf=small),
                      device=device)
        rs.load_stage(scenes.cornell_box())
        outs.append(rs.render(gi=True,
                              uniforms=torch.as_tensor(u, device=device)))
        views.append(rs.render(mode=DebugMode.SDF_DISTANCE))
    same = outs[0]["instance_id"] == outs[1]["instance_id"]
    col = np.abs(outs[0]["color"] - outs[1]["color"]).max(-1)[same]
    print(f"small input: card vs CPU plain versions, ids equal on "
          f"{same.mean():.4f} of pixels, colour at most {col.max():.2e} "
          "apart where they are")
    _check(same.mean() >= 0.999 and col.max() <= 2e-3,
           "card and CPU renders of the Cornell box disagree")
    # phase 20's small input: the trilinear loop on the card and the CPU
    hits = [v["depth"] < 1e30 for v in views]
    agree = float((hits[0] == hits[1]).mean())
    both = hits[0] & hits[1]
    rel = float((np.abs(views[0]["depth"] - views[1]["depth"])[both]
                 / views[1]["depth"][both]).max())
    print(f"SDF distance view, Cornell 64^2: card vs CPU hits agree on "
          f"{agree:.5f} of pixels ({hits[0].mean():.4f} hit), depth at "
          f"most {rel:.2e} apart (relative) where both hit")
    _check(agree >= 0.999, "card and CPU SDF views of the Cornell box "
           f"disagree on the hits ({agree:.5f})")

    # -- 11. city: frustum compaction at 1.35M faces ---------------------------
    city = _city(dev, card)

    # -- 22. LOD: the city's masked frame, the masked tiers -----------------
    _lod_city(city, card)
    del city
    torch.cuda.empty_cache()
    kernels["raster_ranged"]["launches_masked_ranged_tier"] = _lod_tiers(
        dev, card)

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
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all "
          f"(host clock) [{card}]")
    print(json.dumps({"kernels": [dict(name=k, **v)
                                  for k, v in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase29"]:
        sys.exit(_phase29_rank(sys.argv[2], sys.argv[3]))
    sys.exit(main())
