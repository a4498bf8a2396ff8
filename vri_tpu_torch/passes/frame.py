"""The static-stage frames (counterpart of ``vri_tpu/passes/frame.py``):
``render_frame_gi`` bakes world vertices -> camera rays -> visibility ->
G-buffer resolve -> SDF-shadowed direct light + one SDF-marched GI
bounce; ``render_frame`` is the direct-only frame: visibility ->
G-buffer -> Lambertian direct light with brute-force hard shadows.

``render_frame_gi_temporal`` is the production GI frame: the indirect
term gathered at GI resolution and accumulated over frames through a
reprojected history; ``render_frame_gi_dynamic`` is its animated form,
which first updates the SDF cascades over the moved geometry and
re-bakes the radiance of the bricks that changed.

Ported: every mode of ``render_frame_gi`` at every ``gi_scale`` (the SDF
debug views march camera rays with the trilinear loop), the temporal and
dynamic frames on the whole frame or on a band of rows (``band=(y0,
full_height)``: the raster projects with the whole frame's height and
rasterizes the band's rows, and the history covers the band);
visibility through every raster tier with the JAX package's dispatch
(frustum compaction for face pools of 2^19 slots or more, the binned
tier for small pools at frames or bands at most 512 rows high, the
sorted tier otherwise, the ranged tier on request) and its LOD face
masks, through the LBVH (``backend="bvh"``, one ``bvh_traverse`` launch;
like the reference's, it does no backface culling) and through the
brute-force tracer.  The dispatch thresholds were tuned for the TPU; the
port keeps them so that it takes the reference's tier at every shape.
The frames sharded over several devices (``parallel/tiling.py``) render
each device's band through the same functions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from vri_tpu_torch.config import DebugMode
from vri_tpu_torch.ops import gi as gi_mod
from vri_tpu_torch.ops import intersect, raygen, sdf_trace, shading
from vri_tpu_torch.ops import lod as lod_mod
from vri_tpu_torch.ops import trace as trace_mod
from vri_tpu_torch.ops import rasterize as raster_mod
from vri_tpu_torch.ops.geometry import norm3
from vri_tpu_torch.registry import SceneBuffers, bake_world
from vri_tpu_torch.runtime import profiler

# face pools at or above this size are frustum-culled and compacted
# before setup (``vri_tpu/passes/frame.py:124``)
_CULL_COMPACT_MIN_POOL = 1 << 19


@dataclasses.dataclass
class FrameParams:
    """Per-frame camera + settings as device tensors."""

    view_proj: torch.Tensor      # (4, 4)
    inv_view_proj: torch.Tensor  # (4, 4)
    eye: torch.Tensor            # (3,)
    near: torch.Tensor           # ()
    far: torch.Tensor            # ()
    #: ray-cone pixel spread (2*tan(fov_y/2)/height); 0 disables mip LOD
    pixel_spread: torch.Tensor | None = None

    @classmethod
    def from_camera(cls, cam, height: int | None = None, *,
                    device) -> "FrameParams":
        spread = (2.0 * math.tan(0.5 * cam.fov_y) / height) if height else 0.0

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)
        return cls(view_proj=f32(cam.view_proj),
                   inv_view_proj=f32(cam.inv_view_proj), eye=f32(cam.eye),
                   near=f32(cam.near), far=f32(cam.far),
                   pixel_spread=f32(spread))


def _raster_variant(backend: str) -> tuple:
    """Raster backend string -> (variant, caps_scale): ``raster2x`` /
    ``raster4x`` widen the list capacities, ``raster_ranged`` names the
    capacity-free kernel."""
    if backend == "raster_ranged":
        return "ranged", 1
    if backend in ("raster2x", "raster4x"):
        return "auto", int(backend[6])
    return "auto", 1


def _cull_sign_instance(scene: SceneBuffers):
    """Per-instance backface-cull signs from USD doubleSided: 0 =
    two-sided, +1 = keep CCW-front, -1 under a mirroring transform; None
    when every instance is two-sided."""
    ds = scene.instance_double_sided
    if ds is None:
        return None
    m = scene.instance_transform
    det = (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
           - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
           + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))
    return torch.where(ds, 0.0, torch.sign(det))


def _cull_sign(scene: SceneBuffers):
    """Per-face cull signs; None when every instance is two-sided."""
    inst = _cull_sign_instance(scene)
    return None if inst is None else inst[scene.tri_instance.long()]


def _instance_frustum_mask(scene: SceneBuffers, view_proj):
    """Conservative per-instance frustum visibility from world AABBs: an
    instance is culled only when all 8 AABB corners lie outside one clip
    plane (homogeneous tests, sign-safe behind the camera; z in [0, w])."""
    lo = scene.instance_aabb_lo
    hi = scene.instance_aabb_hi
    sel = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], dtype=torch.float32,
                       device=lo.device)                         # (8, 3)
    corners = lo[:, None, :] + sel[None, :, :] * (hi - lo)[:, None, :]
    m = view_proj
    # [corner, 1] @ view_proj.T written out as per-column products
    clip = (corners[..., 0:1] * m[:, 0] + corners[..., 1:2] * m[:, 1]
            + corners[..., 2:3] * m[:, 2] + m[:, 3])            # (I, 8, 4)
    x, y, z, w = clip.unbind(-1)
    outside = torch.stack([
        (x + w < 0).all(-1), (w - x < 0).all(-1),
        (y + w < 0).all(-1), (w - y < 0).all(-1),
        (z < 0).all(-1), (w - z < 0).all(-1)], -1)
    return ~outside.any(-1)                                      # (I,)


def _compact_visible_faces(scene: SceneBuffers, view_proj, cap: int):
    """Frustum-cull instances and compact the surviving face ranges into a
    front-packed (cap,) face-id list, so setup and emission pay for live
    faces and not for the padded pool.

    Returns (face_ids, live_count, instance_of_entry, overflow_count);
    overflow > 0 means ``cap`` could not hold every visible face (the
    caller adds it to ``HitRecord.overflow`` and the renderer's ladder
    widens the budget).  Every carry is int32: the scatter writes one
    entry per live instance (their starts are distinct), so the result
    does not depend on the order of the writes."""
    dev = view_proj.device
    i32 = torch.int32
    vis = _instance_frustum_mask(scene, view_proj)
    num_i = scene.instance_transform.shape[0]
    inst_live = torch.arange(num_i, device=dev) < scene.num_instances
    counts = torch.where(vis & inst_live, scene.instance_face_count,
                         0).to(i32)
    cum = torch.cumsum(counts, 0, dtype=i32)
    total = cum[-1]
    j = torch.arange(cap, dtype=i32, device=dev)
    # per-entry instance / segment start / face offset as monotone
    # segment carries (scatter + cumsum); each field ascends over the live
    # instances (packing order)
    starts = cum - counts
    live_i = counts > 0
    at = live_i & (starts < cap)

    def carry(field):
        masked = torch.where(live_i, field, -1)
        prev = torch.cat([torch.full((1,), -1, dtype=i32, device=dev),
                          torch.cummax(masked, 0).values[:-1]])
        diff = torch.where(live_i, field - torch.clamp(prev, min=0), 0)
        buf = torch.zeros((cap,), dtype=i32, device=dev)
        buf[starts[at].long()] = diff[at].to(i32)
        return torch.cumsum(buf, 0, dtype=i32)

    sid = carry(torch.arange(num_i, dtype=i32, device=dev))
    seg_start = carry(starts)
    base_off = carry(scene.instance_face_offset.to(i32))
    face_ids = torch.where(j < total, base_off + (j - seg_start), 0)
    overflow = torch.clamp(total - cap, min=0)
    return face_ids, torch.clamp(total, max=cap), sid, overflow


def _y_off(y0: int):
    """A band's first row -> the raster's ``y_offset`` (None for 0)."""
    return float(y0) if y0 else None


def _visibility_raster(scene: SceneBuffers, world_verts, frame: FrameParams,
                       height: int, width: int, variant: str = "auto",
                       y0=0, proj_height: int | None = None,
                       caps_scale: int = 1, lod_tau: float = 0.75,
                       cull_instances: bool | None = None,
                       compact_cap: int | None = None):
    """Raster dispatch, as ``vri_tpu``'s: with ``cull_instances`` (None =
    pools of 2^19 slots or more) the frustum-visible faces are compacted
    into a budget of ``compact_cap`` (default a quarter of the pool) and
    rasterized by the sorted tier, the compaction overflow added to
    ``HitRecord.overflow``; ``variant="ranged"`` takes the capacity-free
    ranged tier; pools of at most 2^14 faces at frames at most 512 rows
    high take the binned tier; everything else the sorted tier.
    ``caps_scale`` multiplies the list capacities and the compaction
    budget (the renderer's overflow response).  A band renders rows [y0,
    y0 + height) of a ``proj_height``-row frame; the dispatch reads the
    band's own height.

    On a scene packed with LOD chains (``lod_levels`` > 0) each instance
    rasterizes the coarsest level whose deviation projects below
    ``lod_tau`` pixels (``ops/lod.py``): the face mask goes to the tier
    with ``num_faces_total`` as the face count, and the frustum
    compaction is skipped (its face ranges cover base geometry only).
    ``lod_tau=0`` keeps full-rate geometry."""
    num_faces = scene.num_faces
    kw = dict(proj_height=proj_height, y_offset=_y_off(y0))
    if scene.tri_lod is not None and lod_tau > 0:
        focal_px = 1.0 / torch.clamp(frame.pixel_spread, min=1e-8)
        kw["face_mask"], _ = lod_mod.face_mask(scene, frame.eye, focal_px,
                                               lod_tau)
        num_faces = scene.num_faces_total
    f = scene.tri_vertices.shape[0]
    if cull_instances is None:
        cull_instances = f >= _CULL_COMPACT_MIN_POOL
    if cull_instances and variant != "ranged" and "face_mask" not in kw:
        ccap = compact_cap if compact_cap is not None \
            else max(f // 4, 1 << 10)
        ccap = min(raster_mod._round_up(ccap, 128) * caps_scale, f)
        face_ids, live, pair_inst, c_over = _compact_visible_faces(
            scene, frame.view_proj, ccap)
        inst_sign = _cull_sign_instance(scene)
        # cap=4096 and a pair budget from the compacted pool, as the
        # reference's compacted path (frame.py:244-253)
        hit, _ = raster_mod.rasterize_sorted(
            world_verts, scene.tri_vertices[face_ids.long()], live,
            frame.view_proj, height=height, width=width,
            cull_sign=(None if inst_sign is None
                       else inst_sign[pair_inst.long()]),
            cap=4096, pairs_cap=max(raster_mod._round_up(ccap, 1024),
                                    1 << 18),
            caps_scale=caps_scale, src_map=face_ids,
            proj_height=proj_height, y_offset=kw["y_offset"])
        hit.overflow = hit.overflow + (c_over > 0).to(torch.int32)
        return hit
    kw.update(height=height, width=width, cull_sign=_cull_sign(scene))
    if variant == "ranged":
        fn = raster_mod.rasterize
    elif f <= (1 << 14) and height <= 512:
        fn = raster_mod.rasterize_binned
        kw["caps_scale"] = caps_scale
    else:
        fn = raster_mod.rasterize_sorted
        kw["caps_scale"] = caps_scale
    hit, _ = fn(world_verts, scene.tri_vertices, num_faces,
                frame.view_proj, **kw)
    return hit


def _visibility_brute(scene: SceneBuffers, world_verts, origins, dirs):
    v0, e1, e2 = intersect.gather_triangles(world_verts, scene.tri_vertices)
    return intersect.trace_brute(origins, dirs, v0, e1, e2, scene.num_faces,
                                 cull_sign=_cull_sign(scene))


def _visibility(scene: SceneBuffers, world_verts, frame: FrameParams, o, d,
                height: int, width: int, backend: str, lod_tau: float,
                y0=0, proj_height: int | None = None):
    """Nearest hit of every camera ray through ``backend``: a raster tier
    (``raster``, ``raster2x``, ``raster4x``, ``raster_ranged``), the LBVH
    (``bvh``) or the brute-force tracer (``brute``).  A band (``y0``,
    ``proj_height``) reaches the raster; the rays already carry it."""
    if backend.startswith("raster"):
        variant, caps_scale = _raster_variant(backend)
        return _visibility_raster(scene, world_verts, frame, height, width,
                                  variant=variant, caps_scale=caps_scale,
                                  lod_tau=lod_tau, y0=y0,
                                  proj_height=proj_height)
    if backend == "bvh":
        return trace_mod.trace_scene(scene, world_verts, o, d)
    if backend == "brute":
        return _visibility_brute(scene, world_verts, o, d)
    raise ValueError(f"unknown backend {backend!r}")


def render_frame(scene: SceneBuffers, frame: FrameParams, *, height: int,
                 width: int, mode: int = DebugMode.NONE,
                 shadows: bool = True, backend: str = "brute",
                 lod_tau: float = 0.75) -> Dict[str, torch.Tensor]:
    """The direct-only frame: visibility -> G-buffer -> Lambertian direct
    light with brute-force hard shadows (or a G-buffer debug view).  AOVs
    are reshaped to (H, W, ...)."""
    world_verts = bake_world(scene)
    origins, dirs = raygen.camera_rays(frame.inv_view_proj, frame.eye,
                                       height, width)
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    hit = _visibility(scene, world_verts, frame, o, d, height, width,
                      backend, lod_tau)
    gb = shading.resolve_gbuffer(scene, world_verts, hit, o, d,
                                 pixel_spread=frame.pixel_spread)
    if backend.startswith("raster"):
        # raster depth is NDC; report the world-space ray distance
        t = norm3(gb.position - frame.eye[None, :])
        gb = gb.replace(depth=torch.where(gb.valid, t, intersect.INF))

    if mode == DebugMode.NONE:
        shadow = _shadow_factors(scene, world_verts, gb) if shadows else None
        color = shading.shade_direct(gb, scene, shadow=shadow)
    else:
        color = shading.debug_color(mode, gb)
    out = {
        "color": color.reshape(height, width, color.shape[-1]),
        "depth": gb.depth.reshape(height, width),
        "instance_id": gb.instance.reshape(height, width),
        "prim_id": gb.prim.reshape(height, width),
        "normal": gb.normal.reshape(height, width, 3),
        "albedo": gb.albedo.reshape(height, width, 3),
    }
    if hit.overflow is not None:
        out["raster_overflow_tiles"] = hit.overflow
    return out


def _shadow_factors(scene: SceneBuffers, world_verts,
                    gb: shading.GBuffer) -> torch.Tensor:
    """Hard shadow test per (pixel, light) with brute-force occlusion, as
    the reference's direct-only frame does: (N, L), 1 = lit."""
    v0, e1, e2 = intersect.gather_triangles(world_verts, scene.tri_vertices)
    n, L = gb.position.shape[0], scene.light_position.shape[0]
    is_distant = (scene.light_type == 1)[None, :, None]
    lpos = scene.light_position[None, :, :]
    to_l = torch.where(is_distant, lpos, lpos - gb.position[:, None, :])
    dist = norm3(to_l)
    dist = torch.where(is_distant[..., 0], 1e4, dist)
    wi = to_l / torch.clamp(norm3(to_l), min=1e-12)[..., None]
    o = (gb.position[:, None, :] + gb.normal[:, None, :] * 1e-3).expand(
        n, L, 3)
    blocked = intersect.any_hit_brute(
        o.reshape(n * L, 3), wi.reshape(n * L, 3), v0, e1, e2,
        scene.num_faces, t_max=dist.reshape(n * L) - 2e-3)
    return 1.0 - blocked.reshape(n, L).to(torch.float32)


class _IndirectView:
    """Position and normal of a pixel subset: all that
    ``gi.indirect_radiance`` and the shadow march read of a G-buffer."""

    __slots__ = ("position", "normal")

    def __init__(self, position, normal):
        self.position = position
        self.normal = normal


def _subsample_pn(gb, height: int, width: int, s: int):
    """Position, normal and valid of every ``s``-th pixel of every
    ``s``-th row (the GI-resolution view), row-major."""
    dev = gb.position.device
    ys = torch.arange(0, height, s, device=dev)
    xs = torch.arange(0, width, s, device=dev)
    idx = (ys[:, None] * width + xs[None, :]).reshape(-1)
    return _IndirectView(gb.position[idx], gb.normal[idx]), gb.valid[idx]


def _upsample(a, hs: int, ws: int, s: int):
    """Nearest upsampling of a row-major (hs * ws, ...) field by ``s``."""
    rest = tuple(a.shape[1:])
    a = a.reshape((hs, ws) + rest)
    a = a.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)
    return a.reshape((hs * s * ws * s,) + rest)


def _direct_lighting(gb, scene, cascades, config, height: int, width: int):
    """Direct light with the shadow march at ``config.shadow_scale``: the
    march runs on the strided pixel subset and its visibility factors
    are upsampled; N.L, falloff and colours stay full-rate (span
    ``direct``)."""
    ss = config.shadow_scale
    with profiler.span("direct"):
        if ss <= 1:
            return gi_mod.direct_radiance(gb.position, gb.normal, scene,
                                          cascades, config)
        sub, _ = _subsample_pn(gb, height, width, ss)
        occ = gi_mod.shadow_occlusion(sub.position, sub.normal, scene,
                                      cascades, config)
        occ = _upsample(occ, height // ss, width // ss, ss)
        return gi_mod.direct_radiance_analytic(gb.position, gb.normal,
                                               scene, occ)


def _gbuffer(scene: SceneBuffers, frame: FrameParams, height: int,
             width: int, backend: str, lod_tau: float, y0=0,
             proj_height: int | None = None):
    """Camera rays -> visibility through ``backend`` -> G-buffer with
    world ray distances as depth, over rows [y0, y0 + height) of a
    ``proj_height``-row frame (the whole frame by default).  Spans
    ``visibility`` (up to the hit record) and ``gbuffer``."""
    with profiler.span("visibility"):
        world_verts = bake_world(scene)
        origins, dirs = raygen.camera_rays(frame.inv_view_proj, frame.eye,
                                           height, width, y0=y0,
                                           proj_height=proj_height)
        o = origins.reshape(-1, 3)
        d = dirs.reshape(-1, 3)
        hit = _visibility(scene, world_verts, frame, o, d, height, width,
                          backend, lod_tau, y0=y0, proj_height=proj_height)
    with profiler.span("gbuffer"):
        gb = shading.resolve_gbuffer(scene, world_verts, hit, o, d,
                                     pixel_spread=frame.pixel_spread)
        # report the world-space ray distance (raster depth is NDC)
        t = norm3(gb.position - frame.eye[None, :])
        gb = gb.replace(depth=torch.where(gb.valid, t, intersect.INF))
    return hit, gb


def render_frame_gi(scene: SceneBuffers, frame: FrameParams,
                    cascades, *, height: int, width: int, config,
                    mode: int = DebugMode.NONE, backend: str = "raster",
                    samples: int = 1, use_cache: bool = False,
                    gi_scale: int = 1, lod_tau: float = 0.75,
                    generator: torch.Generator | None = None,
                    uniforms: torch.Tensor | None = None
                    ) -> Dict[str, torch.Tensor]:
    """Full frame with the SDF-driven lightloop: visibility -> G-buffer
    -> direct + 1-bounce GI (or a G-buffer debug view); or, for the SDF
    debug modes, camera rays marched through the cascades (trilinear
    loop) to ``frame.far``, returning only ``color`` and ``depth``.  At
    ``gi_scale > 1`` the indirect term is gathered on every
    ``gi_scale``-th pixel and row and upsampled; the direct term stays
    full-rate, its shadows marched at ``config.shadow_scale``.  GI
    samples come from ``uniforms`` (samples, GI pixels, 2) or
    ``generator``."""
    if mode >= DebugMode.SDF_DISTANCE:
        origins, dirs = raygen.camera_rays(frame.inv_view_proj, frame.eye,
                                           height, width)
        rec = sdf_trace.march(cascades, origins.reshape(-1, 3),
                              dirs.reshape(-1, 3), t_max=frame.far,
                              config=config)
        color = gi_mod.sdf_debug_color(mode, rec, cascades, config)
        return {"color": color.reshape(height, width, 3),
                "depth": rec.t.reshape(height, width)}

    hit, gb = _gbuffer(scene, frame, height, width, backend, lod_tau)
    if mode != DebugMode.NONE:
        color = shading.debug_color(mode, gb)
    elif gi_scale <= 1 or samples == 0:
        color = gi_mod.lightloop(gb, scene, cascades, config=config,
                                 samples=samples, generator=generator,
                                 uniforms=uniforms, use_cache=use_cache)
    else:
        direct = _direct_lighting(gb, scene, cascades, config, height, width)
        sub, _ = _subsample_pn(gb, height, width, gi_scale)
        ind = gi_mod.indirect_radiance(sub, scene, cascades, config=config,
                                       samples=samples, generator=generator,
                                       uniforms=uniforms,
                                       use_cache=use_cache)
        ind = _upsample(ind, height // gi_scale, width // gi_scale, gi_scale)
        color = gb.emissive + gb.albedo * (direct + ind)
        color = torch.where(gb.valid[:, None], color, 0.0)

    out = {
        "color": color.reshape(height, width, color.shape[-1]),
        "depth": gb.depth.reshape(height, width),
        "instance_id": gb.instance.reshape(height, width),
        "normal": gb.normal.reshape(height, width, 3),
        "albedo": gb.albedo.reshape(height, width, 3),
    }
    if hit.overflow is not None:
        out["raster_overflow_tiles"] = hit.overflow
    return out


def accumulate(prev_color: torch.Tensor, prev_count: torch.Tensor,
               new_color: torch.Tensor):
    """Progressive accumulation (running mean)."""
    count = prev_count + 1.0
    color = prev_color + (new_color - prev_color) / count
    return color, count


# ---------------------------------------------------------------------------
# Temporal reprojection (progressive GI under camera motion)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TemporalState:
    """History of the indirect term (direct light and albedo re-shade
    every frame): one (N, 8) row per GI pixel, [indirect(3) | depth |
    normal(3) | count], with the camera of the frame that wrote it."""

    data: torch.Tensor       # (N, 8) f32
    view_proj: torch.Tensor  # (4, 4) of the writing frame
    eye: torch.Tensor        # (3,)


def init_temporal(height: int, width: int, gi_scale: int = 1, *,
                  device="cuda") -> TemporalState:
    """Empty history for :func:`render_frame_gi_temporal` at the frame's
    ``gi_scale``: the history lives at GI resolution."""
    n = (height // gi_scale) * (width // gi_scale)
    return TemporalState(
        data=torch.zeros((n, 8), dtype=torch.float32, device=device),
        view_proj=torch.eye(4, dtype=torch.float32, device=device),
        eye=torch.zeros((3,), dtype=torch.float32, device=device))


def pack_temporal(indirect, depth, normal, count, view_proj, eye
                  ) -> TemporalState:
    data = torch.cat([indirect, depth[:, None], normal, count[:, None]],
                     dim=1)
    return TemporalState(data=data, view_proj=view_proj, eye=eye)


def _reproject(state: TemporalState, position, normal, valid, height: int,
               width: int, depth_tol: float = 0.02, y0: int = 0,
               proj_height: int | None = None, query_y0=0, halo: int = 0):
    """Bilinear history fetch at each point reprojected through the
    previous frame's camera.  A tap counts only inside the screen, at a
    depth within the (velocity-widened) tolerance, with a normal within
    60 degrees and a history of its own; invalid taps drop out of the
    weights and a pixel whose taps weigh 0.05 or less restarts (count
    0).  The history covers rows [y0, y0 + height) of a ``proj_height``
    frame; the queries are rows [query_y0, ...) of the history.  With
    ``halo`` the history carries ``halo`` more rows above and below those
    (a sharded frame's ghost rows from the neighbouring bands): the taps
    are found in the band's coordinates and read ``halo`` rows down, so
    the weights round as without them.  (The JAX sharded frame instead
    moves ``y0`` up by the halo and grows ``height``, which rounds the
    bilinear weights an ulp apart from the single-device frame's.)

    As the JAX function: the two taps of a row come from one gathered
    pair of history rows, [data[i] | data[i + 1]] (the last row pairs with
    the first), at the window column xw = clip(x0, 0, W - 2); a tap at
    column x reads slot x - xw and counts only in slot 0 or 1.  The four
    taps add up in the order (row 0: x0, x0 + 1; row 1: x0, x0 + 1)."""
    vp = state.view_proj
    # [position, 1] @ view_proj.T written out as per-column products
    clip = (position[:, 0:1] * vp[:, 0] + position[:, 1:2] * vp[:, 1]
            + position[:, 2:3] * vp[:, 2] + vp[:, 3])
    w = clip[:, 3]
    ndc = clip[:, :3] / torch.clamp(w, min=1e-6)[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * width - 0.5
    py = (0.5 - ndc[:, 1] * 0.5) * (proj_height or height) - y0 - 0.5
    x0 = torch.floor(px).to(torch.int32)
    y0i = torch.floor(py).to(torch.int32)
    fx = (px - x0.float())[:, None]
    fy = (py - y0i.float())[:, None]

    # velocity: the reprojected position against the query's own pixel
    n = position.shape[0]
    ar = torch.arange(n, dtype=torch.float32, device=position.device)
    own_x = ar % width
    own_y = torch.floor(ar / width) + query_y0
    vel = torch.sqrt((px - own_x) ** 2 + (py - own_y) ** 2)
    tol = depth_tol * (1.0 + 0.25 * torch.clamp(vel, max=8.0))

    t_prev = norm3(position - state.eye[None, :])
    paired = torch.cat([state.data, torch.roll(state.data, -1, dims=0)],
                       dim=1)
    xw = torch.clamp(x0, 0, max(width - 2, 0))

    rows = height + 2 * halo

    def row_taps(dy):
        yi = y0i + dy + halo
        y_in = (w > 1e-6) & (yi >= 0) & (yi < rows)
        h = paired[(torch.clamp(yi, 0, rows - 1) * width + xw).long()]
        out = []
        for dx in (0, 1):
            si = x0 + dx - xw                      # window slot, 0 or 1
            xi = x0 + dx
            inside = y_in & (xi >= 0) & (xi < width) & (si >= 0) & (si <= 1)
            f = torch.where((si == 1)[:, None], h[:, 8:], h[:, :8])
            depth_ok = torch.abs(f[:, 3] - t_prev) <= tol * t_prev + 1e-3
            normal_ok = (f[:, 4] * normal[:, 0] + f[:, 5] * normal[:, 1]
                         + f[:, 6] * normal[:, 2]) > 0.5
            ok = inside & depth_ok & normal_ok & (f[:, 7] > 0.0)
            wgt = ((fy if dy else 1.0 - fy)
                   * (fx if dx else 1.0 - fx))[:, 0]
            out.append((f[:, 0:3], f[:, 7], torch.where(ok, wgt, 0.0)))
        return out

    taps = row_taps(0) + row_taps(1)
    wsum = sum(t[2] for t in taps)
    scale = 1.0 / torch.clamp(wsum, min=1e-6)
    h_ind = sum(t[0] * t[2][:, None] for t in taps) * scale[:, None]
    h_count = sum(t[1] * t[2] for t in taps) * scale
    ok = valid & (wsum > 0.05)
    return (torch.where(ok[:, None], h_ind, 0.0),
            torch.where(ok, h_count, 0.0))


def gi_band_inputs(scene: SceneBuffers, frame: FrameParams, cascades, *,
                   height: int, width: int, config, backend: str = "raster",
                   samples: int = 1, use_cache: bool = False,
                   gi_scale: int = 1, lod_tau: float = 0.75, y0=0,
                   proj_height: int | None = None,
                   generator: torch.Generator | None = None,
                   uniforms: torch.Tensor | None = None):
    """The temporal frame's body: raygen -> visibility -> G-buffer ->
    full-rate direct -> GI-resolution indirect sample.  Returns (hit, gb,
    direct, sub, valid_s, ind), ``sub`` / ``valid_s`` the GI-resolution
    view (the G-buffer itself at ``gi_scale`` 1).

    As the JAX function dispatches: a ``raster*`` backend goes to the
    raster, every other backend (``"bvh"`` included) to the brute-force
    tracer.  ``y0`` / ``proj_height`` render the band of rows [y0, y0 +
    height) of a ``proj_height``-row frame (the whole frame by
    default).  Spans ``visibility``, ``gbuffer``, ``direct`` and
    ``indirect``."""
    hit, gb = _gbuffer(scene, frame, height, width,
                       backend if backend.startswith("raster") else "brute",
                       lod_tau, y0=y0, proj_height=proj_height)
    direct = _direct_lighting(gb, scene, cascades, config, height, width)
    with profiler.span("indirect"):
        if gi_scale > 1:
            if height % gi_scale or width % gi_scale:
                raise ValueError(
                    f"gi_scale {gi_scale} must divide the frame "
                    f"({height}x{width}; use an even band height)")
            sub, valid_s = _subsample_pn(gb, height, width, gi_scale)
        else:
            sub, valid_s = gb, gb.valid
        ind = gi_mod.indirect_radiance(sub, scene, cascades, config=config,
                                       samples=samples, generator=generator,
                                       uniforms=uniforms,
                                       use_cache=use_cache)
    return hit, gb, direct, sub, valid_s, ind


def temporal_blend(ind, h_ind, h_count, history_cap: float):
    """Running mean over at most ``history_cap`` frames of history."""
    count = torch.clamp(h_count, max=history_cap) + 1.0
    return h_ind + (ind - h_ind) / count[:, None], count


@profiler.frame_root
def render_frame_gi_temporal(scene: SceneBuffers, frame: FrameParams,
                             cascades, state: TemporalState, *,
                             height: int, width: int, config,
                             backend: str = "raster", samples: int = 1,
                             use_cache: bool = False, gi_scale: int = 1,
                             history_cap: float = 16.0, band=None,
                             lod_tau: float = 0.75,
                             generator: torch.Generator | None = None,
                             uniforms: torch.Tensor | None = None):
    """GI frame with the indirect term accumulated over frames through a
    reprojected history (up to ``history_cap`` frames a pixel, validated
    by depth and normal).  Returns (aovs, new_state); ``gi_history`` is
    each pixel's frame count.  At ``gi_scale > 1`` the history,
    reprojection, validation and blend all run at GI resolution and the
    blended term upsamples once.  GI samples come from ``uniforms``
    (samples, GI pixels, 2) or ``generator``.

    ``band=(y0, full_height)`` renders rows [y0, y0 + height) of a
    ``full_height``-row frame, the per-device body of the row-sharded
    frame: the history covers the band only, and a pixel whose history
    reprojects outside the band restarts.

    Each call is one ``frame`` root span over the stages of
    :func:`gi_band_inputs` and ``history`` (reprojection, blend, pack,
    upsample and the final compose)."""
    y0, proj_h = band if band is not None else (0, None)
    hit, gb, direct, sub, valid_s, ind = gi_band_inputs(
        scene, frame, cascades, height=height, width=width, config=config,
        backend=backend, samples=samples, use_cache=use_cache,
        gi_scale=gi_scale, lod_tau=lod_tau, y0=y0, proj_height=proj_h,
        generator=generator, uniforms=uniforms)
    with profiler.span("history"):
        if gi_scale <= 1:
            h_ind, h_count = _reproject(state, gb.position, gb.normal,
                                        gb.valid, height, width, y0=y0,
                                        proj_height=proj_h)
            ind_blend, count = temporal_blend(ind, h_ind, h_count,
                                              history_cap)
            ind_state, t_s, n_s = ind_blend, gb.depth, gb.normal
            count_full = count
        else:
            hs, ws = height // gi_scale, width // gi_scale
            h_ind, h_count = _reproject(
                state, sub.position, sub.normal, valid_s, hs, ws,
                y0=y0 // gi_scale,
                proj_height=None if proj_h is None else proj_h // gi_scale)
            ind_state, count = temporal_blend(ind, h_ind, h_count,
                                              history_cap)
            t_s = norm3(sub.position - frame.eye[None, :])
            n_s = sub.normal
            ind_blend = _upsample(ind_state, hs, ws, gi_scale)
            count_full = _upsample(count, hs, ws, gi_scale)
        new_state = pack_temporal(ind_state, t_s, n_s, count,
                                  frame.view_proj, frame.eye)

        color = gb.emissive + gb.albedo * (direct + ind_blend)
        color = torch.where(gb.valid[:, None], color, 0.0)
        aovs = {
            "color": color.reshape(height, width, 3),
            "depth": gb.depth.reshape(height, width),
            "instance_id": gb.instance.reshape(height, width),
            "normal": gb.normal.reshape(height, width, 3),
            "albedo": gb.albedo.reshape(height, width, 3),
            "gi_history": count_full.reshape(height, width),
        }
        if hit.overflow is not None:
            aovs["raster_overflow_tiles"] = hit.overflow
        return aovs, new_state


@profiler.frame_root
def render_frame_gi_dynamic(scene: SceneBuffers, frame: FrameParams,
                            cascades, build_state, state: TemporalState,
                            dirty_tri, dirty_lo, dirty_hi, *, height: int,
                            width: int, config, backend: str = "raster",
                            samples: int = 1, use_cache: bool = False,
                            gi_scale: int = 1, history_cap: float = 16.0,
                            band=None, lod_tau: float = 0.75,
                            rebake: bool = True,
                            generator: torch.Generator | None = None,
                            uniforms: torch.Tensor | None = None,
                            shard_proxy: int | None = None):
    """One animated production frame: the bounded SDF cascade update over
    the moved geometry, the radiance re-bake of the bricks it re-emitted
    and of those whose shadow segment crosses a dirty box, then the
    temporal GI frame.

    ``scene`` already carries this frame's transforms; ``dirty_tri`` (F,)
    marks the moved triangles and ``dirty_lo/hi`` (D, 3) cover their old
    and new world AABBs (unused rows +BIG/-BIG).  GI samples come from
    ``uniforms`` or ``generator`` and ``band`` renders a band of rows, as
    in :func:`render_frame_gi_temporal`.  ``rebake=False`` skips the
    radiance re-bake (valid when no lighting-relevant geometry moved; the
    update itself refreshes the re-emitted bricks' payloads).  Returns
    (aovs, new_temporal, cascades, build_state, needs_full); a non-zero
    ``needs_full`` means a capacity was exceeded (a re-bake set past
    ``bake_brick_cap`` included) and the caller must rebuild the
    cascades.

    ``shard_proxy=n`` is the single-device measurement proxy of the n-way
    sharded animated frame (``parallel/tiling.render_frame_tiled_dynamic``):
    the update emits and the re-bake marches one device's share (share 0
    of n) and only that share reaches the atlas, so it times one device's
    body on one device.  It is not a production mode.

    Each call is one ``frame`` root span: ``sdf_update``, ``rebake``,
    then the temporal frame's stages."""
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build

    ax = (None, shard_proxy) if shard_proxy else None
    with profiler.span("sdf_update"):
        world_verts = bake_world(scene)
        mat = scene.instance_material[scene.tri_instance.long()].long()
        cascades, build_state, needs_full = sdf_build.update_cascades(
            cascades, build_state, world_verts, scene.tri_vertices,
            scene.num_faces, dirty_tri, dirty_lo, dirty_hi,
            tri_albedo=scene.mat_base_color[mat],
            tri_emissive=scene.mat_emissive[mat], config=config,
            axis_name=ax)
    if rebake:
        with profiler.span("rebake"):
            light_dirty = sdf_mod.lighting_dirty_bricks(
                cascades, scene, dirty_lo, dirty_hi, config=config)
            cascades, bake_drop = sdf_mod.bake_brick_lighting_partial(
                cascades, scene, build_state.emit_bricks | light_dirty,
                build_state.alive, config=config,
                cap=config.bake_brick_cap, axis_name=ax)
            needs_full = needs_full + bake_drop
    profiler.count("sdf_update.needs_full", needs_full)
    aovs, new_state = render_frame_gi_temporal(
        scene, frame, cascades, state, height=height, width=width,
        config=config, backend=backend, samples=samples,
        use_cache=use_cache, gi_scale=gi_scale, history_cap=history_cap,
        band=band, lod_tau=lod_tau, generator=generator, uniforms=uniforms)
    return aovs, new_state, cascades, build_state, needs_full


def render_to_numpy(scene: SceneBuffers, camera, config,
                    mode: int = DebugMode.NONE, shadows: bool = True,
                    backend: str = "brute", *, device="cuda"
                    ) -> Dict[str, np.ndarray]:
    """The direct-only frame of ``camera`` at ``config``'s size as numpy
    AOVs; ``scene`` lives on ``device`` (the card unless the caller asks
    for the CPU)."""
    aovs = render_frame(scene, FrameParams.from_camera(camera,
                                                       device=device),
                        height=config.height, width=config.width, mode=mode,
                        shadows=shadows, backend=backend)
    return {k: v.cpu().numpy() for k, v in aovs.items()}
