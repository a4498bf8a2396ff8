"""The static-stage frames (counterpart of ``vri_tpu/passes/frame.py``):
``render_frame_gi`` bakes world vertices -> camera rays -> visibility ->
G-buffer resolve -> SDF-shadowed direct light + one SDF-marched GI
bounce; ``render_frame`` is the direct-only frame: visibility ->
G-buffer -> Lambertian direct light with brute-force hard shadows.

Ported: mode NONE at ``gi_scale=1`` and the G-buffer debug modes;
visibility through every raster tier with the JAX package's dispatch
(frustum compaction for face pools of 2^19 slots or more, the binned tier
for small pools at small frames, the sorted tier otherwise, the ranged
tier on request), through the LBVH (``backend="bvh"``, one
``bvh_traverse`` launch; like the reference's, it does no backface
culling) and through the brute-force tracer.  The dispatch thresholds
were tuned for the TPU; the port keeps them so that it takes the
reference's tier at every shape.  Not ported yet, each raising
``NotImplementedError`` that names its ROADMAP.md item: the SDF debug
modes (item 1), reduced-rate GI and the temporal frame (item 2) and LOD
masks (item 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from vri_tpu_torch.config import DebugMode
from vri_tpu_torch.ops import gi as gi_mod
from vri_tpu_torch.ops import intersect, raygen, shading
from vri_tpu_torch.ops import trace as trace_mod
from vri_tpu_torch.ops import rasterize as raster_mod
from vri_tpu_torch.ops.geometry import norm3
from vri_tpu_torch.registry import SceneBuffers, bake_world

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


def _visibility_raster(scene: SceneBuffers, world_verts, frame: FrameParams,
                       height: int, width: int, variant: str = "auto",
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
    budget (the renderer's overflow response)."""
    if scene.tri_lod is not None and lod_tau > 0:
        raise NotImplementedError(
            "LOD face masks are not ported; see ROADMAP.md 'What comes "
            "next', item 6")
    f = scene.tri_vertices.shape[0]
    if cull_instances is None:
        cull_instances = f >= _CULL_COMPACT_MIN_POOL
    if cull_instances and variant != "ranged":
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
            caps_scale=caps_scale, src_map=face_ids)
        hit.overflow = hit.overflow + (c_over > 0).to(torch.int32)
        return hit
    kw = dict(height=height, width=width, cull_sign=_cull_sign(scene))
    if variant == "ranged":
        fn = raster_mod.rasterize
    elif f <= (1 << 14) and height <= 512:
        fn = raster_mod.rasterize_binned
        kw["caps_scale"] = caps_scale
    else:
        fn = raster_mod.rasterize_sorted
        kw["caps_scale"] = caps_scale
    hit, _ = fn(world_verts, scene.tri_vertices, scene.num_faces,
                frame.view_proj, **kw)
    return hit


def _visibility_brute(scene: SceneBuffers, world_verts, origins, dirs):
    v0, e1, e2 = intersect.gather_triangles(world_verts, scene.tri_vertices)
    return intersect.trace_brute(origins, dirs, v0, e1, e2, scene.num_faces,
                                 cull_sign=_cull_sign(scene))


def _visibility(scene: SceneBuffers, world_verts, frame: FrameParams, o, d,
                height: int, width: int, backend: str, lod_tau: float):
    """Nearest hit of every camera ray through ``backend``: a raster tier
    (``raster``, ``raster2x``, ``raster4x``, ``raster_ranged``), the LBVH
    (``bvh``) or the brute-force tracer (``brute``)."""
    if backend.startswith("raster"):
        variant, caps_scale = _raster_variant(backend)
        return _visibility_raster(scene, world_verts, frame, height, width,
                                  variant=variant, caps_scale=caps_scale,
                                  lod_tau=lod_tau)
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


def render_frame_gi(scene: SceneBuffers, frame: FrameParams,
                    cascades, *, height: int, width: int, config,
                    mode: int = DebugMode.NONE, backend: str = "raster",
                    samples: int = 1, use_cache: bool = False,
                    gi_scale: int = 1, lod_tau: float = 0.75,
                    generator: torch.Generator | None = None,
                    uniforms: torch.Tensor | None = None
                    ) -> Dict[str, torch.Tensor]:
    """Full frame with the SDF-driven lightloop: visibility -> G-buffer
    -> direct + 1-bounce GI (or a G-buffer debug view).  GI samples come
    from ``uniforms`` (samples, H*W, 2) or ``generator``."""
    if mode >= DebugMode.SDF_DISTANCE:
        raise NotImplementedError(
            "SDF debug views need the trilinear march; see ROADMAP.md "
            "'What comes next', item 1")
    if gi_scale != 1:
        raise NotImplementedError(
            "reduced-rate GI (gi_scale > 1) is not ported; see ROADMAP.md "
            "'What comes next', item 2")
    world_verts = bake_world(scene)
    origins, dirs = raygen.camera_rays(frame.inv_view_proj, frame.eye,
                                       height, width)
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    hit = _visibility(scene, world_verts, frame, o, d, height, width,
                      backend, lod_tau)
    gb = shading.resolve_gbuffer(scene, world_verts, hit, o, d,
                                 pixel_spread=frame.pixel_spread)
    # report the world-space ray distance (raster depth is NDC)
    t = norm3(gb.position - frame.eye[None, :])
    gb = gb.replace(depth=torch.where(gb.valid, t, intersect.INF))

    if mode == DebugMode.NONE:
        color = gi_mod.lightloop(gb, scene, cascades, config=config,
                                 samples=samples, generator=generator,
                                 uniforms=uniforms, use_cache=use_cache)
    else:
        color = shading.debug_color(mode, gb)

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
