"""Attribute reconstruction (counterpart of ``vri_tpu/ops/shading.py``):
from a visibility sample (triangle id + barycentrics) fetch the triangle's
corners, uvs and material from the packed pools and interpolate.  The
JAX package packs a per-triangle table and row-gathers it for TPU layout
reasons (``ops/rowgather.py``); on the GPU the same table is plainly
indexed.  Also the direct-light loop of the direct-only frame and the
debug false-color modes."""

from __future__ import annotations

import dataclasses

import torch

from vri_tpu_torch.config import DebugMode
from vri_tpu_torch.ops.geometry import dot3, norm3
from vri_tpu_torch.ops.intersect import HitRecord


@dataclasses.dataclass
class GBuffer:
    """Per-ray reconstructed surface attributes."""

    position: torch.Tensor   # (N, 3) world hit position
    normal: torch.Tensor     # (N, 3) geometric normal (faces the ray)
    albedo: torch.Tensor     # (N, 3)
    emissive: torch.Tensor   # (N, 3)
    uv: torch.Tensor         # (N, 2)
    depth: torch.Tensor      # (N,) ray t (INF at miss)
    instance: torch.Tensor   # (N,) i32, -1 = miss
    prim: torch.Tensor       # (N,) i32 triangle id within instance, -1 = miss
    material: torch.Tensor   # (N,) i32
    valid: torch.Tensor      # (N,) bool

    def replace(self, **kw) -> "GBuffer":
        return dataclasses.replace(self, **kw)


def sample_texture_bilinear(textures: torch.Tensor, slot: torch.Tensor,
                            uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with wrap addressing (level 0 only)."""
    size = textures.shape[1]
    s = torch.clamp(slot, 0, textures.shape[0] - 1).long()
    u = torch.remainder(uv[:, 0], 1.0) * size - 0.5
    v = (1.0 - torch.remainder(uv[:, 1], 1.0)) * size - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]

    def tap(du, dv):
        ui = torch.clamp(u0.long() + du, 0, size - 1)
        vi = torch.clamp(v0.long() + dv, 0, size - 1)
        return textures[s, vi, ui]

    return ((tap(0, 0) * (1 - fu) + tap(1, 0) * fu) * (1 - fv)
            + (tap(0, 1) * (1 - fu) + tap(1, 1) * fu) * fv)


def resolve_gbuffer(scene, world_verts: torch.Tensor, hit: HitRecord,
                    origins: torch.Tensor, dirs: torch.Tensor,
                    pixel_spread=None) -> GBuffer:
    """Surface attributes of every visibility sample.  ``pixel_spread``
    (2*tan(fov_y/2)/height) enables mip-mapped trilinear texture sampling
    with ray-cone LOD; None samples level 0 bilinearly."""
    tri = torch.clamp(hit.tri, min=0).long()
    valid = hit.tri >= 0

    fverts = world_verts[scene.tri_vertices[tri].long()]   # (N, 3, 3)
    p0, p1, p2 = fverts[:, 0], fverts[:, 1], fverts[:, 2]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    n = n / torch.clamp(norm3(n), min=1e-12)[:, None]
    inst = scene.tri_instance[tri]
    mat = scene.instance_material[inst.long()]
    prim = tri.to(torch.int32) - scene.instance_face_offset[inst.long()]
    ml = mat.long()
    cutoff = (scene.mat_cutoff[ml] if scene.mat_cutoff is not None
              else torch.zeros_like(mat, dtype=torch.float32))
    # shared-prototype layout: per-corner st lives in the prototype pool
    f_uv = (scene.tri_uv[tri] if scene.tri_proto is None
            else scene.tri_uv[scene.tri_proto[tri].long()])  # (N, 3, 2)

    w = 1.0 - hit.u - hit.v
    u, v = hit.u, hit.v
    pos = w[:, None] * p0 + u[:, None] * p1 + v[:, None] * p2
    # two-sided: flip toward the viewer
    n = torch.where(dot3(n, dirs)[:, None] > 0, -n, n)
    uv = (w[:, None] * f_uv[:, 0] + u[:, None] * f_uv[:, 1]
          + v[:, None] * f_uv[:, 2])

    albedo = scene.mat_base_color[ml]
    emissive = scene.mat_emissive[ml]
    tex_slot = scene.mat_texture[ml]
    if scene.textures.shape[0] > 0:
        if pixel_spread is None:
            tex = sample_texture_bilinear(scene.textures, tex_slot, uv)
        else:
            from vri_tpu_torch.ops import texture as texture_mod

            atlas = scene.mip_atlas
            if atlas is None:
                atlas = texture_mod.build_mip_atlas(scene.textures)
            t_hit = norm3(pos - origins)
            cos_inc = torch.abs(dot3(n, dirs))
            density = texture_mod.triangle_texel_density(
                p0, p1, p2, f_uv[:, 0], f_uv[:, 1], f_uv[:, 2],
                scene.textures.shape[1])
            lod = texture_mod.ray_cone_lod(t_hit, cos_inc, density,
                                           pixel_spread)
            tex = texture_mod.sample_trilinear(atlas, tex_slot, uv, lod)
        has_tex = tex_slot >= 0
        if tex.shape[-1] == 4:
            # alpha cutout: a sampled alpha under the material's
            # opacityThreshold punches a hole (treated as a miss)
            cut = has_tex & (cutoff > 0.0) & (tex[:, 3] < cutoff)
            valid = valid & ~cut
            tex = tex[:, :3]
        albedo = torch.where(has_tex[:, None], albedo * tex, albedo)
    neg1 = torch.full_like(inst, -1)
    return GBuffer(
        position=pos,
        normal=n,
        albedo=torch.where(valid[:, None], albedo, 0.0),
        emissive=torch.where(valid[:, None], emissive, 0.0),
        uv=uv,
        depth=hit.t,
        instance=torch.where(valid, inst, neg1),
        prim=torch.where(valid, prim, neg1),
        material=torch.where(valid, mat, neg1),
        valid=valid)


def shade_direct(gb: GBuffer, scene, shadow: torch.Tensor | None = None,
                 ambient: float = 0.08) -> torch.Tensor:
    """Lambertian direct lighting over the (padded) light array.
    ``shadow``: optional (N, L) occlusion factors in [0, 1] (1 = lit)."""
    is_distant = (scene.light_type == 1)[None, :, None]
    lpos = scene.light_position[None, :, :]
    to_l = torch.where(is_distant, lpos, lpos - gb.position[:, None, :])
    dist2 = (to_l * to_l).sum(-1)                                # (N, L)
    wi = to_l / torch.sqrt(torch.clamp(dist2, min=1e-12))[..., None]
    ndotl = torch.clamp((gb.normal[:, None, :] * wi).sum(-1), min=0.0)
    nlights = scene.light_position.shape[0]
    live = (torch.arange(nlights, device=dist2.device)
            < scene.num_lights).to(torch.float32)
    falloff = torch.where(is_distant[..., 0], 1.0,
                          1.0 / torch.clamp(dist2, min=1e-6))
    irr = scene.light_intensity[None, :] * ndotl * falloff * live[None, :]
    if shadow is not None:
        irr = irr * shadow
    radiance = (irr[..., None] * scene.light_color[None, :, :]).sum(1)
    color = gb.albedo * (radiance + ambient) + gb.emissive
    return torch.where(gb.valid[:, None], color, 0.0)


def _id_color(i: torch.Tensor) -> torch.Tensor:
    """Deterministic color cycle for integer ids (uint32 hash)."""
    i = i.to(torch.int64) & 0xFFFFFFFF
    h = (i * 2654435761) & 0xFFFFFF
    r = ((h >> 16) & 0xFF).float() / 255.0
    g = ((h >> 8) & 0xFF).float() / 255.0
    b = (h & 0xFF).float() / 255.0
    return torch.stack([r, g, b], dim=-1)


def debug_color(mode: int, gb: GBuffer, near: float = 0.05,
                far: float = 100.0) -> torch.Tensor:
    valid = gb.valid[:, None]
    if mode == DebugMode.MESH_ID:
        c = _id_color(gb.instance)
    elif mode == DebugMode.PRIM_ID:
        c = _id_color(gb.prim)
    elif mode == DebugMode.BARYCENTRIC:
        c = torch.cat([gb.uv, 1.0 - gb.uv.sum(-1, keepdim=True)], -1)
    elif mode == DebugMode.DEPTH:
        z = torch.clamp((gb.depth - near) / (far - near), 0.0, 1.0)[:, None]
        c = (1.0 - z).expand(-1, 3)
    elif mode == DebugMode.ALBEDO:
        c = gb.albedo
    elif mode == DebugMode.NORMAL:
        c = gb.normal * 0.5 + 0.5
    else:
        raise ValueError(f"unknown debug mode {mode}")
    return torch.where(valid, c, 0.0)
