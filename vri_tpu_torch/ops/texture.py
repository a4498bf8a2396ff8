"""Software texture filtering: mip pyramids + trilinear sampling with
ray-cone LOD (counterpart of ``vri_tpu/ops/texture.py``).

Mip levels are precomputed by 2x2 box reduction and packed into one flat
per-slot atlas, so a trilinear sample is exactly 8 gathers with computed
flat indices regardless of level.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MipAtlas:
    """Mip chain flattened per texture slot: level l occupies
    flat[:, offsets[l] : offsets[l] + sizes[l]**2]."""

    flat: torch.Tensor      # (S, K, C)
    offsets: torch.Tensor   # (L,) i32
    sizes: torch.Tensor     # (L,) i32


def build_mip_atlas(textures: torch.Tensor) -> MipAtlas:
    """(S, T, T, C) -> flat mip atlas (2x2 box-filter chain down to 1x1)."""
    s, t, c = textures.shape[0], textures.shape[1], textures.shape[3]
    levels = [textures]
    cur = textures
    while cur.shape[1] > 1:
        tt = cur.shape[1]
        cur = cur.reshape(s, tt // 2, 2, tt // 2, 2, c).mean(dim=(2, 4))
        levels.append(cur)
    flat = torch.cat(
        [lv.reshape(s, lv.shape[1] * lv.shape[1], c) for lv in levels],
        dim=1)
    sizes = [lv.shape[1] for lv in levels]
    offsets = [0]
    for sz in sizes[:-1]:
        offsets.append(offsets[-1] + sz * sz)
    dev = textures.device
    return MipAtlas(flat=flat,
                    offsets=torch.tensor(offsets, dtype=torch.int32,
                                         device=dev),
                    sizes=torch.tensor(sizes, dtype=torch.int32, device=dev))


def _bilinear_level(atlas: MipAtlas, slot: torch.Tensor, uv: torch.Tensor,
                    level: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at a per-pixel integer level (N,)."""
    size = atlas.sizes[level.long()]                 # (N,)
    off = atlas.offsets[level.long()]
    szf = size.float()
    s = torch.clamp(slot, 0, atlas.flat.shape[0] - 1).long()
    u = torch.remainder(uv[:, 0], 1.0) * szf - 0.5
    v = (1.0 - torch.remainder(uv[:, 1], 1.0)) * szf - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]

    def tap(du, dv):
        ui = torch.minimum(torch.clamp(u0.int() + du, min=0), size - 1)
        vi = torch.minimum(torch.clamp(v0.int() + dv, min=0), size - 1)
        return atlas.flat[s, (off + vi * size + ui).long()]

    return ((tap(0, 0) * (1 - fu) + tap(1, 0) * fu) * (1 - fv)
            + (tap(0, 1) * (1 - fu) + tap(1, 1) * fu) * fv)


def sample_trilinear(atlas: MipAtlas, slot: torch.Tensor, uv: torch.Tensor,
                     lod: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling: 8 gathers per pixel, any per-pixel LOD."""
    n_levels = atlas.sizes.shape[0]
    lod = torch.clamp(lod, 0.0, n_levels - 1.0)
    lo = torch.floor(lod).int()
    hi = torch.clamp(lo + 1, max=n_levels - 1)
    frac = (lod - lo.float())[:, None]
    c0 = _bilinear_level(atlas, slot, uv, lo)
    c1 = _bilinear_level(atlas, slot, uv, hi)
    return c0 * (1.0 - frac) + c1 * frac


def ray_cone_lod(t: torch.Tensor, cos_incidence: torch.Tensor,
                 texel_per_world: torch.Tensor, pixel_spread) -> torch.Tensor:
    """Continuous LOD from the ray-cone footprint (hit distance x pixel
    spread, over the incidence cosine, in texel units)."""
    footprint = t * pixel_spread / torch.clamp(cos_incidence, min=0.25)
    return torch.log2(torch.clamp(footprint * texel_per_world, min=1e-6))


def triangle_texel_density(p0, p1, p2, uv0, uv1, uv2, tex_res: int
                           ) -> torch.Tensor:
    """Texels per world unit for a triangle (sqrt of uv-area/world-area)."""
    e1 = p1 - p0
    e2 = p2 - p0
    cr = torch.linalg.cross(e1, e2, dim=-1)
    world_area = 0.5 * torch.sqrt((cr * cr).sum(-1))
    d1 = uv1 - uv0
    d2 = uv2 - uv0
    uv_area = 0.5 * torch.abs(d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0])
    return torch.sqrt(uv_area / torch.clamp(world_area, min=1e-12)) * tex_res
