"""Sparse-brick SDF cascades (counterpart of ``vri_tpu/ops/sdf.py``):
the cascade data model, the march-kernel tables and the radiance bake.

The cell-binned builder that fills these tensors is
``ops/sdf_build.py``; the dense builder of the JAX package
(``sdf.build_cascades``) is not ported yet (ROADMAP.md, "What comes
next", item 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from vri_tpu.config import SDFConfig

BIG = 3.0e38


@dataclasses.dataclass
class SDFCascades:
    """Device-resident cascade set (field meanings as
    ``vri_tpu.ops.sdf.SDFCascades``): ``brick_map[n, z, y, x]`` holds the
    atlas brick of a voxel or ``-esd`` (Chebyshev empty-space distance)
    for an empty one; ``atlas[b]`` is the brick's (B,B,B) normalized
    truncated distance; ``march_*`` are the march kernel's tables."""

    center: torch.Tensor       # (N, 3) cascade centers (world)
    voxel_size: torch.Tensor   # (N,)
    brick_map: torch.Tensor    # (N, R, R, R) i32
    atlas: torch.Tensor        # (max_bricks, B, B, B) u8 or f32
    brick_voxel: torch.Tensor  # (max_bricks,) i32 flattened (n*R^3 + voxel)
    brick_albedo: torch.Tensor    # (max_bricks, 3) f32
    brick_emissive: torch.Tensor  # (max_bricks, 3) f32
    brick_normal: torch.Tensor    # (max_bricks, 3) f32
    brick_irradiance: torch.Tensor  # (max_bricks, 3) f32 (baked)
    brick_light_vis: torch.Tensor   # (max_bricks, L) f32 (baked)
    num_bricks: torch.Tensor   # () i32
    overflow: torch.Tensor     # () i32 — occupied voxels dropped (capacity)
    march_coarse: torch.Tensor  # (N*4, 128) i32 — 4096 u4 cells per cascade
    march_fine0: torch.Tensor   # (N*32, 128) i32 — occupancy bits 0..31
    march_fine1: torch.Tensor   # (N*32, 128) i32 — occupancy bits 32..63
    #: () i32 — near candidates beyond max_triangles_per_brick dropped
    near_drop: torch.Tensor | None = None
    #: (N*R^3, 16) bf16 voxel-indexed shading payload
    #: [albedo | normal | irradiance | emissive | pad]; None until baked
    voxel_shade: torch.Tensor | None = None

    def replace(self, **kw) -> "SDFCascades":
        return dataclasses.replace(self, **kw)


def cascade_origin(center: torch.Tensor, voxel_size: torch.Tensor,
                   resolution: int) -> torch.Tensor:
    """World-space position of the (0,0,0) voxel corner."""
    return center - 0.5 * resolution * voxel_size[..., None]


def default_centers(config: SDFConfig, focus, *, device) -> torch.Tensor:
    """All cascades centered on ``focus``, snapped to each cascade's cell
    grid (s = R/16 voxels) so recentering never shimmers."""
    focus = torch.as_tensor(focus, dtype=torch.float32, device=device)
    s = max(config.cascade_resolution // 16, 1)
    vs = torch.tensor([config.voxel_size(i) * s
                       for i in range(config.num_cascades)],
                      dtype=torch.float32, device=device)
    return torch.round(focus[None, :] / vs[:, None]) * vs[:, None]


def _min_pool_iter(d: torch.Tensor, iters: int) -> torch.Tensor:
    """Iterated 3x3x3 min-pool relaxation d = min(d, pool(d) + 1) over the
    last three axes (out-of-range neighbours never win)."""
    for _ in range(iters):
        pooled = -F.max_pool3d(-d, kernel_size=3, stride=1, padding=1)
        d = torch.minimum(d, pooled + 1.0)
    return d


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> the int32 with those bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def build_march_tables(brick_map: torch.Tensor, atlas: torch.Tensor, *,
                       config: SDFConfig, hit_texels: float = 1.5):
    """Pack the march-kernel tables: per cascade a 16^3 coarse grid of 4-bit
    Chebyshev distances in cell units (8 cells per i32 word) and per-cell
    surface-voxel bit words (bit = ((vz%s)*s + vy%s)*s + vx%s)."""
    n = config.num_cascades
    r = config.cascade_resolution
    bsz = config.brick_size
    dev = brick_map.device
    if r % 16 != 0 or r // 16 not in (1, 2, 4):
        z = lambda rows: torch.zeros((rows, 128), dtype=torch.int32,
                                     device=dev)
        return z(n * 4), z(n * 32), z(n * 32)
    s = r // 16
    s3 = s ** 3

    occ = brick_map >= 0                              # (N, R, R, R) z,y,x
    amin = atlas.reshape(atlas.shape[0], -1).min(dim=1).values
    if amin.dtype == torch.uint8:
        amin = amin.float() * (1.0 / 255.0)
    thresh = hit_texels / (config.truncation_voxels * bsz)
    surf = occ & (amin[torch.clamp(brick_map, min=0).long()] < thresh)

    cz = surf.reshape(n, 16, s, 16, s, 16, s)         # (cz,bz,cy,by,cx,bx)
    cell_occ = cz.any(dim=6).any(dim=4).any(dim=2)    # (N, 16, 16, 16)

    cap = 15
    d = torch.where(cell_occ, 0.0, float(cap))
    d = _min_pool_iter(d, cap - 1)
    cdist = torch.clamp(d, 0, cap).to(torch.int64).reshape(n, 4096)
    cd8 = cdist.reshape(n, 512, 8)
    shifts = 4 * torch.arange(8, device=dev, dtype=torch.int64)
    words = (cd8 << shifts).sum(-1)
    coarse = _wrap_i32(words).reshape(n * 4, 128)

    bits = cz.permute(0, 1, 3, 5, 2, 4, 6).reshape(n, 4096, s3).to(
        torch.int64)
    lo = min(s3, 32)
    w0 = (bits[..., :lo] << torch.arange(lo, device=dev)).sum(-1)
    if s3 > 32:
        w1 = (bits[..., 32:] << torch.arange(s3 - 32, device=dev)).sum(-1)
    else:
        w1 = torch.zeros_like(w0)
    return (coarse, _wrap_i32(w0).reshape(n * 32, 128),
            _wrap_i32(w1).reshape(n * 32, 128))


def brick_positions(cascades: SDFCascades, config: SDFConfig):
    """World-space voxel centers + cascade index per brick slot."""
    r = config.cascade_resolution
    bv = cascades.brick_voxel.long()
    n = bv // (r * r * r)
    rem = bv % (r * r * r)
    z = rem // (r * r)
    y = (rem // r) % r
    x = rem % r
    vs = cascades.voxel_size[n]
    org = cascades.center[n] - 0.5 * r * vs[:, None]
    centers = org + (torch.stack([x, y, z], -1).float() + 0.5) * vs[:, None]
    return centers, n


def bake_brick_lighting(cascades: SDFCascades, scene, *, config: SDFConfig,
                        shadow_steps: int = 32,
                        alive: torch.Tensor | None = None) -> SDFCascades:
    """Bake SDF-shadowed direct irradiance at every brick's surface point
    (the radiance cache the GI bounce reads), and the voxel-indexed bf16
    shading table ``voxel_shade`` the bounce fetches with one row gather
    keyed on the march's hit voxel."""
    from vri_tpu_torch.ops import gi as gi_mod

    centers, _ = brick_positions(cascades, config)
    nrm = cascades.brick_normal
    bias = gi_mod.surface_bias(centers, cascades, config)[:, None]
    pts = centers + nrm * bias
    irr, vis = gi_mod.direct_radiance(pts, nrm, scene, cascades, config,
                                      shadow_steps=shadow_steps,
                                      return_visibility=True)
    nb = cascades.atlas.shape[0]
    live = (torch.arange(nb, device=nrm.device) < cascades.num_bricks
            if alive is None else alive)
    irr = torch.where(live[:, None], irr, 0.0)
    vis = torch.where(live[:, None], vis, 1.0)
    shade = torch.cat(
        [cascades.brick_albedo, cascades.brick_normal, irr,
         cascades.brick_emissive,
         torch.zeros((nb, 4), dtype=torch.float32, device=nrm.device)],
        dim=1)
    shade = torch.where(live[:, None], shade, 0.0)
    bm = cascades.brick_map.reshape(-1)
    # bf16 rows, as the reference stores them: the values only feed bounce
    # shading, so the 2^-8 quantization is invisible
    vshade = torch.where((bm >= 0)[:, None],
                         shade[torch.clamp(bm, min=0).long()],
                         0.0).to(torch.bfloat16)
    return cascades.replace(brick_irradiance=irr, brick_light_vis=vis,
                            voxel_shade=vshade)


def cascades_from_numpy(arrays, device) -> SDFCascades:
    """Numpy arrays keyed by SDFCascades field name -> SDFCascades on
    ``device`` (the carry-across of a ``vri_tpu`` cascade set read out
    with ``np.asarray``; bf16 ``voxel_shade`` may arrive as float32 and is
    stored back as bf16)."""
    kw = {}
    for f in dataclasses.fields(SDFCascades):
        a = arrays.get(f.name)
        if a is not None:
            kw[f.name] = torch.as_tensor(np.array(a), device=device)
    if kw.get("voxel_shade") is not None:
        kw["voxel_shade"] = kw["voxel_shade"].to(torch.bfloat16)
    return SDFCascades(**kw)
