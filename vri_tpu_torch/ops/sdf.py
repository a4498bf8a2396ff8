"""Sparse-brick SDF cascades (counterpart of ``vri_tpu/ops/sdf.py``):
the cascade data model, the dense builder, the march-kernel tables and
the radiance bake.

The dense builder (:func:`build_cascades`) serves the configurations the
cell-binned builder cannot (``sdf_build.supports``: truncation past one
16^3 cell, as the "tiny" preset's): a dense occupancy test of every voxel
against every triangle, a cumulative-sum allocation, and an emit of each
live brick from its K nearest triangles over the whole pool.  The
cell-binned builder that fills the same tensors, and updates them, is
``ops/sdf_build.py``; ``bake_brick_lighting_partial`` re-bakes the
bricks an update touched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from vri_tpu_torch.config import SDFConfig
from vri_tpu_torch.ops import geometry
from vri_tpu_torch.ops.geometry import cross, dot3, norm3
from vri_tpu_torch.runtime import profiler

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


def _occupancy_one_cascade(a, b, c, valid, origin, vs,
                           config: SDFConfig) -> torch.Tensor:
    """(R, R, R) bool occupancy (z, y, x) of one cascade: a voxel is
    occupied when its center lies in a triangle's AABB grown by one voxel
    and within one voxel plus the half diagonal of the triangle's plane.
    The plane distance is ((dz + dy) + dx) - n.a at the voxel centers, the
    JAX package's order.  The test is an OR over triangle chunks of at
    most ``_WORK_ELEMS`` (voxel, triangle) pairs."""
    from vri_tpu_torch.ops.sdf_build import _WORK_ELEMS

    r = config.cascade_resolution
    expand = vs
    lo, hi = geometry.tri_aabb(a, b, c)
    lo = (lo - expand - origin) / vs           # voxel coordinates
    hi = (hi + expand - origin) / vs
    n = cross(b - a, c - a)
    n = n / torch.clamp(norm3(n), min=1e-20)[:, None]
    n_dot_a = dot3(n, a)
    ax_ids = torch.arange(r, dtype=torch.float32, device=a.device) + 0.5
    # voxel centers per axis: separate product and sum, as XLA without FMA
    vxyz = [origin[k] + ax_ids * vs for k in range(3)]
    half_diag = 0.8660254 * vs
    reach = expand + half_diag
    chunk = max(1, _WORK_ELEMS // (r ** 3))
    occ = torch.zeros((r, r, r), dtype=torch.bool, device=a.device)
    for s in range(0, a.shape[0], chunk):
        sl = slice(s, s + chunk)
        m = [(ax_ids[:, None] >= lo[None, sl, k])
             & (ax_ids[:, None] <= hi[None, sl, k]) for k in range(3)]
        dx, dy, dz = (vxyz[k][:, None] * n[None, sl, k] for k in range(3))
        d = ((dz[:, None, None, :] + dy[None, :, None, :])
             + dx[None, None, :, :]) - n_dot_a[None, None, None, sl]
        box = (m[2][:, None, None, :] & m[1][None, :, None, :]
               & m[0][None, None, :, :])
        occ |= (box & (torch.abs(d) <= reach)
                & valid[None, None, None, sl]).any(-1)
    return occ


def _emit_dense(bids, brick_voxel, origins, vs, tris, config: SDFConfig):
    """Atlas rows and nearest-surface albedo, emissive and normal of the
    live bricks ``bids`` (1-D): the K nearest triangles of the whole pool
    by distance from the brick center to their AABBs (ties to the lower
    triangle index, ``lax.top_k``'s rule), then the texel emit of the
    cell-binned build on those K.  Blocks of bricks hold at most a
    quarter of ``_WORK_ELEMS`` (brick, triangle) distances."""
    from vri_tpu_torch.ops.sdf_build import (_WORK_ELEMS, _brick_frame,
                                             _emit_texels)

    a, b, c, valid, tri_lo, tri_hi, tri_albedo, tri_emissive, tri_n = tris
    k_tris = min(config.max_triangles_per_brick, a.shape[0])
    f = a.shape[0]
    idx = torch.arange(f, dtype=torch.int64, device=a.device)
    block = max(1, min(1024, _WORK_ELEMS // (4 * f)))
    outs = []
    for b0 in range(0, bids.shape[0], block):
        blk = bids[b0:b0 + block]
        _, _, vsz, _, vmin, bc, trunc_w = _brick_frame(
            blk, brick_voxel, origins, vs, config)
        dlo = torch.clamp(tri_lo[None, :, :] - bc[:, None, :], min=0.0)
        dhi = torch.clamp(bc[:, None, :] - tri_hi[None, :, :], min=0.0)
        dm = torch.maximum(dlo, dhi)
        d2 = torch.where(valid[None, :], dot3(dm, dm), BIG)
        # d2 >= 0 orders like its bit pattern; the index in the low 24
        # bits makes every key unique and breaks ties to the lower index
        keys = (d2.view(torch.int32).to(torch.int64) << 24) | idx[None, :]
        knn = torch.topk(keys, k_tris, dim=1, largest=False,
                         sorted=True).indices                  # (block, K)
        live = torch.ones_like(blk, dtype=torch.bool)
        outs.append(_emit_texels(
            vmin, vsz, trunc_w, knn, torch.ones_like(knn, dtype=torch.bool),
            live, a, b, c, valid, tri_albedo, tri_emissive, tri_n, config))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(4))


def build_cascades(world_verts: torch.Tensor, tri_vertices: torch.Tensor,
                   num_faces, centers: torch.Tensor, *,
                   tri_albedo: torch.Tensor | None = None,
                   tri_emissive: torch.Tensor | None = None,
                   config: SDFConfig) -> SDFCascades:
    """Dense cascade build from the world-space triangle soup (``vri_tpu``'s
    ``sdf.build_cascades``): occupancy, allocation by a cumulative sum in
    (cascade, z, y, x) order with the voxels past ``max_bricks`` counted
    in ``overflow``, the Chebyshev empty-space distance of every empty
    voxel, and the emit of the live bricks.  Dead atlas rows hold distance
    1 and zero shading, as the JAX build leaves them."""
    from vri_tpu_torch.ops.sdf_build import (_cascade_geometry, _prep_tris,
                                             esd_map)

    n_cas = config.num_cascades
    r = config.cascade_resolution
    bsz = config.brick_size
    max_bricks = config.max_bricks
    f = tri_vertices.shape[0]
    dev = world_verts.device
    if f >= (1 << 24):
        raise ValueError(f"face pool {f} exceeds the 24-bit index of the "
                         "dense emit's top-k keys")
    a, b, c, valid, tri_n, tri_albedo, tri_emissive = _prep_tris(
        world_verts, tri_vertices, num_faces, tri_albedo, tri_emissive)
    vs, origins = _cascade_geometry(config, centers)

    # -- 1. occupancy ------------------------------------------------------
    occ = torch.stack([
        _occupancy_one_cascade(a, b, c, valid, origins[i], vs[i], config)
        for i in range(n_cas)])                        # (N, R, R, R)

    # -- 2. allocation (cumsum compaction) ------------------------------------
    occ_flat = occ.reshape(-1)
    ids = torch.cumsum(occ_flat.to(torch.int64), 0) - 1
    total_occ = occ_flat.sum()
    alloc = occ_flat & (ids < max_bricks)
    num_bricks = torch.clamp(total_occ, max=max_bricks).to(torch.int32)
    overflow = (total_occ - num_bricks).to(torch.int32)
    brick_voxel = torch.zeros((max_bricks,), dtype=torch.int32, device=dev)
    vox_ids = torch.nonzero(alloc).reshape(-1)
    brick_voxel[ids[vox_ids]] = vox_ids.to(torch.int32)
    brick_map = torch.where(alloc, ids.to(torch.int32),
                            -esd_map(occ)).reshape(n_cas, r, r, r)

    # -- 3. emit (live bricks only: a dead brick's rows are constant) -------
    n_live = int(num_bricks)
    atlas = torch.full((max_bricks, bsz, bsz, bsz),
                       255 if config.atlas_u8 else 1.0,
                       dtype=torch.uint8 if config.atlas_u8
                       else torch.float32, device=dev)
    albs = torch.zeros((max_bricks, 3), dtype=torch.float32, device=dev)
    emis = torch.zeros_like(albs)
    nrms = torch.zeros_like(albs)
    if n_live:
        tri_lo, tri_hi = geometry.tri_aabb(a, b, c)
        tri_lo = torch.where(valid[:, None], tri_lo, BIG)
        tri_hi = torch.where(valid[:, None], tri_hi, -BIG)
        (atlas[:n_live], albs[:n_live], emis[:n_live],
         nrms[:n_live]) = _emit_dense(
            torch.arange(n_live, device=dev), brick_voxel, origins, vs,
            (a, b, c, valid, tri_lo, tri_hi, tri_albedo, tri_emissive,
             tri_n), config)

    mc, mf0, mf1 = build_march_tables(brick_map, atlas, config=config)
    return SDFCascades(
        center=centers, voxel_size=vs, brick_map=brick_map, atlas=atlas,
        brick_voxel=brick_voxel, brick_albedo=albs, brick_emissive=emis,
        brick_normal=nrms,
        brick_irradiance=torch.zeros((max_bricks, 3), dtype=torch.float32,
                                     device=dev),
        brick_light_vis=torch.ones((max_bricks, 1), dtype=torch.float32,
                                   device=dev),
        num_bricks=num_bricks, overflow=overflow,
        march_coarse=mc, march_fine0=mf0, march_fine1=mf1,
        near_drop=torch.zeros((), dtype=torch.int32, device=dev))


def build_for_scene(scene, world_verts, focus, config: SDFConfig
                    ) -> SDFCascades:
    """Dense build of ``scene``'s cascades centered on ``focus``, with each
    triangle's material albedo and emission."""
    centers = default_centers(config, focus, device=world_verts.device)
    mat = scene.instance_material[scene.tri_instance.long()].long()
    return build_cascades(world_verts, scene.tri_vertices, scene.num_faces,
                          centers, tri_albedo=scene.mat_base_color[mat],
                          tri_emissive=scene.mat_emissive[mat],
                          config=config)


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
    live = (torch.arange(cascades.atlas.shape[0], device=nrm.device)
            < cascades.num_bricks if alive is None else alive)
    return _with_lighting(cascades, irr, vis, live)


def _with_lighting(cascades: SDFCascades, irr, vis, live) -> SDFCascades:
    """``cascades`` with the baked irradiance and visibility of every brick
    (zero and one on dead slots) and the voxel-indexed shading table built
    from them."""
    nb = cascades.atlas.shape[0]
    irr = torch.where(live[:, None], irr, 0.0)
    vis = torch.where(live[:, None], vis, 1.0)
    shade = torch.cat(
        [cascades.brick_albedo, cascades.brick_normal, irr,
         cascades.brick_emissive,
         torch.zeros((nb, 4), dtype=torch.float32, device=irr.device)],
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


#: length of a distant light's shadow segment in ``lighting_dirty_bricks``
_DISTANT_REACH = 1.0e3


def lighting_dirty_bricks(cascades: SDFCascades, scene, dirty_lo, dirty_hi,
                          *, config: SDFConfig) -> torch.Tensor:
    """Conservative (max_bricks,) mask of the bricks whose baked direct
    lighting can change when geometry inside the ``dirty_lo/hi`` AABBs
    moved: the brick's shadow segment (its voxel center to each light;
    ``_DISTANT_REACH`` along a distant light's direction) crosses a dirty
    box inflated by the brick's own cascade's truncation distance (moved
    geometry reshapes the field that far).  A dead pad box (+BIG lo,
    -BIG hi) flags nothing.  One box at a time, so the peak stays at
    (bricks, lights, 3)."""
    from vri_tpu_torch.ops import gi as gi_mod

    centers, cas_i = brick_positions(cascades, config)
    lp, _, _, lt = gi_mod._light_arrays(scene)
    b, l = centers.shape[0], lp.shape[0]
    is_distant = (lt == 1)[None, :, None]
    p0 = centers[:, None, :]                                # (B, 1, 3)
    end = torch.where(is_distant, p0 + lp[None, :, :] * _DISTANT_REACH,
                      lp[None, :, :].expand(b, l, 3))
    d = end - p0
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
    reach = (config.truncation_voxels
             * cascades.voxel_size[cas_i])[:, None, None]   # (B, 1, 1)
    mask = torch.zeros((b,), dtype=torch.bool, device=centers.device)
    for lo_k, hi_k in zip(dirty_lo, dirty_hi):
        # the per-axis min/max below would turn an inverted (dead) box
        # into an everything-box: test validity explicitly
        ok_box = (lo_k <= hi_k).all()
        t1 = (lo_k[None, None, :] - reach - p0) * inv
        t2 = (hi_k[None, None, :] + reach - p0) * inv
        tmin = torch.minimum(t1, t2).max(dim=-1).values     # (B, L)
        tmax = torch.maximum(t1, t2).min(dim=-1).values
        hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin <= 1.0) & ok_box
        mask |= hit.any(dim=-1)
    return mask


def bake_brick_lighting_partial(cascades: SDFCascades, scene, mask, alive, *,
                                config: SDFConfig, cap: int = 16384,
                                shadow_steps: int = 32,
                                axis_name: tuple | None = None):
    """Re-bake the irradiance and visibility of only the live bricks in
    ``mask`` (the animated frame's payload-dirty and lighting-dirty sets);
    every other brick keeps its baked values, so the shadow march scales
    with the dirty set.  The first ``cap`` of them (in brick order) are
    re-baked and the rest counted.  Returns (cascades, dropped): a
    non-zero ``dropped`` means the caller must fall back to the full
    bake.  The voxel-indexed shading table is rebuilt from the merged
    rows as the full bake builds it.

    ``axis_name=(axis, n)`` splits the re-baked bricks over the ``n`` ranks
    of a mesh axis as the JAX function does (``vri_tpu/ops/sdf.py:
    540-566``): rank i marches entries [i * cap / n, (i + 1) * cap / n) of
    the first ``cap``, and one all_gather merges them (each share padded
    to cap / n).  ``(None, n)`` is the single-device measurement proxy: it
    re-bakes and scatters share 0 alone."""
    from vri_tpu_torch.ops import gi as gi_mod

    pos = torch.nonzero(mask & alive).reshape(-1)
    dropped = max(pos.shape[0] - cap, 0)
    pos = pos[:cap]
    irr_all = cascades.brick_irradiance.clone()
    vis_all = cascades.brick_light_vis.clone()

    def bake(ids):
        if not ids.shape[0]:
            return (cascades.brick_irradiance[:0],
                    cascades.brick_light_vis[:0])
        centers, _ = brick_positions(cascades, config)
        c = centers[ids]
        nrm = cascades.brick_normal[ids]
        bias = gi_mod.surface_bias(c, cascades, config)[:, None]
        return gi_mod.direct_radiance(c + nrm * bias, nrm, scene, cascades,
                                      config, shadow_steps=shadow_steps,
                                      return_visibility=True)

    if axis_name is None:
        irr, vis = bake(pos)
    else:
        from vri_tpu_torch.parallel import mesh as mesh_mod

        ax, n_shard = axis_name
        if cap % n_shard:
            raise ValueError(f"bake cap {cap} must divide over {n_shard} "
                             "devices")
        per = cap // n_shard
        i = 0 if ax is None else ax.index
        pos = pos[i * per:(i + 1) * per]
        irr, vis = bake(pos)
        if ax is not None:
            pos, (irr, vis) = mesh_mod.gather_padded(pos, (irr, vis), per,
                                                     ax)
    profiler.count("rebake.bricks", pos.shape[0])
    irr_all[pos] = irr
    vis_all[pos] = vis
    return _with_lighting(cascades, irr_all, vis_all, alive), dropped


def build_state_from_numpy(arrays, device):
    """Numpy arrays keyed by ``sdf_build.BuildState`` field name -> a
    BuildState on ``device`` (the carry-across of a ``vri_tpu`` build
    state read out with ``np.asarray``)."""
    from vri_tpu_torch.ops.sdf_build import BuildState

    return BuildState(**{
        f.name: torch.as_tensor(np.array(arrays[f.name]), device=device)
        for f in dataclasses.fields(BuildState)
        if arrays.get(f.name) is not None})


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
