"""Plain SDF cascades, as the production frame reads them.

The frame's lightloop reads three things of the cascades: which voxels
hold a surface brick (occupancy), which of those the march may hit (a
"surface" voxel: some texel of its 8^3 brick lies within 1.5 texels of
the geometry, as the 8-bit atlas quantizes it), and a shading row per
voxel (albedo, normal, baked irradiance, emissive, stored in bfloat16).
This module works them out from the triangles by the configuration's
rules:

* cascades: ``num_cascades`` grids of R^3 voxels of size ``base * (1 +
  i)``, centred on the camera's eye clamped into the scene's bounds and
  snapped to each cascade's 16^3-cell grid;
* occupancy: a voxel center inside a triangle's bounds grown by one
  voxel, within one voxel plus the half diagonal of its plane;
* bricks: the occupied voxels in index order, at most ``max_bricks``;
* surface: the nearest texel center's distance to any triangle, over
  the truncation width (4 voxels), rounded to 8 bits, below 1.5 texels;
* shading: albedo, emissive and unit normal of the triangle whose
  bounds lie nearest the voxel center (ties to the lower triangle), and
  the irradiance of the scene's point lights at the voxel center lifted
  by 0.75 of the finest voxel there, each shadowed by a march of these
  cascades (``lightloop.march``) from a second such lift.

Every pass pairs triangles with the voxels their bounds reach, so the
work follows the geometry, in chunks that bound the memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PAIRS_PER_CHUNK = 1 << 22
#: texel pairs (voxel, triangle, texel) a chunk of the surface test holds
TEXELS_PER_CHUNK = 1 << 25
HIT_TEXELS = 1.5
BIG = 3.0e38


def dot3(u, v):
    p = u * v
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross3(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def point_triangle_distance(p, a, b, c):
    """Distance from points p to triangles (a, b, c), broadcasting over
    the leading axes (Ericson, Real-Time Collision Detection, 5.1.5)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = dot3(ab, ap), dot3(ac, ap)
    bp = p - b
    d3, d4 = dot3(ab, bp), dot3(ac, bp)
    cp = p - c
    d5, d6 = dot3(ab, cp), dot3(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(x):
        return torch.where(torch.abs(x) > 1e-30, x, torch.ones_like(x))

    den = safe(va + vb + vc)
    v_in, w_in = vb / den, vc / den
    t_ab = torch.clamp(d1 / safe(d1 - d3), 0.0, 1.0)
    t_ac = torch.clamp(d2 / safe(d2 - d6), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0) & ~in_a & ~in_b
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0) & ~in_a & ~in_c & ~on_ab
    on_bc = ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
             & ~in_b & ~in_c & ~on_ab & ~on_ac)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    v = torch.where(in_a | in_c, zero, torch.where(
        in_b, one, torch.where(on_ab, t_ab, torch.where(
            on_ac, zero, torch.where(on_bc, 1.0 - t_bc, v_in)))))
    w = torch.where(in_a | in_b, zero, torch.where(
        in_c, one, torch.where(on_ab, zero, torch.where(
            on_ac, t_ac, torch.where(on_bc, t_bc, w_in)))))
    q = a + v[..., None] * ab + w[..., None] * ac
    return torch.sqrt(dot3(p - q, p - q))


def _pairs(lo_idx, hi_idx, r):
    """(triangle, voxel x, y, z) for every voxel of each triangle's
    inclusive index box, clipped to [0, r), yielded in chunks."""
    lo = torch.clamp(lo_idx, 0, r - 1)
    hi = torch.clamp(hi_idx, -1, r - 1)
    ext = torch.clamp(hi - lo + 1, min=0)
    n = ext[:, 0] * ext[:, 1] * ext[:, 2]
    ids = torch.nonzero(n > 0).reshape(-1)
    cum = torch.cumsum(n[ids], 0)
    start, done, total = 0, 0, int(cum[-1]) if ids.numel() else 0
    while done < total:
        stop = max(int(torch.searchsorted(cum, done + PAIRS_PER_CHUNK,
                                          right=True)), start + 1)
        tid = ids[start:stop]
        cnt = n[tid]
        tri = torch.repeat_interleave(tid, cnt)
        k = torch.arange(tri.numel(), device=tri.device) \
            - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        ex, ey = ext[tri, 0], ext[tri, 1]
        x = lo[tri, 0] + k % ex
        y = lo[tri, 1] + (k // ex) % ey
        z = lo[tri, 2] + k // (ex * ey)
        yield tri, x, y, z
        done = int(cum[stop - 1])
        start = stop


def cascade_frames(sdf: dict, focus, device):
    """(voxel sizes (N,), centers (N, 3), origins (N, 3)), float32."""
    n, r = sdf["num_cascades"], sdf["cascade_resolution"]
    s = max(r // 16, 1)
    vs = torch.tensor([sdf["base_voxel_size"] * (1.0 + i) for i in range(n)],
                      dtype=torch.float32, device=device)
    snap = torch.tensor([sdf["base_voxel_size"] * (1.0 + i) * s
                         for i in range(n)], dtype=torch.float32,
                        device=device)
    centers = torch.round(focus[None, :] / snap[:, None]) * snap[:, None]
    return vs, centers, centers - 0.5 * r * vs[:, None]


def finest_voxel_size(vs, origins, r, points):
    """Voxel size of the finest cascade holding each point (the coarsest
    cascade's outside all)."""
    local = (points[:, None, :] - origins[None]) / vs[None, :, None]
    inside = ((local >= 0) & (local < r)).all(-1)
    size = torch.where(inside, vs[None, :].expand_as(inside.float()),
                       torch.full_like(inside.float(), math.inf)).min(-1).values
    return torch.where(torch.isfinite(size), size, vs[-1])


def build(arrays: dict, sdf: dict, eye, device, quantize=None) -> dict:
    """The cascades of the triangles in ``arrays`` under the settings
    ``sdf`` (the configuration's), around ``eye``."""
    q = quantize or (lambda t: t)
    n_cas, r, bsz = (sdf["num_cascades"], sdf["cascade_resolution"],
                     sdf["brick_size"])
    corners = q(torch.as_tensor(arrays["corners"], dtype=torch.float64,
                                device=device)).float()
    a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
    inst = torch.as_tensor(arrays["tri_instance"], device=device).long()
    tri_alb = torch.as_tensor(arrays["albedo"], device=device)[inst]
    tri_emi = torch.as_tensor(arrays["emissive"], device=device)[inst]
    nrm = cross3(b - a, c - a)
    nrm = nrm / torch.clamp(torch.sqrt(dot3(nrm, nrm)), min=1e-20)[:, None]
    nda = dot3(nrm, a)
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    focus = torch.minimum(torch.maximum(
        q(torch.as_tensor(eye, device=device).double()).float(),
        lo.min(0).values), hi.max(0).values)
    vs, centers, origins = cascade_frames(sdf, focus, device)

    occ = torch.zeros((n_cas, r, r, r), dtype=torch.bool, device=device)
    for i in range(n_cas):
        v, o = vs[i], origins[i]
        # voxel centers o + (k + 0.5) v inside [lo - v, hi + v]
        kl = torch.ceil((lo - v - o) / v - 0.5).long()
        kh = torch.floor((hi + v - o) / v - 0.5).long()
        for tri, x, y, z in _pairs(kl, kh, r):
            p = o + (torch.stack([x, y, z], -1).float() + 0.5) * v
            inside = ((p >= lo[tri] - v) & (p <= hi[tri] + v)).all(-1)
            near = torch.abs(dot3(p, nrm[tri]) - nda[tri]) <= 1.8660254 * v
            keep = inside & near
            occ[i, z[keep], y[keep], x[keep]] = True

    flat = occ.reshape(-1)
    order = torch.cumsum(flat.long(), 0) - 1
    alive_flat = flat & (order < sdf["max_bricks"])
    vox = torch.nonzero(alive_flat).reshape(-1)          # brick -> voxel
    cas_of = vox // r ** 3
    rem = vox % r ** 3
    vxyz = torch.stack([rem % r, (rem // r) % r, rem // (r * r)], -1)
    vsz = vs[cas_of]
    vmin = origins[cas_of] + vxyz.float() * vsz[:, None]
    vcen = origins[cas_of] + (vxyz.float() + 0.5) * vsz[:, None]
    nb = vox.numel()

    # nearest triangle by bounds distance from each brick's center, and
    # the nearest texel distance to any triangle
    best_d2 = torch.full((nb,), math.inf, device=device)
    best_key = torch.full((nb,), 1 << 62, dtype=torch.long, device=device)
    dmin = torch.full((nb,), BIG, device=device)
    brick_of = torch.full((n_cas * r ** 3,), -1, dtype=torch.long,
                          device=device)
    brick_of[vox] = torch.arange(nb, device=device)
    trunc = sdf["truncation_voxels"]
    tex = (torch.arange(bsz, dtype=torch.float32, device=device) + 0.5) / bsz
    tz, ty, tx = torch.meshgrid(tex, tex, tex, indexing="ij")
    tex = torch.stack([tx, ty, tz], -1).reshape(-1, 3)     # (B^3, 3)
    for i in range(n_cas):
        v, o = vs[i], origins[i]
        # every voxel whose center lies within 2 voxels of a triangle's
        # bounds: the nearest bounds of an occupied voxel lie within
        # sqrt(3) voxels, and every texel within 1.5 texels of a surface
        kl = torch.floor((lo - 2.0 * v - o) / v).long()
        kh = torch.floor((hi + 2.0 * v - o) / v).long()
        for tri, x, y, z in _pairs(kl, kh, r):
            bid = brick_of[i * r ** 3 + (z * r + y) * r + x]
            keep = bid >= 0
            tri, bid = tri[keep], bid[keep]
            cen = vcen[bid]
            dm = torch.maximum(torch.clamp(lo[tri] - cen, min=0.0),
                               torch.clamp(cen - hi[tri], min=0.0))
            d2 = dot3(dm, dm)
            best_d2.scatter_reduce_(0, bid, d2, "amin")
            # texel distances for the triangles that can reach a texel
            # within the surface threshold
            reach = HIT_TEXELS / bsz * v + 0.8660254 * v
            cand = d2 <= reach * reach
            tc, bc = tri[cand], bid[cand]
            step = max(1, TEXELS_PER_CHUNK // tex.shape[0])
            for s0 in range(0, tc.numel(), step):
                t_, b_ = tc[s0:s0 + step], bc[s0:s0 + step]
                pts = vmin[b_][:, None, :] + tex[None] * vsz[b_][:, None,
                                                               None]
                d = point_triangle_distance(pts, a[t_][:, None], b[t_][:, None],
                                            c[t_][:, None]).min(1).values
                dmin.scatter_reduce_(0, b_, d, "amin")
    # the winner among the triangles at the least distance: the build's
    # candidate order, which lists a brick's 27 neighbour cells in turn
    # (each triangle in the neighbour cell nearest its bounds' center
    # cell), within a cell by the 4x4x4 stratum of its bounds' center,
    # then by triangle; triangles spanning more than 8 cells an axis
    # (with one voxel of margin) come last
    s_cells = r // 16
    ctr = 0.5 * (lo + hi)
    for i in range(n_cas):
        v, o = vs[i], origins[i]
        cw = v * s_cells
        span = (torch.floor((hi + v - o) / cw)
                - torch.floor((lo - v - o) / cw) + 1)
        large = (span > 8).any(-1)
        frac = (ctr - o) / cw
        st3 = torch.clamp(((frac - torch.floor(frac)) * 4.0).long(), 0, 3)
        strat = (st3[:, 2] << 4) | (st3[:, 1] << 2) | st3[:, 0]
        ctr_cell = torch.floor((ctr - o) / cw).long()
        kl = torch.floor((lo - 2.0 * v - o) / v).long()
        kh = torch.floor((hi + 2.0 * v - o) / v).long()
        for tri, x, y, z in _pairs(kl, kh, r):
            bid = brick_of[i * r ** 3 + (z * r + y) * r + x]
            keep = bid >= 0
            tri, bid = tri[keep], bid[keep]
            x, y, z = x[keep], y[keep], z[keep]
            cen = vcen[bid]
            dm = torch.maximum(torch.clamp(lo[tri] - cen, min=0.0),
                               torch.clamp(cen - hi[tri], min=0.0))
            at_min = dot3(dm, dm) == best_d2[bid]
            tri, bid = tri[at_min], bid[at_min]
            cell = torch.stack([x[at_min], y[at_min], z[at_min]],
                               -1) // s_cells
            canon = torch.minimum(torch.maximum(
                ctr_cell[tri], torch.clamp(cell - 1, min=0)),
                torch.clamp(cell + 1, max=15))
            off = canon - cell + 1
            j = (off[:, 2] * 3 + off[:, 1]) * 3 + off[:, 0]
            j = torch.where(large[tri], 27, j)
            st = torch.where(large[tri], 0, strat[tri])
            key = ((j * 64 + st) << 32) | tri
            best_key.scatter_reduce_(0, bid, key, "amin")
    best_tri = torch.where(best_key < (1 << 62), best_key & 0xFFFFFFFF,
                           torch.full_like(best_key, 1 << 62))
    found = best_tri < (1 << 62)
    near_tri = torch.clamp(torch.where(found, best_tri, 0), max=a.shape[0] - 1)

    trunc_w = trunc * vsz
    d01 = torch.clamp(dmin / trunc_w, 0.0, 1.0)
    if sdf["atlas_u8"]:
        d01 = torch.round(d01 * 255.0) * (1.0 / 255.0)
    surf_b = d01 < HIT_TEXELS / (trunc * bsz)
    surf = torch.zeros((n_cas * r ** 3,), dtype=torch.bool, device=device)
    surf[vox] = surf_b
    surf = surf.reshape(n_cas, r, r, r)
    zero = torch.zeros((nb, 3), device=device)
    b_alb = torch.where(found[:, None], tri_alb[near_tri], zero)
    b_emi = torch.where(found[:, None], tri_emi[near_tri], zero)
    b_nrm = torch.where(found[:, None], nrm[near_tri], zero)

    cas = {"vs": vs, "centers": centers, "origins": origins, "r": r,
           "occ": alive_flat.reshape(n_cas, r, r, r), "surf": surf, "coarse": coarse_distance(surf),
           "voxel_of_brick": vox}
    from perfbench.reference import lightloop

    irr = lightloop.bake(cas, vcen, b_nrm, arrays, sdf, quantize)
    rows = torch.cat([b_alb, b_nrm, q(irr), b_emi,
                      torch.zeros((nb, 4), device=device)], 1)
    shade = torch.zeros((n_cas * r ** 3, 16), dtype=torch.bfloat16,
                        device=device)
    shade[vox] = rows.to(torch.bfloat16)
    cas["voxel_shade"] = shade
    return cas


def coarse_distance(surf):
    """(N, 16, 16, 16) Chebyshev distance, in cells, from each 16^3 cell
    to the nearest cell holding a surface voxel, capped at 15."""
    n, r = surf.shape[0], surf.shape[1]
    s = r // 16
    cell = surf.reshape(n, 16, s, 16, s, 16, s).any(6).any(4).any(2)
    d = torch.where(cell, 0.0, 15.0)
    for _ in range(14):
        pooled = -F.max_pool3d(-d, kernel_size=3, stride=1, padding=1)
        d = torch.minimum(d, pooled + 1.0)
    return torch.clamp(d, 0, 15).long()


def unpack_surface(fine0, fine1, n: int, r: int):
    """(N, R, R, R) surface voxels from march tables packed as bit words
    a 16^3 cell (bit ((z % s) * s + y % s) * s + x % s of a cell)."""
    s = r // 16
    w0 = fine0.reshape(n, 4096).long() & 0xFFFFFFFF
    w1 = fine1.reshape(n, 4096).long() & 0xFFFFFFFF
    bit = torch.arange(s ** 3, device=w0.device)
    words = torch.where(bit < 32, w0[..., None], w1[..., None])
    cells = ((words >> (bit & 31)) & 1).bool()             # (n, 4096, s^3)
    return cells.reshape(n, 16, 16, 16, s, s, s).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(n, r, r, r)


def compare_cascades(got: dict, ref: dict) -> dict:
    """Shares of voxels off between two cascades (``occ``, ``surf``,
    ``voxel_shade``): occupancy and surface voxels over the voxels either
    side marks, shading rows over the voxels both occupy (a row is off
    where a component differs by more than 2^-6 of its magnitude plus
    2^-8)."""
    occ_g, occ_r = got["occ"], ref["occ"]
    union = occ_g | occ_r
    occ_off = float((occ_g != occ_r).sum()) / max(int(union.sum()), 1)
    su = got["surf"] | ref["surf"]
    surf_off = float((got["surf"] != ref["surf"]).sum()) \
        / max(int(su.sum()), 1)
    both = (occ_g & occ_r).reshape(-1)
    a = got["voxel_shade"][both].float()
    b = ref["voxel_shade"][both].float()
    bad = (torch.abs(a - b) > torch.abs(b) / 64 + 1 / 256).any(-1)
    shade_off = float(bad.sum()) / max(int(both.sum()), 1)
    return {"sdf_occ_off": occ_off, "sdf_surf_off": surf_off,
            "sdf_shade_off": shade_off}
