"""Cell-binned SDF cascade builder (counterpart of the build path of
``vri_tpu/ops/sdf_build.py``).

  1. **bin**: each triangle emits exactly one (cell, tri) pair per cell
     its AABB (+ 1 voxel) covers; cells are 16^3 per cascade (s = R/16
     voxels each, the march kernel's coarse grid).  One stable sort per
     cascade turns the pair stream into capacity-bounded per-cell lists,
     kept as a spatially stratified subsample when demand exceeds K
     (overflow counted).  Triangles spanning more than 8 cells an axis
     take the small per-cascade global list every cell also tests.
  2. **occupancy**: every cell tests only its own list.
  3. **emit**: a brick's candidates are its cell's 27-neighbourhood lists
     plus the global list, deduplicated by ownership; the k nearest by
     AABB distance feed the exact texel distance pass.

``demand_caps`` measures the exact list demand first so production builds
drop no reference.  The bounded incremental update and the clipmap
scroll are not ported yet (ROADMAP.md, "What comes next", item 5).
"""

from __future__ import annotations

import dataclasses

import torch

from vri_tpu.config import SDFConfig
from vri_tpu_torch.ops import geometry
from vri_tpu_torch.ops.geometry import cross, dot3, norm3
from vri_tpu_torch.ops.sdf import (BIG, SDFCascades, _min_pool_iter,
                                   build_march_tables, cascade_origin)

# Row layout of the per-slot reference tables: lo3 hi3 n3 nda id
ROW = 11
_PAD_ROW = (BIG, BIG, BIG, -BIG, -BIG, -BIG, 0.0, 0.0, 0.0, BIG, -1.0)

_BIN_SPAN_CAP = 8        # per-axis cells a triangle may emit exactly
_BIN_PAIRS_MULT = 12     # pairs capacity = mult * working-set size

# auto-cap ceilings of demand_caps; beyond them drops stay counted.  The
# cell-list ceiling bounds cell_rows (n_cas * 4096 * K * ROW * 4 bytes).
# The JAX package holds it at 512 (554 MB at 6 cascades) for the TPU's
# 16 GB; the H100's 80 GB take 4096 (4.4 GB), which covers the 49k-triangle
# kitchen at the room preset (demand 3517 refs in one coarse cell) with no
# dropped reference.  Builds whose demand stays under 512 are unchanged.
_AUTO_CELL_CAP_MAX = 4096
_AUTO_GLOB_CAP_MAX = 8192
# working-set bound of the occupancy test and the emit, in float32 values
_WORK_ELEMS = 1 << 27


def _pad_row(device) -> torch.Tensor:
    return torch.tensor(_PAD_ROW, dtype=torch.float32, device=device)


def _nb_offsets(device) -> torch.Tensor:
    return torch.tensor([[ox, oy, oz] for oz in (-1, 0, 1)
                         for oy in (-1, 0, 1) for ox in (-1, 0, 1)],
                        dtype=torch.int32, device=device)   # (27, 3)


def supports(config: SDFConfig) -> bool:
    """Cell binning requires 16^3 cells and truncation <= one cell."""
    r = config.cascade_resolution
    return (r % 16 == 0 and r // 16 >= 1
            and config.truncation_voxels <= r // 16)


@dataclasses.dataclass
class BuildState:
    """Binning state of a build (the input of later bounded updates)."""

    cell_tris: torch.Tensor    # (N, 4096, K) i32 triangle ids, -1 padded
    cell_count: torch.Tensor   # (N, 4096) i32 (capped at K)
    cell_rows: torch.Tensor    # (N*4096, K, ROW) f32 slot data
    glob_tris: torch.Tensor    # (N, Kg) i32 large-triangle ids
    glob_rows: torch.Tensor    # (N, Kg, ROW) f32
    alive: torch.Tensor        # (max_bricks,) bool — atlas slot in use
    list_overflow: torch.Tensor  # () — refs dropped at capacity
    emit_bricks: torch.Tensor | None = None  # (max_bricks,) bool


def _tri_table(a, b, c, valid):
    """(Fp, ROW) per-triangle row data (world AABB, plane, id)."""
    # triangle ids ride an f32 column, exact only to 2^24
    if a.shape[0] >= (1 << 24):
        raise ValueError(f"face cap {a.shape[0]} exceeds the f32-exact id "
                         "range (2^24)")
    lo, hi = geometry.tri_aabb(a, b, c)
    n = cross(b - a, c - a)
    n = n / torch.clamp(norm3(n), min=1e-20)[:, None]
    nda = dot3(n, a)
    ids = torch.arange(a.shape[0], dtype=torch.float32, device=a.device)
    table = torch.cat([lo, hi, n, nda[:, None], ids[:, None]], dim=1)
    return torch.where(valid[:, None], table, _pad_row(a.device)[None, :])


def _rows_from_lists(lists, table):
    """Gather (…, K) triangle ids -> (…, K, ROW), padding id<0 slots."""
    rows = table[torch.clamp(lists, min=0).long()]
    return torch.where((lists >= 0)[..., None], rows, _pad_row(table.device))


def _cell_span(tri_lo, tri_hi, origin, vs, r, reach_vox: float):
    """Inclusive cell-coordinate span of each triangle's AABB expanded by
    ``reach_vox`` voxels."""
    s = r // 16
    cw = s * vs
    e = reach_vox * vs
    clo = torch.floor((tri_lo - e - origin) / cw).to(torch.int32)
    chi = torch.floor((tri_hi + e - origin) / cw).to(torch.int32)
    return clo, chi


def _pair_emission(tri_lo, tri_hi, valid, origin, vs, r):
    """Exact segmented (cell, tri) pair emission shared by the binning and
    the demand count: (tri_of, cell, j, total, pairs_cap, large)."""
    f = tri_lo.shape[0]
    dev = tri_lo.device
    clo, chi = _cell_span(tri_lo, tri_hi, origin, vs, r, 1.0)
    inside = (valid & (chi >= 0).all(-1) & (clo < 16).all(-1))
    clo_c = torch.clamp(clo, 0, 15)
    chi_c = torch.clamp(chi, 0, 15)
    nspan = chi_c - clo_c + 1                              # (F, 3) >= 1
    # classify by the UNCLIPPED span (window-independent small/global split)
    small = inside & (chi - clo + 1 <= _BIN_SPAN_CAP).all(-1)
    large = inside & ~small

    s_cells = max(r // 16, 1)
    mult = _BIN_PAIRS_MULT * max(1, (1 + 2 // s_cells) ** 2)
    ext = torch.where(small, nspan[:, 0] * nspan[:, 1] * nspan[:, 2],
                      torch.zeros_like(nspan[:, 0])).to(torch.int64)
    cum_ext = torch.cumsum(ext, 0)
    total = cum_ext[-1]
    pairs_cap = -(-max(mult * f, 32768) // 1024) * 1024
    j = torch.arange(pairs_cap, dtype=torch.int64, device=dev)
    tri_of = torch.clamp(torch.searchsorted(cum_ext, j, right=True),
                         max=f - 1)
    k_local = j - (cum_ext[tri_of] - ext[tri_of])
    # integer decode of the pair's (dx, dy, dz) within the span (the JAX
    # package uses an exact f32 form; both are exact for live pairs)
    nx = torch.clamp(nspan[tri_of, 0], min=1).to(torch.int64)
    ny = torch.clamp(nspan[tri_of, 1], min=1).to(torch.int64)
    dx = torch.remainder(k_local, nx)
    t = torch.div(k_local, nx, rounding_mode="floor")
    dy = torch.remainder(t, ny)
    dz = torch.div(t, ny, rounding_mode="floor")
    base_c = clo_c[tri_of].to(torch.int64)
    cell = ((base_c[:, 2] + dz) * 256 + (base_c[:, 1] + dy) * 16
            + (base_c[:, 0] + dx))
    return tri_of, cell, j, total, pairs_cap, large


def _bin_one_cascade(tri_lo, tri_hi, valid, origin, vs, r, K, Kg):
    """(cell_tris (4096,K), count (4096,), glob (Kg,), overflow ())."""
    f = tri_lo.shape[0]
    dev = tri_lo.device
    tri_ids = torch.arange(f, dtype=torch.int32, device=dev)
    tri_of, cell, j, total, pairs_cap, large = _pair_emission(
        tri_lo, tri_hi, valid, origin, vs, r)
    overflow = torch.clamp(total - pairs_cap, min=0)
    dead = j >= total

    # spatial stratum: 2-bit per axis cell-local centroid position of the
    # source triangle — the per-cell tiebreak of the stable sort
    centroid = 0.5 * (tri_lo + tri_hi)
    cellw = vs * (r // 16)
    frac = (centroid - origin) / cellw
    strat3 = torch.clamp(((frac - torch.floor(frac)) * 4.0).to(torch.int32),
                         0, 3).to(torch.int64)
    strat = (strat3[:, 2] << 4) | (strat3[:, 1] << 2) | strat3[:, 0]
    key = (cell << 6) | strat[tri_of]
    key = torch.where(dead, torch.full_like(key, 4096 << 6), key)
    vals = torch.where(dead, torch.full_like(tri_of, -1),
                       tri_ids[tri_of].to(torch.int64))
    skeys, order = torch.sort(key, stable=True)
    stris = vals[order]

    bounds = torch.arange(4097, dtype=torch.int64, device=dev) << 6
    starts = torch.searchsorted(skeys, bounds)
    count = starts[1:] - starts[:-1]                       # (4096,)
    k_ids = torch.arange(K, dtype=torch.int64, device=dev)
    gidx = starts[:4096, None] + k_ids[None, :]
    in_seg = k_ids[None, :] < count[:, None]
    cell_tris = torch.where(in_seg, stris[torch.clamp(gidx,
                                                      max=pairs_cap - 1)],
                            torch.full_like(gidx, -1)).to(torch.int32)
    overflow = overflow + torch.clamp(count - K, min=0).sum()

    gpos = torch.nonzero(large).reshape(-1)[:Kg]
    glob = torch.full((Kg,), -1, dtype=torch.int32, device=dev)
    glob[:gpos.shape[0]] = tri_ids[gpos]
    overflow = overflow + torch.clamp(large.sum() - Kg, min=0)
    return (cell_tris, torch.clamp(count, max=K).to(torch.int32), glob,
            overflow)


def _cell_voxel_centers(origin, vs, r):
    """World centers of every voxel, grouped per cell: (4096, s^3, 3)."""
    s = r // 16
    ax = origin[None, :] + (torch.arange(r, dtype=torch.float32,
                                         device=origin.device)[:, None]
                            + 0.5) * vs                    # (r, 3)
    wz, wy, wx = ax[:, 2], ax[:, 1], ax[:, 0]
    pts = torch.stack(torch.meshgrid(wz, wy, wx, indexing="ij"),
                      dim=-1).flip(-1)                     # (r, r, r, 3) xyz
    g = pts.reshape(16, s, 16, s, 16, s, 3)                # (cz,lz,cy,ly,cx,lx)
    return g.permute(0, 2, 4, 1, 3, 5, 6).reshape(4096, s ** 3, 3)


def _occupancy_cells(rows, grows, centers, vs):
    """Cell-list occupancy test: (cells, s^3) bool — voxel center within
    the triangle AABB expanded by one voxel, refined by |plane distance|
    <= voxel + half diagonal.  Chunked over cells to bound memory."""
    width = centers.shape[1] * max(rows.shape[1],
                                   0 if grows is None else grows.shape[0])
    chunk = max(1, _WORK_ELEMS // (8 * width))
    def test(rws, p):                               # (c, K, ROW), (c, s3, 3)
        lo = rws[:, None, :, 0:3] - vs
        hi = rws[:, None, :, 3:6] + vs
        q = p[:, :, None, :]
        box = ((q >= lo) & (q <= hi)).all(-1)
        d = dot3(q, rws[:, None, :, 6:9]) - rws[:, None, :, 9]
        near = torch.abs(d) <= (1.8660254 * vs)
        return (box & near).any(-1)                 # (c, s3)

    out = []
    for c0 in range(0, rows.shape[0], chunk):
        p = centers[c0:c0 + chunk]
        occ = test(rows[c0:c0 + chunk], p)
        if grows is not None:
            occ |= test(grows[None].expand((p.shape[0],) + grows.shape), p)
        out.append(occ)
    return torch.cat(out)


def _cells_to_grid(occ_cells, r):
    """(4096, s^3) cell-major -> (R, R, R) voxel grid (z, y, x)."""
    s = r // 16
    g = occ_cells.reshape(16, 16, 16, s, s, s)      # (cz,cy,cx,lz,ly,lx)
    return g.permute(0, 3, 1, 4, 2, 5).reshape(r, r, r)


def _grid_to_cells(grid, r):
    s = r // 16
    g = grid.reshape(16, s, 16, s, 16, s)           # (cz,lz,cy,ly,cx,lx)
    return g.permute(0, 2, 4, 1, 3, 5).reshape(4096, s ** 3)


def esd_map(occ, max_esd: int = 15):
    """Chebyshev empty-space distance via iterated 3-D min-pool."""
    d = torch.where(occ, 0.0, float(max_esd))
    d = _min_pool_iter(d, max_esd - 1)
    return torch.clamp(d.reshape(-1).to(torch.int32), 1, max_esd)


def _texel_unit(bsz, device):
    tex = (torch.arange(bsz, dtype=torch.float32, device=device) + 0.5) / bsz
    tz, ty, txx = torch.meshgrid(tex, tex, tex, indexing="ij")
    return torch.stack([txx, ty, tz], dim=-1).reshape(-1, 3)


def _emit_block(bids, blive, brick_voxel, state: BuildState, origins, vs,
                a, b, c, valid, tri_albedo, tri_emissive, tri_n,
                config: SDFConfig):
    """Emit atlas bricks + shading cache for the brick ids ``bids``."""
    r = config.cascade_resolution
    s = r // 16
    bsz = config.brick_size
    k_tris = config.max_triangles_per_brick
    K = state.cell_tris.shape[-1]
    Kg = state.glob_tris.shape[-1]
    r3 = r ** 3
    block = bids.shape[0]
    dev = bids.device
    nb_off = _nb_offsets(dev)

    bv = brick_voxel[bids]
    n_idx = bv // r3
    rem = bv % r3
    vx, vy, vz = rem % r, (rem // r) % r, rem // (r * r)
    vsz = vs[n_idx.long()]
    org = origins[n_idx.long()]
    vmin = org + torch.stack([vx, vy, vz], -1).float() * vsz[:, None]
    bc = vmin + 0.5 * vsz[:, None]
    trunc_w = config.truncation_voxels * vsz

    # candidate rows: 27-neighbourhood cell lists + the global list
    cxyz = torch.stack([vx // s, vy // s, vz // s], -1)        # (block, 3)
    nb_raw = cxyz[:, None, :] + nb_off[None, :, :]             # (block, 27, 3)
    nb = torch.clamp(nb_raw, 0, 15)
    ncell = (n_idx[:, None] * 4096
             + (nb[..., 2] * 16 + nb[..., 1]) * 16 + nb[..., 0])
    crows = state.cell_rows[ncell.long()].reshape(block, 27 * K, ROW)
    grows = state.glob_rows[n_idx.long()]                      # (block, Kg, ROW)
    cand = torch.cat([crows, grows], dim=1)                    # (block, C, ROW)

    dlo = torch.clamp(cand[..., 0:3] - bc[:, None, :], min=0.0)
    dhi = torch.clamp(bc[:, None, :] - cand[..., 3:6], min=0.0)
    dm = torch.maximum(dlo, dhi)
    d2 = dot3(dm, dm)
    big = torch.full_like(d2, BIG)
    d2 = torch.where(cand[..., 10] >= 0.0, d2, big)
    # dedup by ownership: keep each candidate only in ONE canonical
    # neighbour cell, the clamp of its AABB-center cell into the
    # neighbourhood (global-list candidates are singletons already)
    ctr = 0.5 * (cand[..., 0:3] + cand[..., 3:6])
    ctr_cell = torch.floor(
        (ctr - org[:, None, :]) / (s * vsz)[:, None, None]).to(torch.int32)
    lo_nb = torch.clamp(cxyz[:, None, :] - 1, min=0)
    hi_nb = torch.clamp(cxyz[:, None, :] + 1, max=15)
    canon = torch.minimum(torch.maximum(ctr_cell, lo_nb), hi_nb)
    nb_ok = (nb_raw >= 0).all(-1) & (nb_raw < 16).all(-1)      # (block, 27)
    slot_ok = nb_ok[:, :, None].expand(block, 27, K).reshape(block, 27 * K)
    nb_of_slot = nb[:, :, None, :].expand(block, 27, K, 3).reshape(
        block, 27 * K, 3)
    owner = slot_ok & (canon[:, :27 * K] == nb_of_slot).all(-1)
    owner = torch.cat([owner, torch.ones((block, Kg), dtype=torch.bool,
                                         device=dev)], dim=1)
    d2 = torch.where(owner, d2, big)
    # k nearest with ties to the lower candidate index (lax.top_k's rule):
    # d2 >= 0, so its bit pattern orders like the value; the index rides
    # the low 24 bits and makes every key unique
    keys = (d2.view(torch.int32).to(torch.int64) << 24) \
        | torch.arange(d2.shape[1], device=dev, dtype=torch.int64)
    ki = torch.topk(keys, k_tris, dim=1, largest=False, sorted=True).indices
    knn = torch.gather(cand[..., 10], 1, ki).to(torch.int32)
    knn_ok = torch.gather(d2, 1, ki) < BIG
    # candidates within truncation reach beyond the k nearest are dropped
    # (the SDF overestimates distance there): counted
    n_near = (d2 <= (trunc_w * trunc_w)[:, None]).sum(1)
    near_drop = torch.where(blive, torch.clamp(n_near - k_tris, min=0),
                            torch.zeros_like(n_near))

    texels = vmin[:, None, :] + _texel_unit(bsz, dev)[None] * vsz[:, None, None]
    dmin = torch.full((block, bsz ** 3), BIG, dtype=torch.float32,
                      device=dev)
    for kk in range(k_tris):
        tri = torch.clamp(knn[:, kk], min=0).long()
        ta, tb, tc = a[tri], b[tri], c[tri]
        dk = geometry.point_triangle_distance(
            texels, ta[:, None, :], tb[:, None, :], tc[:, None, :])
        ok = knn_ok[:, kk] & valid[tri]
        dmin = torch.minimum(dmin, torch.where(ok[:, None], dk, BIG))
    d01 = torch.clamp(dmin / trunc_w[:, None], 0.0, 1.0)
    d01 = torch.where(blive[:, None], d01, 1.0)
    if config.atlas_u8:
        d01 = torch.round(d01 * 255.0).to(torch.uint8)
    nearest = torch.clamp(knn[:, 0], min=0).long()
    ok0 = (blive & knn_ok[:, 0])[:, None]
    alb = torch.where(ok0, tri_albedo[nearest], 0.0)
    emi = torch.where(ok0, tri_emissive[nearest], 0.0)
    nrm = torch.where(ok0, tri_n[nearest], 0.0)
    return (d01.reshape(block, bsz, bsz, bsz), alb, emi, nrm,
            near_drop.sum())


def _prep_tris(world_verts, tri_vertices, num_faces, tri_albedo,
               tri_emissive):
    f = tri_vertices.shape[0]
    dev = world_verts.device
    p = world_verts[tri_vertices.long()]
    if tri_albedo is None:
        tri_albedo = torch.full((f, 3), 0.5, dtype=torch.float32, device=dev)
    if tri_emissive is None:
        tri_emissive = torch.zeros((f, 3), dtype=torch.float32, device=dev)
    valid = torch.arange(f, device=dev) < num_faces
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    tri_n = cross(b - a, c - a)
    tri_n = tri_n / torch.clamp(norm3(tri_n), min=1e-20)[:, None]
    return a, b, c, valid, tri_n, tri_albedo, tri_emissive


def _cascade_geometry(config: SDFConfig, centers):
    vs = torch.tensor([config.voxel_size(i)
                       for i in range(config.num_cascades)],
                      dtype=torch.float32, device=centers.device)
    return vs, cascade_origin(centers, vs, config.cascade_resolution)


def build_cascades_binned(world_verts, tri_vertices, num_faces, centers, *,
                          tri_albedo=None, tri_emissive=None,
                          config: SDFConfig):
    """Full cascade build through cell reference lists.  Returns
    (SDFCascades, BuildState)."""
    n_cas = config.num_cascades
    r = config.cascade_resolution
    max_bricks = config.max_bricks
    K = config.cell_list_cap
    Kg = config.global_list_cap
    bsz = config.brick_size
    dev = world_verts.device

    a, b, c, valid, tri_n, tri_albedo, tri_emissive = _prep_tris(
        world_verts, tri_vertices, num_faces, tri_albedo, tri_emissive)
    tri_lo, tri_hi = geometry.tri_aabb(a, b, c)
    table = _tri_table(a, b, c, valid)
    vs, origins = _cascade_geometry(config, centers)

    # -- 1. bin ------------------------------------------------------------
    cell_tris, cell_count, glob_tris, overflow = [], [], [], 0
    for n in range(n_cas):
        ct, cc, gt, ov = _bin_one_cascade(
            tri_lo, tri_hi, valid, origins[n], vs[n], r, K, Kg)
        cell_tris.append(ct)
        cell_count.append(cc)
        glob_tris.append(gt)
        overflow = overflow + ov
    cell_tris = torch.stack(cell_tris)                 # (N, 4096, K)
    cell_count = torch.stack(cell_count)
    glob_tris = torch.stack(glob_tris)                 # (N, Kg)
    cell_rows = _rows_from_lists(cell_tris, table).reshape(
        n_cas * 4096, K, ROW)
    glob_rows = _rows_from_lists(glob_tris, table)     # (N, Kg, ROW)

    # -- 2. occupancy from lists -------------------------------------------
    occ = torch.stack([
        _cells_to_grid(_occupancy_cells(
            cell_rows[n * 4096:(n + 1) * 4096], glob_rows[n],
            _cell_voxel_centers(origins[n], vs[n], r), vs[n]), r)
        for n in range(n_cas)])                        # (N, R, R, R)

    # -- 3. allocation (cumsum compaction) ------------------------------------
    occ_flat = occ.reshape(-1)
    ids = torch.cumsum(occ_flat.to(torch.int64), 0) - 1
    total_occ = occ_flat.sum()
    alloc = occ_flat & (ids < max_bricks)
    num_bricks = torch.clamp(total_occ, max=max_bricks).to(torch.int32)
    brick_overflow = (total_occ - num_bricks).to(torch.int32)
    brick_voxel = torch.zeros((max_bricks,), dtype=torch.int32, device=dev)
    vox_ids = torch.nonzero(alloc).reshape(-1)
    brick_voxel[ids[vox_ids]] = vox_ids.to(torch.int32)
    esd_i = esd_map(occ)
    brick_map = torch.where(alloc, ids.to(torch.int32), -esd_i).reshape(
        n_cas, r, r, r)
    alive = torch.arange(max_bricks, device=dev) < num_bricks

    state = BuildState(cell_tris=cell_tris, cell_count=cell_count,
                       cell_rows=cell_rows, glob_tris=glob_tris,
                       glob_rows=glob_rows, alive=alive,
                       list_overflow=overflow, emit_bricks=alive)

    # -- 4. emit (live blocks only: a dead brick's payload is constant) -----
    n_live = int(num_bricks)
    atlas = torch.full((max_bricks, bsz, bsz, bsz),
                       255 if config.atlas_u8 else 1.0,
                       dtype=torch.uint8 if config.atlas_u8
                       else torch.float32, device=dev)
    albs = torch.zeros((max_bricks, 3), dtype=torch.float32, device=dev)
    emis = torch.zeros_like(albs)
    nrms = torch.zeros_like(albs)
    near_drop = torch.zeros((), dtype=torch.int64, device=dev)
    bids_all = torch.arange(max_bricks, dtype=torch.int64, device=dev)
    # emit in blocks of bricks sized to the candidate count (27 cell lists
    # + the global list per brick); per-brick results do not depend on it
    brick_block = max(1, min(1024, n_live,
                             _WORK_ELEMS // (ROW * (27 * K + Kg))))
    for b0 in range(0, n_live, brick_block):
        bids = bids_all[b0:b0 + brick_block]
        d01, alb, emi, nrm, nd = _emit_block(
            bids, bids < n_live, brick_voxel, state, origins, vs, a, b, c,
            valid, tri_albedo, tri_emissive, tri_n, config)
        sl = slice(b0, b0 + bids.shape[0])
        atlas[sl], albs[sl], emis[sl], nrms[sl] = d01, alb, emi, nrm
        near_drop = near_drop + nd

    mc, mf0, mf1 = build_march_tables(brick_map, atlas, config=config)
    cascades = SDFCascades(
        center=centers, voxel_size=vs, brick_map=brick_map, atlas=atlas,
        brick_voxel=brick_voxel, brick_albedo=albs, brick_emissive=emis,
        brick_normal=nrms,
        brick_irradiance=torch.zeros((max_bricks, 3), dtype=torch.float32,
                                     device=dev),
        brick_light_vis=torch.ones((max_bricks, 1), dtype=torch.float32,
                                   device=dev),
        num_bricks=num_bricks, overflow=brick_overflow,
        march_coarse=mc, march_fine0=mf0, march_fine1=mf1,
        near_drop=near_drop)
    return cascades, state


def _demand_one_cascade(tri_lo, tri_hi, valid, origin, vs, r):
    """Counting half of ``_bin_one_cascade``: exact per-cell reference
    demand (4096,), the large-triangle count, and the pairs truncated."""
    _, cell, j, total, pairs_cap, large = _pair_emission(
        tri_lo, tri_hi, valid, origin, vs, r)
    dead = (j >= total) | (j >= pairs_cap - 1)
    counts = torch.bincount(cell[~dead], minlength=4096)[:4096]
    trunc = torch.clamp(total - (pairs_cap - 1), min=0)
    return counts, large.sum(), trunc


def list_demand(world_verts, tri_vertices, num_faces, centers, *,
                config: SDFConfig):
    """(max per-cell ref demand, max per-cascade large count, truncated
    pairs) over all cascades, as Python ints."""
    a, b, c, valid, _, _, _ = _prep_tris(world_verts, tri_vertices,
                                         num_faces, None, None)
    tri_lo, tri_hi = geometry.tri_aabb(a, b, c)
    vs, origins = _cascade_geometry(config, centers)
    max_cell = max_glob = trunc = 0
    for n in range(config.num_cascades):
        counts, n_large, tr = _demand_one_cascade(
            tri_lo, tri_hi, valid, origins[n], vs[n],
            config.cascade_resolution)
        max_cell = max(max_cell, int(counts.max()))
        max_glob = max(max_glob, int(n_large))
        trunc += int(tr)
    return max_cell, max_glob, trunc


def demand_caps(scene, world_verts, centers, config: SDFConfig
                ) -> SDFConfig:
    """Measure list demand and return a config whose caps cover it
    (64-granular cell cap, 128-granular global cap, bounded by the
    auto-cap ceilings); the same config when the caps already do."""
    mc, mg, tr = list_demand(world_verts, scene.tri_vertices,
                             scene.num_faces, centers, config=config)
    if tr > 0:      # demand pass itself truncated: escalate to ceiling
        mc = _AUTO_CELL_CAP_MAX

    def g64(x, g=64):
        return -(-x // g) * g
    k = min(max(config.cell_list_cap, g64(mc)), _AUTO_CELL_CAP_MAX)
    kg = min(max(config.global_list_cap, g64(mg, 128)), _AUTO_GLOB_CAP_MAX)
    if (k, kg) == (config.cell_list_cap, config.global_list_cap):
        return config
    return dataclasses.replace(config, cell_list_cap=k, global_list_cap=kg)


def _scene_colors(scene):
    mat = scene.instance_material[scene.tri_instance.long()].long()
    return scene.mat_base_color[mat], scene.mat_emissive[mat]


def build_for_scene(scene, world_verts, centers, config: SDFConfig, **kw):
    alb, emi = _scene_colors(scene)
    return build_cascades_binned(world_verts, scene.tri_vertices,
                                 scene.num_faces, centers, tri_albedo=alb,
                                 tri_emissive=emi, config=config, **kw)
