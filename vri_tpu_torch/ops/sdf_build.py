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
     AABB distance feed the exact texel distance pass.  On the card one
     launch of the ``sdf_emit`` kernel (``csrc/sdf_emit.cu``) emits every
     brick, bit-equal to the plain blocks.

``demand_caps`` measures the exact list demand first so production builds
drop no reference.

Because the work is per cell, updates are bounded: ``update_cascades``
re-bins only the cells the dirty instances' boxes touch, re-allocates
bricks through a free-slot pool and re-emits only the bricks within reach
of the changed geometry; ``scroll_cascades`` recenters a cascade by
shifting its maps a whole cell at a time and treats the entering cells,
and the surviving cells beside the moved window edges, as dirty.  Where
the JAX package keeps the first ``cap`` hits of a fixed-size ``nonzero``
and counts the rest, the port takes the hits in the same index order,
keeps as many and counts the rest the same way; a capacity breach makes
``needs_full`` non-zero and the caller rebuilds.
On the card the update is one pipeline of kernels on those fixed
capacities (``csrc/sdf_update.cu``), with no host sync; the plain
version, which the CPU runs, works on live lengths and reads each size
back to the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from vri_tpu_torch.config import SDFConfig
from vri_tpu_torch.ops import geometry
from vri_tpu_torch.ops.geometry import cross, dot3, norm3
from vri_tpu_torch.ops.sdf import (BIG, SDFCascades, _min_pool_iter,
                                   build_march_tables, cascade_origin)
from vri_tpu_torch.runtime import profiler

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


def _cell_span(tri_lo, tri_hi, origins, vs, r, reach_vox: float):
    """Inclusive cell-coordinate span (N, F, 3) of each triangle's AABB
    expanded by ``reach_vox`` voxels, in each cascade of origins (N, 3)
    and voxel sizes (N,)."""
    s = r // 16
    cw = (s * vs)[:, None, None]
    e = (reach_vox * vs)[:, None, None]
    org = origins[:, None, :]
    clo = torch.floor((tri_lo[None] - e - org) / cw).to(torch.int32)
    chi = torch.floor((tri_hi[None] + e - org) / cw).to(torch.int32)
    return clo, chi


def _pairs_cap(f: int, r: int) -> int:
    """The pair stream's length a cascade when binning ``f`` triangles."""
    s_cells = max(r // 16, 1)
    mult = _BIN_PAIRS_MULT * max(1, (1 + 2 // s_cells) ** 2)
    return -(-max(mult * f, 32768) // 1024) * 1024


def _pair_emission(tri_lo, tri_hi, valid, origins, vs, r):
    """Exact segmented (cell, tri) pair emission shared by the binning and
    the demand count, in each of the cascades of origins (N, 3) and voxel
    sizes (N,): (tri_of (N, P), cell (N, P), j (P,), total (N,),
    pairs_cap, large (N, F))."""
    f = tri_lo.shape[0]
    n = origins.shape[0]
    dev = tri_lo.device
    clo, chi = _cell_span(tri_lo, tri_hi, origins, vs, r, 1.0)
    inside = (valid[None] & (chi >= 0).all(-1) & (clo < 16).all(-1))
    clo_c = torch.clamp(clo, 0, 15)
    chi_c = torch.clamp(chi, 0, 15)
    nspan = chi_c - clo_c + 1                              # (N, F, 3) >= 1
    # classify by the UNCLIPPED span (window-independent small/global split)
    small = inside & (chi - clo + 1 <= _BIN_SPAN_CAP).all(-1)
    large = inside & ~small

    ext = torch.where(small, nspan[..., 0] * nspan[..., 1] * nspan[..., 2],
                      torch.zeros_like(nspan[..., 0])).to(torch.int64)
    cum_ext = torch.cumsum(ext, 1)
    total = cum_ext[:, -1]
    pairs_cap = _pairs_cap(f, r)
    j = torch.arange(pairs_cap, dtype=torch.int64, device=dev)
    tri_of = torch.clamp(torch.searchsorted(
        cum_ext, j[None].expand(n, pairs_cap).contiguous(), right=True),
        max=f - 1)
    k_local = j[None] - (torch.gather(cum_ext, 1, tri_of)
                         - torch.gather(ext, 1, tri_of))
    # integer decode of the pair's (dx, dy, dz) within the span (the JAX
    # package uses an exact f32 form; both are exact for live pairs)
    cas = torch.arange(n, device=dev)[:, None]
    span = nspan[cas, tri_of]                              # (N, P, 3)
    nx = torch.clamp(span[..., 0], min=1).to(torch.int64)
    ny = torch.clamp(span[..., 1], min=1).to(torch.int64)
    dx = torch.remainder(k_local, nx)
    t = torch.div(k_local, nx, rounding_mode="floor")
    dy = torch.remainder(t, ny)
    dz = torch.div(t, ny, rounding_mode="floor")
    base_c = clo_c[cas, tri_of].to(torch.int64)
    cell = ((base_c[..., 2] + dz) * 256 + (base_c[..., 1] + dy) * 16
            + (base_c[..., 0] + dx))
    return tri_of, cell, j, total, pairs_cap, large


def _bin_cascades(tri_lo, tri_hi, valid, origins, vs, r, K, Kg,
                  tri_ids=None):
    """Per-cell lists of each cascade of origins (N, 3) and voxel sizes
    (N,): (cell_tris (N, 4096, K), count (N, 4096), glob (N, Kg),
    overflow (N,)).  ``tri_ids`` maps the working set to global triangle
    ids when binning a compacted dirty subset (the incremental update).
    The cascades share one sort, each keyed in a range of its own, so
    every list is the one a cascade's own sort makes."""
    f = tri_lo.shape[0]
    n = origins.shape[0]
    dev = tri_lo.device
    if tri_ids is None:
        tri_ids = torch.arange(f, dtype=torch.int32, device=dev)
    tri_of, cell, j, total, pairs_cap, large = _pair_emission(
        tri_lo, tri_hi, valid, origins, vs, r)
    overflow = torch.clamp(total - pairs_cap, min=0)
    dead = j[None] >= total[:, None]

    # spatial stratum: 2-bit per axis cell-local centroid position of the
    # source triangle — the per-cell tiebreak of the stable sort
    centroid = 0.5 * (tri_lo + tri_hi)
    cellw = (vs * (r // 16))[:, None, None]
    frac = (centroid[None] - origins[:, None, :]) / cellw
    strat3 = torch.clamp(((frac - torch.floor(frac)) * 4.0).to(torch.int32),
                         0, 3).to(torch.int64)
    strat = (strat3[..., 2] << 4) | (strat3[..., 1] << 2) | strat3[..., 0]
    key = (cell << 6) | torch.gather(strat, 1, tri_of)
    key = torch.where(dead, torch.full_like(key, 4096 << 6), key)
    # cascade i sorts in [i << 19, (i + 1) << 19): 4096 << 6 = 1 << 18
    cas = torch.arange(n, dtype=torch.int64, device=dev)
    key = key + (cas[:, None] << 19)
    vals = torch.where(dead, torch.full_like(tri_of, -1),
                       tri_ids[tri_of].to(torch.int64))
    skeys, order = torch.sort(key.reshape(-1), stable=True)
    stris = vals.reshape(-1)[order]

    bounds = ((cas[:, None] << 19)
              + (torch.arange(4097, dtype=torch.int64, device=dev) << 6))
    starts = torch.searchsorted(skeys, bounds.reshape(-1)).reshape(n, 4097)
    count = starts[:, 1:] - starts[:, :-1]                 # (N, 4096)
    k_ids = torch.arange(K, dtype=torch.int64, device=dev)
    gidx = starts[:, :4096, None] + k_ids
    in_seg = k_ids < count[..., None]
    cell_tris = torch.where(in_seg, stris[torch.clamp(
        gidx, max=n * pairs_cap - 1)], torch.full_like(gidx, -1)).to(
        torch.int32)
    overflow = overflow + torch.clamp(count - K, min=0).sum(1)

    # the first Kg large triangles of each cascade, in index order
    rank = torch.cumsum(large.to(torch.int64), 1) - 1
    slot = torch.where(large & (rank < Kg), rank, Kg)
    glob = torch.full((n, Kg + 1), -1, dtype=torch.int32, device=dev)
    glob.scatter_(1, slot, tri_ids[None].expand(n, f).to(torch.int32))
    overflow = overflow + torch.clamp(large.sum(1) - Kg, min=0)
    return (cell_tris, torch.clamp(count, max=K).to(torch.int32),
            glob[:, :Kg].contiguous(), overflow)


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
    <= voxel + half diagonal.  ``vs`` is one voxel size or one per cell,
    ``grows`` one global list (Kg, ROW) or one per cell (cells, Kg, ROW).
    Chunked over cells to bound memory."""
    per_cell = vs.dim() == 1
    width = centers.shape[1] * max(rows.shape[1],
                                   0 if grows is None else grows.shape[-2])
    chunk = max(1, _WORK_ELEMS // (8 * width))

    def test(rws, p, v):                            # (c, K, ROW), (c, s3, 3)
        v4 = v[:, None, None, None] if per_cell else v
        lo = rws[:, None, :, 0:3] - v4
        hi = rws[:, None, :, 3:6] + v4
        q = p[:, :, None, :]
        box = ((q >= lo) & (q <= hi)).all(-1)
        d = dot3(q, rws[:, None, :, 6:9]) - rws[:, None, :, 9]
        near = torch.abs(d) <= (1.8660254 * (v[:, None, None] if per_cell
                                             else v))
        return (box & near).any(-1)                 # (c, s3)

    out = []
    for c0 in range(0, rows.shape[0], chunk):
        p = centers[c0:c0 + chunk]
        v = vs[c0:c0 + chunk] if per_cell else vs
        occ = test(rows[c0:c0 + chunk], p, v)
        if grows is not None:
            g = (grows[c0:c0 + chunk] if grows.dim() == 3
                 else grows[None].expand((p.shape[0],) + grows.shape))
            occ |= test(g, p, v)
        out.append(occ)
    return torch.cat(out) if out else torch.zeros(
        (0, centers.shape[1]), dtype=torch.bool, device=centers.device)


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


def _brick_frame(bids, brick_voxel, origins, vs, config: SDFConfig):
    """Placement of the bricks ``bids``: cascade, voxel (x, y, z), voxel
    size, cascade origin, min corner, center and truncation width."""
    r = config.cascade_resolution
    r3 = r ** 3
    bv = brick_voxel[bids]
    n_idx = bv // r3
    rem = bv % r3
    vxyz = torch.stack([rem % r, (rem // r) % r, rem // (r * r)], -1)
    vsz = vs[n_idx.long()]
    org = origins[n_idx.long()]
    vmin = org + vxyz.float() * vsz[:, None]
    bc = vmin + 0.5 * vsz[:, None]
    return n_idx, vxyz, vsz, org, vmin, bc, config.truncation_voxels * vsz


def _emit_texels(vmin, vsz, trunc_w, knn, knn_ok, blive, a, b, c, valid,
                 tri_albedo, tri_emissive, tri_n, config: SDFConfig):
    """Atlas rows of the bricks with min corners ``vmin`` from the exact
    distance of every texel to their candidate triangles ``knn`` (block,
    K), nearest first, those with ``knn_ok`` false ignored; and the
    nearest candidate's albedo, emissive and normal.  Bricks not
    ``blive`` hold distance 1 and zero shading."""
    bsz = config.brick_size
    dev = vmin.device
    texels = vmin[:, None, :] + _texel_unit(bsz, dev)[None] * vsz[:, None, None]
    dmin = torch.full((vmin.shape[0], bsz ** 3), BIG, dtype=torch.float32,
                      device=dev)
    for kk in range(knn.shape[1]):
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
    return d01.reshape(-1, bsz, bsz, bsz), alb, emi, nrm


def _emit_block(bids, blive, brick_voxel, state: BuildState, origins, vs,
                a, b, c, valid, tri_albedo, tri_emissive, tri_n,
                config: SDFConfig):
    """Emit atlas bricks + shading cache for the brick ids ``bids``."""
    s = config.cascade_resolution // 16
    k_tris = config.max_triangles_per_brick
    K = state.cell_tris.shape[-1]
    Kg = state.glob_tris.shape[-1]
    block = bids.shape[0]
    dev = bids.device
    nb_off = _nb_offsets(dev)
    n_idx, vxyz, vsz, org, vmin, bc, trunc_w = _brick_frame(
        bids, brick_voxel, origins, vs, config)

    # candidate rows: 27-neighbourhood cell lists + the global list
    cxyz = vxyz // s                                           # (block, 3)
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
    return (*_emit_texels(vmin, vsz, trunc_w, knn, knn_ok, blive, a, b, c,
                          valid, tri_albedo, tri_emissive, tri_n, config),
            near_drop.sum())


def _emit_kernel(bids, brick_voxel, state: BuildState, origins, vs, tris,
                 config: SDFConfig):
    """``_emit_bricks`` on the card: one launch of ``sdf_emit``
    (``csrc/sdf_emit.cu``), a block a brick, bit-equal to the blocks of
    :func:`_emit_block`."""
    a, b, c, valid, tri_albedo, tri_emissive, tri_n = tris
    dev = bids.device
    n = bids.shape[0]
    bsz = config.brick_size
    atlas = torch.empty((n, bsz, bsz, bsz), device=dev,
                        dtype=torch.uint8 if config.atlas_u8
                        else torch.float32)
    alb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    emi = torch.empty_like(alb)
    nrm = torch.empty_like(alb)
    near = torch.empty((n,), dtype=torch.int64, device=dev)
    _emit_call(bids.to(torch.int64).contiguous(), n, None, 0,
               brick_voxel, state, origins, vs,
               (torch.stack([a, b, c], 1), valid, tri_albedo, tri_emissive,
                tri_n), config, (atlas, alb, emi, nrm), near)
    return atlas, alb, emi, nrm, near.sum()


def _emit_call(bids, n: int, live_count, count_off: int, brick_voxel,
               state: BuildState, origins, vs, tris, config: SDFConfig,
               rows, near, *, direct: bool = False):
    """One launch of ``sdf_emit`` over the ``n`` entries of ``bids``
    (int64): all of them (``live_count`` None), or those before the device
    count ``live_count`` (int32) less ``count_off``; -1 entries are
    skipped.  ``tris`` is (corners (F, 3, 3), valid, albedo, emissive,
    normal); each brick's atlas row and colours go to ``rows`` (atlas,
    albedo, emissive, normal) at its place in ``bids``, or at its own id
    with ``direct``; ``near`` (n,) gets each entry's near-candidate drops
    (0 where skipped)."""
    from vri_tpu_torch import _cuda

    if not n:
        return
    # the converted inputs stay referenced until the launch is queued
    tri, valid, tri_albedo, tri_emissive, tri_n = (
        x.to(dt).contiguous() for x, dt in zip(
            tris, (torch.float32, torch.uint8, torch.float32, torch.float32,
                   torch.float32)))
    bv = brick_voxel.to(torch.int32).contiguous()
    org = origins.to(torch.float32).contiguous()
    vsc = vs.to(torch.float32).contiguous()
    cell_rows = state.cell_rows.contiguous()
    glob_rows = state.glob_rows.contiguous()
    atlas, alb, emi, nrm = rows
    lib = _cuda.library()
    _cuda.check(lib.vri_sdf_emit(
        bids.data_ptr(), n,
        None if live_count is None else live_count.data_ptr(), count_off,
        int(direct), bv.data_ptr(), org.data_ptr(), vsc.data_ptr(),
        config.cascade_resolution, cell_rows.data_ptr(),
        state.cell_tris.shape[-1], glob_rows.data_ptr(),
        state.glob_tris.shape[-1], tri.data_ptr(), valid.data_ptr(),
        tri_albedo.data_ptr(), tri_emissive.data_ptr(), tri_n.data_ptr(),
        config.brick_size, config.max_triangles_per_brick,
        float(config.truncation_voxels), int(config.atlas_u8),
        atlas.data_ptr(), alb.data_ptr(), emi.data_ptr(), nrm.data_ptr(),
        near.data_ptr(), _cuda.stream_ptr(bids)), "sdf_emit")
    _emit_kernel.launches += 1


_emit_kernel.launches = 0


def _emit_blocks(bids, brick_voxel, state: BuildState, origins, vs, tris,
                 config: SDFConfig):
    """The plain version of the emit on any device: :func:`_emit_block`
    over blocks of ``bids`` sized to the candidate count (27 cell lists +
    the global list per brick); per-brick results do not depend on the
    blocking."""
    K = state.cell_tris.shape[-1]
    Kg = state.glob_tris.shape[-1]
    n = bids.shape[0]
    block = max(1, min(1024, n, _WORK_ELEMS // (ROW * (27 * K + Kg))))
    outs = [_emit_block(bids[b0:b0 + block],
                        torch.ones_like(bids[b0:b0 + block],
                                        dtype=torch.bool),
                        brick_voxel, state, origins, vs, *tris, config)
            for b0 in range(0, n, block)]
    if not outs:
        bsz = config.brick_size
        empty = torch.zeros((0, 3), dtype=torch.float32, device=bids.device)
        return (torch.zeros((0, bsz, bsz, bsz),
                            dtype=torch.uint8 if config.atlas_u8
                            else torch.float32, device=bids.device),
                empty, empty, empty,
                torch.zeros((), dtype=torch.int64, device=bids.device))
    return (*(torch.cat([o[k] for o in outs]) for k in range(4)),
            sum(o[4] for o in outs))


def _emit_bricks(bids, brick_voxel, state: BuildState, origins, vs, tris,
                 config: SDFConfig):
    """Emit the live bricks ``bids`` (1-D): on the card in one launch of
    the ``sdf_emit`` kernel (:func:`_emit_kernel`), on the CPU by the
    plain version (:func:`_emit_blocks`).  ``tris`` is (a, b, c, valid,
    tri_albedo, tri_emissive, tri_n).  Returns (atlas rows, albedo,
    emissive, normal, near_drop).  Span ``sdf.emit``."""
    with profiler.span("sdf.emit"):
        emit = _emit_kernel if bids.is_cuda else _emit_blocks
        return emit(bids, brick_voxel, state, origins, vs, tris, config)


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
        ct, cc, gt, ov = (x[0] for x in _bin_cascades(
            tri_lo, tri_hi, valid, origins[n:n + 1], vs[n:n + 1], r, K, Kg))
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

    # -- 4. emit (live bricks only: a dead brick's payload is constant) -----
    n_live = int(num_bricks)
    atlas = torch.full((max_bricks, bsz, bsz, bsz),
                       255 if config.atlas_u8 else 1.0,
                       dtype=torch.uint8 if config.atlas_u8
                       else torch.float32, device=dev)
    albs = torch.zeros((max_bricks, 3), dtype=torch.float32, device=dev)
    emis = torch.zeros_like(albs)
    nrms = torch.zeros_like(albs)
    bids = torch.arange(n_live, dtype=torch.int64, device=dev)
    (atlas[:n_live], albs[:n_live], emis[:n_live], nrms[:n_live],
     near_drop) = _emit_bricks(bids, brick_voxel, state, origins, vs,
                               (a, b, c, valid, tri_albedo, tri_emissive,
                                tri_n), config)

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
    """Counting half of ``_bin_cascades``: exact per-cell reference
    demand (4096,), the large-triangle count, and the pairs truncated."""
    _, cell, j, total, pairs_cap, large = _pair_emission(
        tri_lo, tri_hi, valid, origin[None], vs.reshape(1), r)
    cell, total = cell[0], total[0]
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


def update_for_scene(cascades, state, scene, world_verts, dirty_tri_mask,
                     dirty_lo, dirty_hi, config: SDFConfig):
    alb, emi = _scene_colors(scene)
    return update_cascades(cascades, state, world_verts, scene.tri_vertices,
                           scene.num_faces, dirty_tri_mask, dirty_lo,
                           dirty_hi, tri_albedo=alb, tri_emissive=emi,
                           config=config)


def scroll_for_scene(cascades, state, scene, world_verts, new_centers,
                     scrolled, config: SDFConfig):
    alb, emi = _scene_colors(scene)
    return scroll_cascades(cascades, state, new_centers, world_verts,
                           scene.tri_vertices, scene.num_faces,
                           tri_albedo=alb, tri_emissive=emi, config=config,
                           scrolled=scrolled)


# ---------------------------------------------------------------------------
# Bounded incremental updates
# ---------------------------------------------------------------------------

def _first(mask: torch.Tensor, cap: int):
    """Indices of the first ``cap`` True entries of a 1-D mask, in index
    order, and how many True entries lie beyond them (the counted part of
    the JAX package's ``nonzero(..., size=cap)``)."""
    pos = torch.nonzero(mask).reshape(-1)
    return pos[:cap], max(pos.shape[0] - cap, 0)


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A copy of ``dst`` with ``dst[idx] = val`` where ``idx`` is in range,
    other indices dropped (the JAX package's ``.at[].set(mode="drop")``),
    without a host sync: out-of-range writes land in a spare row."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    idx = idx.reshape(-1).long()
    if torch.is_tensor(val):
        val = val.reshape((-1,) + tuple(dst.shape[1:]))
    ext[torch.where((idx >= 0) & (idx < n), idx, n)] = val
    return ext[:n]


def _stable_front(lists: torch.Tensor) -> torch.Tensor:
    """Each row's entries >= 0 moved to its front in their order, the -1
    pads behind (the stable sort of the JAX package's list merges)."""
    order = torch.sort((lists < 0).to(torch.uint8), dim=-1,
                       stable=True).indices
    return torch.gather(lists, -1, order)


def _cell_meta(cell_ids, origins, vs, r):
    """Per cell: cascade index, voxel flat ids (C, s^3) and voxel world
    centers (C, s^3, 3); ``cell_ids`` are global (n * 4096 + cell)."""
    s = r // 16
    s3 = s ** 3
    cid = cell_ids.long()
    n = cid // 4096
    rem = cid % 4096
    cz, cy, cx = rem // 256, (rem // 16) % 16, rem % 16
    loc = torch.arange(s3, dtype=torch.int64, device=cid.device)
    lz, ly, lx = loc // (s * s), (loc // s) % s, loc % s
    vx = cx[:, None] * s + lx[None, :]                    # (C, s3)
    vy = cy[:, None] * s + ly[None, :]
    vz = cz[:, None] * s + lz[None, :]
    vox = n[:, None] * (r ** 3) + (vz * r + vy) * r + vx
    vsz = vs[n]                                           # (C,)
    centers = origins[n][:, None, :] + (
        torch.stack([vx, vy, vz], -1).float() + 0.5) * vsz[:, None, None]
    return n, vox, centers


def _apply_dirty_cells(cascades: SDFCascades, state: BuildState, cell_ids,
                       new_tris, new_count, tris, table, origins, vs,
                       config: SDFConfig, dirty_lo=None, dirty_hi=None,
                       axis_name: tuple | None = None,
                       count: str = "sdf_update.bricks"):
    """Shared bounded-update core: install the new lists of ``cell_ids``
    (global cell ids (C,), every one live), diff the cells' occupancy,
    re-allocate bricks through the free-slot pool, re-emit the affected
    bricks and refresh the ESD and the march tables.  ``dirty_lo/hi``
    (D, 3), when given, trim the re-emit set to the voxels within reach
    of the changed geometry.  The re-emitted bricks are counted under
    ``count``.  Returns (cascades, state, emit_overflow).

    The JAX function pads the cells to ``update_cell_cap`` and the emit
    set to ``update_brick_cap``; pad lanes change nothing, so the port
    works on the live cells and emits the live bricks only.

    ``axis_name=(axis, n)`` splits the emit over the ``n`` ranks of the
    mesh axis ``axis`` (:func:`_emit_share`); ``(None, n)`` is the
    single-device measurement proxy, which emits and scatters share 0 of
    ``n`` only."""
    r = config.cascade_resolution
    s3 = (r // 16) ** 3
    max_bricks = config.max_bricks
    n_cas, _, K = state.cell_tris.shape
    cid = cell_ids.long()
    C = cid.shape[0]

    # 1. install the new lists
    rows_new = _rows_from_lists(new_tris, table)          # (C, K, ROW)
    ct = state.cell_tris.reshape(n_cas * 4096, K).clone()
    ct[cid] = new_tris
    cc = state.cell_count.reshape(-1).clone()
    cc[cid] = new_count
    cr = state.cell_rows.clone()
    cr[cid] = rows_new
    state = dataclasses.replace(state, cell_tris=ct.reshape(n_cas, 4096, K),
                                cell_count=cc.reshape(n_cas, 4096),
                                cell_rows=cr)

    # 2. occupancy of the dirty cells (each at its cascade's voxel size)
    n_idx, vox, centers = _cell_meta(cid, origins, vs, r)
    vs_c = vs[n_idx]
    occ_new = _occupancy_cells(rows_new, state.glob_rows[n_idx], centers,
                               vs_c)                      # (C, s3)
    bm_flat = cascades.brick_map.reshape(-1)
    old_ids = bm_flat[vox]                                # (C, s3)
    old_occ = old_ids >= 0

    # 3. allocation diff through the free-slot pool (ascending free ids,
    #    handed out to the new voxels in cell-major order)
    freed = old_occ & ~occ_new
    alive = _set_drop(state.alive, torch.where(freed, old_ids, -1), False)
    new_vox = ~old_occ & occ_new
    free_ids = torch.nonzero(~alive).reshape(-1)
    n_free = free_ids.shape[0]
    order = (torch.cumsum(new_vox.reshape(-1).to(torch.int64), 0)
             - 1).reshape(C, s3)
    slot = torch.full((C, s3), -1, dtype=torch.int64, device=cid.device)
    if n_free:
        slot = torch.where(new_vox & (order < n_free),
                           free_ids[torch.clamp(order, 0, n_free - 1)], slot)
    brick_overflow = torch.clamp(new_vox.sum() - n_free, min=0)
    alive = _set_drop(alive, slot, True)
    brick_voxel = _set_drop(cascades.brick_voxel, slot, vox.to(torch.int32))
    state = dataclasses.replace(state, alive=alive)

    # 4. brick map scatter (freed -> placeholder, new -> slot), then ESD
    new_map_val = torch.where(occ_new, torch.where(old_occ, old_ids.long(),
                                                   slot), -1)
    bm_flat = bm_flat.clone()
    bm_flat[vox.reshape(-1)] = new_map_val.reshape(-1).to(torch.int32)
    occ_grid = (bm_flat >= 0).reshape(cascades.brick_map.shape)
    bm_flat = torch.where(occ_grid.reshape(-1), bm_flat, -esd_map(occ_grid))
    brick_map = bm_flat.reshape(cascades.brick_map.shape)
    num_bricks = alive.sum().to(torch.int32)

    # 5. re-emit every (still or newly) occupied brick of a dirty cell that
    #    lies within reach of the changed geometry: max(truncation, 1.5)
    #    voxels (atlas texels see triangles within the truncation; the
    #    occupancy box reaches 1 voxel past a triangle's AABB from the
    #    voxel center, 1.5 voxels from the voxel's box)
    emit_mask = occ_new
    if dirty_lo is not None:
        e = max(config.truncation_voxels, 1.5) * vs_c      # (C,)
        half = 0.5 * vs_c[:, None, None]
        vlo, vhi = centers - half, centers + half          # (C, s3, 3)
        e4 = e[:, None, None, None]
        near = ((vlo[:, :, None, :] <= dirty_hi[None, None] + e4)
                & (vhi[:, :, None, :] >= dirty_lo[None, None] - e4)
                ).all(-1).any(-1)                          # (C, s3)
        emit_mask = emit_mask & near
    epos, emit_overflow = _first(emit_mask.reshape(-1),
                                 config.update_brick_cap)
    elist = bm_flat[vox.reshape(-1)[epos]].long()
    ebrick = elist[elist >= 0]
    emit_bricks = torch.zeros((max_bricks,), dtype=torch.bool,
                              device=cid.device)
    emit_bricks[ebrick] = True
    state = dataclasses.replace(state, emit_bricks=emit_bricks)

    if axis_name is None:
        blocks, albs, emis, nrms, near_drop = _emit_bricks(
            ebrick, brick_voxel, state, origins, vs, tris, config)
    else:
        ebrick, (blocks, albs, emis, nrms, near_drop) = _emit_share(
            elist, axis_name, brick_voxel, state, origins, vs, tris, config)
    profiler.count(count, ebrick.shape[0])
    atlas = cascades.atlas.clone()
    atlas[ebrick] = blocks
    brick_albedo = cascades.brick_albedo.clone()
    brick_albedo[ebrick] = albs
    brick_emissive = cascades.brick_emissive.clone()
    brick_emissive[ebrick] = emis
    brick_normal = cascades.brick_normal.clone()
    brick_normal[ebrick] = nrms

    mc, mf0, mf1 = build_march_tables(brick_map, atlas, config=config)
    cascades = cascades.replace(
        brick_map=brick_map, brick_voxel=brick_voxel, num_bricks=num_bricks,
        overflow=(cascades.overflow + brick_overflow).to(torch.int32),
        atlas=atlas,
        brick_albedo=brick_albedo, brick_emissive=brick_emissive,
        brick_normal=brick_normal, march_coarse=mc, march_fine0=mf0,
        march_fine1=mf1, near_drop=cascades.near_drop + near_drop)
    return cascades, state, emit_overflow


#: the JAX package's emit block (``update_cascades(brick_block=256)``): its
#: sharded emit splits the padded list in whole blocks
_EMIT_BLOCK = 256


def _emit_share(elist, axis_name, brick_voxel, state, origins, vs, tris,
                config: SDFConfig):
    """The sharded emit of the JAX package (``vri_tpu/ops/sdf_build.py:
    682-715``): of the emit list ``elist`` (the first ``update_brick_cap``
    emit voxels' bricks, in order; < 0 where a voxel got no brick) rank i
    of ``n`` emits entries [i * per, (i + 1) * per), ``per`` being a
    whole number of 256-entry blocks of the padded list, and one
    all_gather (each share padded to ``per``, the pads' ids -1) rebuilds
    the set; ``near_drop`` is summed over the axis.  A brick's emit
    depends on nothing outside it, so the merged rows equal the unsharded
    emit's.  With the live bricks first and the pads last, a small emit
    set lands on the first ranks.  ``(None, n)`` emits share 0 alone (the
    measurement proxy).  Returns (bricks, (rows..., near_drop))."""
    from vri_tpu_torch.parallel import mesh as mesh_mod

    ax, n_shard = axis_name
    nb = -(-config.update_brick_cap // _EMIT_BLOCK)
    if nb % n_shard:
        raise ValueError(f"update_brick_cap blocks {nb} must divide over "
                         f"{n_shard} devices")
    per = nb // n_shard * _EMIT_BLOCK
    i = 0 if ax is None else ax.index
    mine = elist[i * per:(i + 1) * per]
    mine = mine[mine >= 0]
    *rows, near_drop = _emit_bricks(mine, brick_voxel, state, origins, vs,
                                    tris, config)
    if ax is None:
        return mine, (*rows, near_drop)
    bricks, rows = mesh_mod.gather_padded(mine, rows, per, ax)
    return bricks, (*rows, mesh_mod.psum(near_drop, ax))


# ---------------------------------------------------------------------------
# The bounded update on the card: fixed-capacity lists, no host sync
# ---------------------------------------------------------------------------

def _count_update(cells, bricks, *, kernel: bool) -> None:
    """The update's counts under a recording: its dirty cells and
    re-emitted bricks (host numbers or device scalars), and
    ``sdf_update.kernel_path`` once for an update that ran the device
    pipeline."""
    profiler.count("sdf_update.cells", cells)
    profiler.count("sdf_update.bricks", bricks)
    if kernel:
        profiler.count("sdf_update.kernel_path", 1)


#: csrc/sdf_update.cu's UpdateArgs, field by field: "p" a pointer, "l" a
#: long long, "d" a double
_UPDATE_FIELDS = (
    "verts:p tri_vertices:p F:l num_faces_dev:p num_faces_host:l dirty_in:p "
    "center:p vs:p N:l r:l dlo:p dhi:p D:l trunc:d emit_reach:d K:l Kg:l "
    "ucap:l ccap:l bcap:l pairs_cap:l max_bricks:l cell_tris_old:p "
    "glob_old:p bm_old:p tri9:p valid:p dirty:p tri_n:p lo:p hi:p table:p "
    "origins:p cell_tris:p cell_count:p cell_rows:p glob_tris:p "
    "glob_rows:p alive:p brick_voxel:p brick_map:p emit_bricks:p elist:p "
    "elen:l share_lo:l share_hi:l near_out:p n_near:l atlas:p atlas_u8:l "
    "bsz:l surf_thresh:d u8_scale:d march_ok:l march_coarse:p "
    "march_fine0:p march_fine1:p out:p num_bricks:p emit_count:p "
    "scratch:p").split()


class _UpdateArgs(ctypes.Structure):
    """The update pipeline's argument block (``_UPDATE_FIELDS``)."""

    _fields_ = [(f.split(":")[0], {"p": ctypes.c_void_p,
                                   "l": ctypes.c_longlong,
                                   "d": ctypes.c_double}[f.split(":")[1]])
                for f in _UPDATE_FIELDS]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as PyTorch rounds a host scalar it
    combines with a float32 tensor."""
    return ctypes.c_float(x).value


def _update_kernel(cascades: SDFCascades, state: BuildState, world_verts,
                   tri_vertices, num_faces, dirty_tri_mask, dirty_lo,
                   dirty_hi, *, tri_albedo=None, tri_emissive=None,
                   config: SDFConfig, axis_name: tuple | None = None):
    """:func:`update_cascades_reference` on the card, bit-equal to it: the
    lists at the config's capacities (``update_tri_cap``,
    ``update_cell_cap``, ``update_brick_cap``) with live and overflow
    counts on the device, built by the kernels of ``csrc/sdf_update.cu``
    (two C calls around the ``sdf_emit`` launch, no host sync; see the
    source).  The edited state and cascades are clones of the old ones
    written in place (``cell_rows`` included, with no per-cell
    intermediate).  ``axis_name=(axis, n)`` emits rank i's share of the
    emit list, gathered over the axis; ``(None, n)`` emits share 0 alone
    (:func:`_emit_share`).  ``_update_kernel.launches`` counts the
    pipelines."""
    from vri_tpu_torch import _cuda

    n_cas = config.num_cascades
    r = config.cascade_resolution
    K = config.cell_list_cap
    Kg = config.global_list_cap
    bsz = config.brick_size
    max_bricks = config.max_bricks
    bcap = config.update_brick_cap
    dev = world_verts.device
    f = tri_vertices.shape[0]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def fresh(x, dtype):
        return x.to(dtype=dtype, memory_format=torch.contiguous_format,
                    copy=True)

    if tri_albedo is None:
        tri_albedo = torch.full((f, 3), 0.5, dtype=torch.float32, device=dev)
    if tri_emissive is None:
        tri_emissive = torch.zeros((f, 3), dtype=torch.float32, device=dev)
    ins = dict(
        verts=world_verts.to(torch.float32).contiguous(),
        tri_vertices=tri_vertices.to(torch.int32).contiguous(),
        dirty_in=dirty_tri_mask.to(torch.bool).contiguous(),
        center=cascades.center.to(torch.float32).contiguous(),
        vs=cascades.voxel_size.to(torch.float32).contiguous(),
        dlo=dirty_lo.to(torch.float32).contiguous(),
        dhi=dirty_hi.to(torch.float32).contiguous(),
        cell_tris_old=state.cell_tris.to(torch.int32).contiguous(),
        glob_old=state.glob_tris.to(torch.int32).contiguous(),
        bm_old=cascades.brick_map.to(torch.int32).contiguous())
    nf_dev = (num_faces.to(device=dev, dtype=torch.int32)
              if torch.is_tensor(num_faces) else None)
    elen = -(-bcap // _EMIT_BLOCK) * _EMIT_BLOCK
    if axis_name is None:
        ax, lo, per = None, 0, bcap
    else:
        ax, n_shard = axis_name
        nb = -(-bcap // _EMIT_BLOCK)
        if nb % n_shard:
            raise ValueError(f"update_brick_cap blocks {nb} must divide "
                             f"over {n_shard} devices")
        per = nb // n_shard * _EMIT_BLOCK
        lo = (0 if ax is None else ax.index) * per
    outs = dict(
        tri9=empty(f, 3, 3), valid=empty(f, dtype=torch.bool),
        dirty=empty(f, dtype=torch.bool), tri_n=empty(f, 3), lo=empty(f, 3),
        hi=empty(f, 3), table=empty(f, ROW), origins=empty(n_cas, 3),
        cell_tris=fresh(state.cell_tris, torch.int32),
        cell_count=fresh(state.cell_count, torch.int32),
        cell_rows=fresh(state.cell_rows, torch.float32),
        glob_tris=empty(n_cas, Kg, dtype=torch.int32),
        glob_rows=empty(n_cas, Kg, ROW),
        alive=fresh(state.alive, torch.bool),
        brick_voxel=fresh(cascades.brick_voxel, torch.int32),
        brick_map=fresh(cascades.brick_map, torch.int32),
        emit_bricks=empty(max_bricks, dtype=torch.bool),
        elist=empty(elen, dtype=torch.int64),
        near_out=empty(per, dtype=torch.int64),
        atlas=cascades.atlas.clone(memory_format=torch.contiguous_format),
        march_coarse=empty(n_cas * 4, 128, dtype=torch.int32),
        march_fine0=empty(n_cas * 32, 128, dtype=torch.int32),
        march_fine1=empty(n_cas * 32, 128, dtype=torch.int32),
        out=empty(6, dtype=torch.int64),
        num_bricks=empty(dtype=torch.int32),
        emit_count=empty(1, dtype=torch.int32))
    colors = {k: fresh(getattr(cascades, k), torch.float32)
              for k in ("brick_albedo", "brick_emissive", "brick_normal")}
    sc = r // 16
    args = _UpdateArgs(
        F=f, num_faces_host=0 if nf_dev is not None else int(num_faces),
        num_faces_dev=None if nf_dev is None else nf_dev.data_ptr(),
        N=n_cas, r=r, D=dirty_lo.shape[0],
        trunc=_f32(config.truncation_voxels),
        emit_reach=_f32(max(config.truncation_voxels, 1.5)), K=K, Kg=Kg,
        ucap=config.update_tri_cap, ccap=config.update_cell_cap, bcap=bcap,
        pairs_cap=_pairs_cap(config.update_tri_cap, r),
        max_bricks=max_bricks, elen=elen, share_lo=lo, share_hi=lo + per,
        n_near=per, atlas_u8=int(config.atlas_u8), bsz=bsz,
        surf_thresh=_f32(1.5 / (config.truncation_voxels * bsz)),
        u8_scale=_f32(1.0 / 255.0),
        march_ok=int(r % 16 == 0 and sc in (1, 2, 4)))
    for name, t in (*ins.items(), *outs.items()):
        setattr(args, name, t.data_ptr())
    lib = _cuda.library()
    if lib.vri_sdf_update_args_size() != ctypes.sizeof(args):
        raise RuntimeError("sdf_update: the argument block's layout differs "
                           "from csrc/sdf_update.cu's")
    nbytes = lib.vri_sdf_update_scratch(ctypes.addressof(args))
    if nbytes < 0:
        raise ValueError("sdf_update: the update's scratch passes 2 GB")
    scratch = empty(nbytes, dtype=torch.uint8)
    args.scratch = scratch.data_ptr()
    stream = _cuda.stream_ptr(world_verts)
    _cuda.check(lib.vri_sdf_update_lists(ctypes.addressof(args), stream),
                "sdf_update (lists)")
    _update_kernel.launches += 1

    # the emit: straight into the cascades' rows, or rank i's share
    # gathered over the axis and scattered
    state = dataclasses.replace(
        state, cell_tris=outs["cell_tris"].reshape(n_cas, 4096, K),
        cell_count=outs["cell_count"].reshape(n_cas, 4096),
        cell_rows=outs["cell_rows"], glob_tris=outs["glob_tris"],
        glob_rows=outs["glob_rows"], alive=outs["alive"],
        emit_bricks=outs["emit_bricks"])
    tris = (outs["tri9"], outs["valid"], tri_albedo, tri_emissive,
            outs["tri_n"])
    atlas = outs["atlas"]
    rows = (atlas, colors["brick_albedo"], colors["brick_emissive"],
            colors["brick_normal"])
    mine = outs["elist"][lo:lo + per]
    bricks = outs["out"][5]
    if ax is None:
        _emit_call(mine, per, outs["emit_count"], lo, outs["brick_voxel"],
                   state, outs["origins"], ins["vs"], tris, config, rows,
                   outs["near_out"], direct=True)
    else:
        from vri_tpu_torch.parallel import mesh as mesh_mod

        share = (empty(per, bsz, bsz, bsz, dtype=atlas.dtype),
                 empty(per, 3), empty(per, 3), empty(per, 3))
        _emit_call(mine, per, outs["emit_count"], lo, outs["brick_voxel"],
                   state, outs["origins"], ins["vs"], tris, config, share,
                   outs["near_out"])
        ids, got = mesh_mod.gather_padded(mine, share, per, ax)
        for dst, src in zip(rows, got):
            dst[ids] = src
        bricks = ids.shape[0]
    _cuda.check(lib.vri_sdf_update_finish(ctypes.addressof(args), stream),
                "sdf_update (finish)")
    out = outs["out"]
    near = out[1] if ax is None else mesh_mod.psum(out[1].clone(), ax)
    _count_update(out[4], bricks, kernel=True)
    cascades = cascades.replace(
        brick_map=outs["brick_map"].reshape(cascades.brick_map.shape),
        brick_voxel=outs["brick_voxel"], num_bricks=outs["num_bricks"],
        overflow=(cascades.overflow + out[2]).to(torch.int32), atlas=atlas,
        **colors, march_coarse=outs["march_coarse"],
        march_fine0=outs["march_fine0"], march_fine1=outs["march_fine1"],
        near_drop=cascades.near_drop + near)
    state = dataclasses.replace(
        state, list_overflow=state.list_overflow + out[3])
    return cascades, state, out[0]


_update_kernel.launches = 0


def update_cascades(cascades: SDFCascades, state: BuildState, world_verts,
                    tri_vertices, num_faces, dirty_tri_mask, dirty_lo,
                    dirty_hi, *, tri_albedo=None, tri_emissive=None,
                    config: SDFConfig, axis_name: tuple | None = None):
    """Bounded incremental cascade update: on the card the device pipeline
    (:func:`_update_kernel`, ``csrc/sdf_update.cu``, no host sync), on the
    CPU the plain version (:func:`update_cascades_reference`), bit-equal to
    each other.

    ``dirty_tri_mask`` (F,) marks the triangles whose data changed;
    ``dirty_lo/hi`` (D, 3) are world AABBs covering all changed geometry
    at its old and new positions (unused rows +BIG/-BIG).  Returns
    (cascades, state, needs_full); a non-zero ``needs_full`` (a device
    scalar) counts capacity breaches and the caller must rebuild.  See
    :func:`update_cascades_reference`."""
    update = (_update_kernel if world_verts.is_cuda
              else update_cascades_reference)
    return update(cascades, state, world_verts, tri_vertices, num_faces,
                  dirty_tri_mask, dirty_lo, dirty_hi, tri_albedo=tri_albedo,
                  tri_emissive=tri_emissive, config=config,
                  axis_name=axis_name)


def update_cascades_reference(cascades: SDFCascades, state: BuildState,
                              world_verts, tri_vertices, num_faces,
                              dirty_tri_mask, dirty_lo, dirty_hi, *,
                              tri_albedo=None, tri_emissive=None,
                              config: SDFConfig,
                              axis_name: tuple | None = None):
    """Bounded incremental cascade update, the plain version on any device
    (live lengths, a host sync a dynamic shape).

    ``dirty_tri_mask`` (F,) marks the triangles whose data changed;
    ``dirty_lo/hi`` (D, 3) are world AABBs covering all changed geometry
    at its old and new positions (unused rows +BIG/-BIG).  The work
    scales with the dirty region, not the stage.  Returns (cascades,
    state, needs_full): a non-zero ``needs_full`` counts capacity
    breaches (dirty triangles past ``update_tri_cap``, dirty cells past
    ``update_cell_cap``, re-binned or global references dropped, bricks to
    emit past ``update_brick_cap``) and the caller must rebuild with
    ``build_cascades_binned``.  A merged cell list longer than K keeps K
    and counts the rest in ``list_overflow``, as a full build does.
    ``axis_name=(axis, n)`` splits the re-emit over a mesh axis, every
    rank deriving the same lists and allocation (``(None, n)``: the
    one-device proxy of one rank's share; see :func:`_apply_dirty_cells`)."""
    n_cas = config.num_cascades
    r = config.cascade_resolution
    K = config.cell_list_cap
    Kg = config.global_list_cap
    ucap = config.update_tri_cap
    dev = world_verts.device

    a, b, c, valid, tri_n, tri_albedo, tri_emissive = _prep_tris(
        world_verts, tri_vertices, num_faces, tri_albedo, tri_emissive)
    tri_lo, tri_hi = geometry.tri_aabb(a, b, c)
    table = _tri_table(a, b, c, valid)
    vs = cascades.voxel_size
    origins = cascade_origin(cascades.center, vs, r)

    dirty = dirty_tri_mask & valid
    # the dirty triangle set, padded to update_tri_cap as the JAX package
    # pads it (the re-bin's pair capacity derives from that size)
    dpos, needs_full = _first(dirty, ucap)
    n_d = dpos.shape[0]
    dsafe = torch.zeros((ucap,), dtype=torch.int64, device=dev)
    dsafe[:n_d] = dpos
    dvalid = torch.arange(ucap, device=dev) < n_d
    d_ids = torch.where(dvalid, dsafe, -1).to(torch.int32)
    dlo, dhi = tri_lo[dsafe], tri_hi[dsafe]

    # dirty cells: the cells each (expanded) dirty box overlaps, in every
    # cascade at once
    cw = vs * (r // 16)
    ar = torch.arange(16, dtype=torch.float32, device=dev)
    e = (config.truncation_voxels * vs + vs)[:, None, None]
    ax = origins[:, None, :] + ar[None, :, None] * cw[:, None, None]

    def ov(k):                                              # (N, 16, D)
        return ((ax[:, :, k][:, :, None] <= dirty_hi[None, None, :, k] + e)
                & ((ax[:, :, k] + cw[:, None])[:, :, None]
                   >= dirty_lo[None, None, :, k] - e))
    mx, my, mz = ov(0), ov(1), ov(2)
    m = (mz[:, :, None, None, :] & my[:, None, :, None, :]
         & mx[:, None, None, :, :]).any(-1)                 # (N,16,16,16) zyx
    cell_ids, over = _first(m.reshape(-1), config.update_cell_cap)
    needs_full += over
    profiler.count("sdf_update.cells", cell_ids.shape[0])
    cid = cell_ids.long()

    # fresh bin of the dirty subset, and the global lists merged in place
    # (a moved global triangle only affects cells inside the dirty region)
    add_tris, _, gt, rebin_ov = _bin_cascades(
        dlo, dhi, dvalid, origins, vs, r, K, Kg, tri_ids=d_ids)
    # a reference dropped at the re-bin's capacity would vanish from the
    # merged lists: escalate
    needs_full = torch.as_tensor(needs_full, device=dev) + rebin_ov.sum()
    add_tris = add_tris.reshape(n_cas * 4096, K)
    old_g = state.glob_tris
    old_g = torch.where((old_g >= 0)
                        & ~dirty[torch.clamp(old_g, min=0).long()], old_g, -1)
    gm = torch.cat([old_g, gt], 1)                           # (N, 2 Kg)
    needs_full = needs_full + torch.clamp((gm >= 0).sum(1) - Kg,
                                          min=0).sum()
    glob_tris = _stable_front(gm)[:, :Kg]
    state = dataclasses.replace(state, glob_tris=glob_tris,
                                glob_rows=_rows_from_lists(glob_tris, table))

    # merge per dirty cell: (old minus dirty) ++ new, compacted to K
    old = state.cell_tris.reshape(n_cas * 4096, K)[cid]   # (C, K)
    keep = (old >= 0) & ~dirty[torch.clamp(old, min=0).long()]
    merged = torch.cat([torch.where(keep, old, -1), add_tris[cid]], dim=1)
    new_tris = _stable_front(merged)[:, :K].contiguous()
    new_count = (merged >= 0).sum(1)
    state = dataclasses.replace(
        state, list_overflow=state.list_overflow
        + torch.clamp(new_count - K, min=0).sum())
    new_count = torch.clamp(new_count, max=K).to(torch.int32)

    cascades, state, emit_overflow = _apply_dirty_cells(
        cascades, state, cid, new_tris, new_count,
        (a, b, c, valid, tri_albedo, tri_emissive, tri_n), table, origins,
        vs, config, dirty_lo=dirty_lo, dirty_hi=dirty_hi,
        axis_name=axis_name)
    return cascades, state, needs_full + emit_overflow


def _roll3(grid, d, fill):
    """Shift a volume whose leading axes are (z, y, x) so that new[z, y, x]
    = old[z + dz, y + dy, x + dx], filling the entries that come from
    outside; ``d`` is (dx, dy, dz) host ints.  Returns (shifted, entering
    (R, R, R) bool)."""
    r = grid.shape[0]

    def span(k):                       # (destination, source) slices
        k = max(-r, min(r, k))
        return ((slice(0, r - k), slice(k, r)) if k >= 0
                else (slice(-k, r), slice(0, r + k)))
    (zd, zs), (yd, ys), (xd, xs) = span(d[2]), span(d[1]), span(d[0])
    out = torch.full_like(grid, fill)
    out[zd, yd, xd] = grid[zs, ys, xs]
    entering = torch.ones((r, r, r), dtype=torch.bool, device=grid.device)
    entering[zd, yd, xd] = False
    return out, entering


def _edge_cells(dc, device) -> torch.Tensor:
    """(16, 16, 16) bool (z, y, x): the surviving cells of a window shifted
    by ``dc`` cells (xyz) within one cell of a cell position that entered
    or left it.  A brick's emit reads the lists of its cell's 27
    neighbours that lie in the window, so a fresh build at the new window
    emits these cells' bricks from other candidates than they were
    emitted from: the layer behind the entering cells and the new edge
    facing the cells that left.  No cell for an unshifted window."""
    ar = torch.arange(-1, 17, device=device)
    z, y, x = torch.meshgrid(ar, ar, ar, indexing="ij")

    def inside(ox, oy, oz):
        return ((x + ox >= 0) & (x + ox < 16) & (y + oy >= 0)
                & (y + oy < 16) & (z + oz >= 0) & (z + oz < 16))
    kept = inside(*dc)
    moved = (inside(0, 0, 0) != kept).float()[None, None]
    near = F.max_pool3d(moved, 3, stride=1)[0, 0] > 0
    return near & kept[1:17, 1:17, 1:17]


def scroll_cascades(cascades: SDFCascades, state: BuildState, new_centers,
                    world_verts, tri_vertices, num_faces, *, tri_albedo=None,
                    tri_emissive=None, config: SDFConfig, scrolled: tuple):
    """Clipmap scroll: recenter the cascades flagged in ``scrolled``
    reusing every surviving brick.  ``new_centers`` must be snapped to
    whole cells (s voxels) per cascade.  Surviving bricks keep their atlas
    content (world voxel positions are absolute, only the map window
    moves); the entering slab re-bins and re-emits, and so do the
    surviving cells beside each moved edge (:func:`_edge_cells`), whose
    bricks were emitted from the old window's candidates: the JAX
    package's scroll re-emits the entering slab only, and its cascades
    then differ from a fresh build at the new centers there.  Under a
    recording it counts the entering cells (``sdf_scroll.cells``) and the
    bricks it emits (``sdf_scroll.bricks``).  Returns (cascades, state,
    needs_full)."""
    n_cas = config.num_cascades
    r = config.cascade_resolution
    s = r // 16
    r3 = r ** 3
    K = config.cell_list_cap
    Kg = config.global_list_cap
    dev = world_verts.device

    a, b, c, valid, tri_n, tri_albedo, tri_emissive = _prep_tris(
        world_verts, tri_vertices, num_faces, tri_albedo, tri_emissive)
    tri_lo, tri_hi = geometry.tri_aabb(a, b, c)
    table = _tri_table(a, b, c, valid)
    vs = cascades.voxel_size
    new_origins = cascade_origin(new_centers, vs, r)
    old_origins = cascade_origin(cascades.center, vs, r)
    # whole-voxel shifts (xyz); snapping makes them multiples of s
    dvox = torch.round((new_origins - old_origins) / vs[:, None]).to(
        torch.int32).tolist()

    brick_map = cascades.brick_map.clone()
    alive = state.alive
    brick_voxel = cascades.brick_voxel
    cell_tris = state.cell_tris.clone()
    cell_count = state.cell_count.clone()
    cell_rows = state.cell_rows.reshape(n_cas, 4096, K, ROW).clone()
    dirty = torch.zeros((n_cas, 4096), dtype=torch.bool, device=dev)
    n_entering = 0
    needs_full = torch.zeros((), dtype=torch.int64, device=dev)
    for n in range(n_cas):
        if not scrolled[n]:
            continue
        d = dvox[n]
        # free the bricks whose voxels scroll out; shift the survivors'
        bn = brick_voxel // r3 == n
        rem = brick_voxel % r3
        nz = rem // (r * r) - d[2]
        ny = (rem // r) % r - d[1]
        nx = rem % r - d[0]
        in_r = ((nz >= 0) & (nz < r) & (ny >= 0) & (ny < r)
                & (nx >= 0) & (nx < r))
        keep = bn & alive & in_r
        alive = alive & ~(bn & alive & ~in_r)
        new_bv = n * r3 + (torch.clamp(nz, 0, r - 1) * r
                           + torch.clamp(ny, 0, r - 1)) * r \
            + torch.clamp(nx, 0, r - 1)
        brick_voxel = torch.where(keep, new_bv, brick_voxel)
        brick_map[n] = _roll3(brick_map[n], d, -1)[0]
        # the cell tables shift by d / s cells
        dc = [k // s for k in d]
        ct3, ent = _roll3(cell_tris[n].reshape(16, 16, 16, K), dc, -1)
        cell_tris[n] = ct3.reshape(4096, K)
        cell_count[n] = _roll3(cell_count[n].reshape(16, 16, 16), dc,
                               0)[0].reshape(4096)
        cell_rows[n] = _roll3(cell_rows[n].reshape(16, 16, 16, K, ROW), dc,
                              0.0)[0].reshape(4096, K, ROW)
        dirty[n] = (ent | _edge_cells(dc, dev)).reshape(4096)
        n_entering += 4096 - math.prod(16 - min(abs(k), 16) for k in dc)

    state = dataclasses.replace(
        state, cell_tris=cell_tris, cell_count=cell_count,
        cell_rows=cell_rows.reshape(n_cas * 4096, K, ROW), alive=alive)
    cascades = cascades.replace(center=new_centers, brick_map=brick_map,
                                brick_voxel=brick_voxel)

    # a fresh bin at the new origin gives the dirty cells' lists and the
    # global lists of each scrolled cascade
    glob_tris = state.glob_tris.clone()
    fresh = {}
    list_overflow = state.list_overflow
    for n in range(n_cas):
        if not scrolled[n]:
            continue
        ct, cnt, gt, ov = (x[0] for x in _bin_cascades(
            tri_lo, tri_hi, valid, new_origins[n:n + 1], vs[n:n + 1], r, K,
            Kg))
        fresh[n] = (ct, cnt)
        glob_tris[n] = gt
        list_overflow = list_overflow + ov
        needs_full = needs_full + ov    # references dropped on a scrolled bin
    state = dataclasses.replace(
        state, glob_tris=glob_tris, list_overflow=list_overflow,
        glob_rows=_rows_from_lists(glob_tris, table))

    cell_ids, over = _first(dirty.reshape(-1), config.update_cell_cap)
    needs_full = needs_full + over
    profiler.count("sdf_scroll.cells", n_entering)
    cid = cell_ids.long()
    new_tris = torch.full((cid.shape[0], K), -1, dtype=torch.int32,
                          device=dev)
    new_count = torch.zeros((cid.shape[0],), dtype=torch.int32, device=dev)
    for n, (ct, cnt) in fresh.items():
        in_n = cid // 4096 == n
        new_tris[in_n] = ct[cid[in_n] % 4096]
        new_count[in_n] = cnt[cid[in_n] % 4096]

    cascades, state, emit_overflow = _apply_dirty_cells(
        cascades, state, cid, new_tris, new_count,
        (a, b, c, valid, tri_albedo, tri_emissive, tri_n), table,
        new_origins, vs, config, count="sdf_scroll.bricks")
    return cascades, state, needs_full + emit_overflow

