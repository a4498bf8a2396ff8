"""Tiled visibility raster (counterpart of ``vri_tpu/ops/rasterize.py``):
three tiers that share the triangle setup, the per-slot table and the
per-(pixel, slot) math, and differ in how each tile finds its candidate
slots.

* :func:`rasterize_sorted` -- exact emission: every visible slot emits
  one (tile, slot) pair per 8x128 tile its screen bbox covers, in slot
  order (``pairs_cap`` bounds the stream); one stable sort on the tile
  key turns the stream into per-tile lists (``_segment_lists``), walked
  to ``cap`` each.  Near-plane second slots are compacted into a counted
  ``extra_cap``.  On the card this prep is one pipeline of CUDA kernels
  (:func:`raster_prep`, ``csrc/raster_prep.cu``) that never syncs with
  the host.
* :func:`rasterize_binned` -- slots in screen-Morton order packed in
  groups of 8; each tile lists the first ``cap_groups`` groups whose bbox
  overlaps it (``_bin_groups``), sorted back to setup order.
* :func:`rasterize` -- the capacity-free ranged tier: slots in
  screen-Morton order packed in chunks of 128; each tile walks the global
  (screen-spanning) chunks and its own Morton chunk range, skipping a
  chunk whose overlap bit is clear, and tests of a chunk only the slots
  that the sorted tier lists for the tile (``_tile_span``).  Nothing can
  overflow: it is the last rung of the renderer's overflow ladder.

The sorted and binned lists go to kernel R (``raster_tiles``,
``csrc/raster_tiles.cu``), the ranged tier to ``raster_ranged``
(``csrc/raster_ranged.cu``).  Both kernels evaluate a pixel against a
slot with the same device functions (``csrc/raster_common.cuh``) and take
the minimum of (depth with 7 low mantissa bits cleared, slot index in
setup order), and every tier numbers first slots before second slots in
source order, so the three tiers give the same winner triangle, depth
and (u, v) at every pixel whenever none of them overflows.  The winner's
perspective-correct source barycentrics (u, v) come from the slot's
rational-affine fields (un, vn, den) -- the JAX package's fused resolve.

The TPU-only layers of the JAX tiers -- the bf16 cascade split of the
edge coefficients, the packed work-list words, the grouped-tile packing,
the statically unrolled binned subs -- have no counterpart: the kernels
evaluate every field in scalar FP32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vri_tpu_torch import _cuda
from vri_tpu_torch.ops.intersect import HitRecord

_BIG = 3.0e38
_MISS_KEY = 0x40000000           # bit pattern of 2.0f: the key of a miss
_NCOEF = 24                      # see slot_coefficients
_TC = 128                        # slot padding quantum and ranged chunk
_NEVER = torch.iinfo(torch.int64).max


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 truncation with the argument held inside +-2^30, so
    near-plane-exploded coordinates convert the same on every device."""
    return torch.clamp(x, -(2.0 ** 30), 2.0 ** 30).to(torch.int32)


def triangle_setup_clipped(world_verts: torch.Tensor,
                           tri_vertices: torch.Tensor, num_faces,
                           view_proj: torch.Tensor, height: int, width: int,
                           w_eps: float = 1e-4, extra_cap: int | None = None,
                           cull_sign: torch.Tensor | None = None,
                           src_map: torch.Tensor | None = None,
                           face_mask: torch.Tensor | None = None,
                           y_offset=None):
    """Near-plane-clipped triangle setup (vectorized Sutherland-Hodgman
    against w = eps).  Each output corner carries its source-triangle
    barycentrics so hits map back to the authored triangle.  ``src_map``
    (frustum-compacted rasterization) gives each of the F faces here its
    face id in the scene's pool.  ``face_mask`` (F,) bool keeps only the
    faces it marks (the LOD selection, ``ops/lod.py``): a masked face is
    not live.  ``y_offset`` (band rendering) is subtracted from the
    pixel-space y after the projection with the whole frame's ``height``,
    so the slots come out in the band's own rows.

    Returns (tx, ty, tz, inv_w, bary1, bary2, src_id, valid,
    clip_overflow); the per-corner arrays are (S, 3) with S = F + E slots
    (E = ``extra_cap`` compacted second slots, or F when None: second
    slot i at F + i)."""
    f = tri_vertices.shape[0]
    dev = world_verts.device
    v = world_verts
    m = view_proj
    # [v, 1] @ view_proj.T written out as per-column products
    clip = (v[:, 0:1] * m[:, 0] + v[:, 1:2] * m[:, 1]
            + v[:, 2:3] * m[:, 2] + m[:, 3])
    c = clip[tri_vertices.long()]                  # (F, 3, 4)

    w = c[..., 3]
    inside = w > w_eps
    n_in = inside.sum(1)
    idx_in = torch.argmax(inside.to(torch.int8), dim=1)     # first inside
    idx_out = torch.argmax((~inside).to(torch.int8), dim=1)  # first outside
    rot = torch.where(n_in == 1, idx_in,
                      torch.where(n_in == 2, (idx_out + 1) % 3,
                                  torch.zeros_like(idx_in)))
    sel = rot[:, None, None]
    cr = torch.where(sel == 1, torch.roll(c, -1, dims=1),
                     torch.where(sel == 2, torch.roll(c, -2, dims=1), c))
    # rotated corner k is source vertex (k + rot) % 3, whose barycentrics
    # are (0, 0), (1, 0), (0, 1) (no host table copied to the device)
    src_v = (torch.arange(3, device=dev) + rot[:, None]) % 3
    br = torch.stack([src_v == 1, src_v == 2], dim=-1).to(torch.float32)
    wr = cr[..., 3]

    def lerp_to_plane(pa, pb, wa, wb):
        dw = wb - wa
        t = (w_eps - wa) / torch.where(torch.abs(dw) > 1e-20, dw,
                                       torch.ones_like(dw))
        t = torch.clamp(t, 0.0, 1.0)[..., None]
        return pa + (pb - pa) * t

    A, B, C = cr[:, 0], cr[:, 1], cr[:, 2]
    wA, wB, wC = wr[:, 0], wr[:, 1], wr[:, 2]
    posb_A = torch.cat([A, br[:, 0]], -1)
    posb_B = torch.cat([B, br[:, 1]], -1)
    posb_C = torch.cat([C, br[:, 2]], -1)
    P_ab = lerp_to_plane(posb_A, posb_B, wA, wB)
    P_ac = lerp_to_plane(posb_A, posb_C, wA, wC)
    P_bc = lerp_to_plane(posb_B, posb_C, wB, wC)

    full = torch.stack([posb_A, posb_B, posb_C], dim=1)      # n_in == 3
    one_in = torch.stack([posb_A, P_ab, P_ac], dim=1)        # n_in == 1
    two_in_1 = torch.stack([posb_A, posb_B, P_bc], dim=1)    # n_in == 2
    two_in_2 = torch.stack([posb_A, P_bc, P_ac], dim=1)
    sel = n_in[:, None, None]
    out1 = torch.where(sel == 3, full,
                       torch.where(sel == 2, two_in_1,
                                   torch.where(sel == 1, one_in, full)))
    valid1 = n_in >= 1
    valid2 = n_in == 2

    in_range = torch.arange(f, device=dev) < num_faces
    if face_mask is not None:
        in_range &= face_mask
    if cull_sign is not None:
        # backface culling from the homogeneous [x y w] determinant (the
        # orientation as seen, valid on both sides of the near plane)
        cw = c[..., 3]
        cx, cy = c[..., 0], c[..., 1]
        dhom = (cx[:, 0] * (cy[:, 1] * cw[:, 2] - cy[:, 2] * cw[:, 1])
                - cy[:, 0] * (cx[:, 1] * cw[:, 2] - cx[:, 2] * cw[:, 1])
                + cw[:, 0] * (cx[:, 1] * cy[:, 2] - cx[:, 2] * cy[:, 1]))
        in_range &= (cull_sign == 0.0) | (dhom * cull_sign > 0.0)
    ids = (torch.arange(f, dtype=torch.int32, device=dev) if src_map is None
           else src_map.to(torch.int32))
    if extra_cap is None:
        tri6 = torch.cat([out1, two_in_2], dim=0)
        valid = torch.cat([valid1 & in_range, valid2 & in_range])
        src_id = torch.cat([ids, ids])
        clip_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        # second clipped triangles (near-plane crossers are rare) compact
        # into a small counted capacity
        live2 = valid2 & in_range
        pos2 = torch.nonzero(live2).reshape(-1)[:extra_cap]
        idx2 = torch.full((extra_cap,), f, dtype=torch.int64, device=dev)
        idx2[:pos2.shape[0]] = pos2
        ok2 = idx2 < f
        safe2 = torch.clamp(idx2, max=f - 1)
        tri6 = torch.cat([out1, two_in_2[safe2]], dim=0)
        valid = torch.cat([valid1 & in_range, ok2])
        src_id = torch.cat([ids, ids[safe2]])
        clip_overflow = torch.clamp(live2.sum() - extra_cap, min=0)

    cpos = tri6[..., :4]
    bary = tri6[..., 4:6]
    wv = torch.clamp(cpos[..., 3], min=w_eps)
    inv_w = 1.0 / wv
    ndc = cpos[..., :3] * inv_w[..., None]
    tx = (ndc[..., 0] * 0.5 + 0.5) * width
    ty = (0.5 - ndc[..., 1] * 0.5) * height
    if y_offset is not None:
        ty = ty - y_offset
    tz = ndc[..., 2]
    area = ((tx[:, 1] - tx[:, 0]) * (ty[:, 2] - ty[:, 0])
            - (ty[:, 1] - ty[:, 0]) * (tx[:, 2] - tx[:, 0]))
    valid &= torch.abs(area) > 1e-12
    return (tx, ty, tz, inv_w, bary[..., 0], bary[..., 1], src_id, valid,
            clip_overflow)


def _padded_setup(world_verts, tri_vertices, num_faces, view_proj, *,
                  height: int, width: int, extra_cap, cull_sign, src_map=None,
                  face_mask=None, y_offset=None):
    """Triangle setup padded to a multiple of 128 slots with at least one
    dead pad slot; dead slots carry z = 10 (culled by the depth test).
    ``height`` is the projection's (the whole frame's on a band).
    Returns (tx, ty, tz, tw, b1, b2, src, valid, clip_overflow)."""
    tx, ty, tz, tw, b1, b2, src, valid, clip_over = triangle_setup_clipped(
        world_verts, tri_vertices, num_faces, view_proj, height, width,
        extra_cap=extra_cap, cull_sign=cull_sign, src_map=src_map,
        face_mask=face_mask, y_offset=y_offset)
    f2 = tx.shape[0]
    pad = _round_up(f2 + 1, _TC) - f2

    def padf(a):
        return torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                         device=a.device)])
    tx, ty, tz, tw, b1, b2, valid, src = map(
        padf, (tx, ty, tz, tw, b1, b2, valid, src))
    tz = torch.where(valid[:, None], tz, 10.0)
    return tx, ty, tz, tw, b1, b2, src, valid, clip_over


def _segment_lists(tile_of: torch.Tensor, slot_of: torch.Tensor,
                   num_tiles: int):
    """(tile, slot) pair stream -> per-tile lists.  A stable sort on the
    tile key keeps emission order (ascending slot) within a tile.
    Returns (lists: slots in tile order, starts (T+1,), counts (T,))."""
    skeys, order = torch.sort(tile_of, stable=True)
    lists = slot_of[order].to(torch.int32).contiguous()
    bounds = torch.arange(num_tiles + 1, dtype=skeys.dtype,
                          device=skeys.device)
    starts = torch.searchsorted(skeys, bounds)
    counts = starts[1:] - starts[:-1]
    return lists, starts.to(torch.int32), counts.to(torch.int32)


def _edge(ax, ay, bx, by, px, py):
    """Edge function cross(B - A, P - A) in global pixel coordinates,
    evaluated with the endpoints in canonical (x, then y) order and the
    sign restored, so the two triangles sharing an edge compute it bit for
    bit alike: a pixel center on a shared edge is never lost to rounding
    (no cracks)."""
    swap = (bx < ax) | ((bx == ax) & (by < ay))
    x0, y0 = torch.where(swap, bx, ax), torch.where(swap, by, ay)
    x1, y1 = torch.where(swap, ax, bx), torch.where(swap, ay, by)
    e = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    return torch.where(swap, -e, e)


def _field(c, k, lx, ly):
    """Affine field of slot coefficients ``c`` (..., 24) starting at column
    k, at the pixel centers' offsets (lx, ly) from the slot frame's
    origin: (a*lx + b*ly) + c -- the kernels' order."""
    a, b, kc = c[..., k, None], c[..., k + 1, None], c[..., k + 2, None]
    return (a * lx + b * ly) + kc


def _covers(c, gx, gy):
    """Inside test of slot coefficients ``c`` (..., 24) at global pixel
    centers (gx, gy): every edge function has the sign of the area."""
    x0, y0 = c[..., 0, None], c[..., 1, None]
    x1, y1 = c[..., 2, None], c[..., 3, None]
    x2, y2 = c[..., 4, None], c[..., 5, None]
    sg = c[..., 6, None]
    return ((_edge(x0, y0, x1, y1, gx, gy) * sg >= 0.0)
            & (_edge(x1, y1, x2, y2, gx, gy) * sg >= 0.0)
            & (_edge(x2, y2, x0, y0, gx, gy) * sg >= 0.0))


def _slot_keys(c, gx, gy):
    """Depth keys (int64) of slot records ``c`` (..., S, 24) at pixel
    centers (gx, gy) broadcast to (..., 1, P): z with its 7 low mantissa
    bits cleared where the center is covered and 0 <= z <= 1, the miss
    key elsewhere (``raster_common.cuh:slot_key``)."""
    z = _field(c, 8, gx - c[..., 20, None], gy - c[..., 21, None])
    ok = _covers(c, gx, gy) & (z >= 0.0) & (z <= 1.0)
    zm = torch.where(ok, z, 2.0)
    return (zm.view(torch.int32) & ~127).to(torch.int64)


def _tile_pixels(T: int, num_tx: int, tile_h: int, tile_w: int, dev):
    """Global pixel centers (gx, gy), each (T, P), of every tile."""
    pix = torch.arange(tile_h * tile_w, device=dev)
    px = 0.5 + (pix % tile_w).float()
    py = 0.5 + (pix // tile_w).float()
    tid = torch.arange(T, device=dev)
    fx0 = ((tid % num_tx) * tile_w).float()
    fy0 = ((tid // num_tx) * tile_h).float()
    return fx0[:, None] + px, fy0[:, None] + py


def _resolve_winners(coef, key, slot, gx, gy):
    """Kernel outputs (z, slot, u, v), each (T, P), from the winners'
    depth keys and slot ids (``raster_common.cuh:slot_uv``)."""
    hit = key < _MISS_KEY
    slot = torch.where(hit, slot, 0)
    c = coef[slot]
    lx = gx - c[..., 20]
    ly = gy - c[..., 21]

    def win_field(k):     # the winner's field at its own pixel
        a, b, kc = c[..., k], c[..., k + 1], c[..., k + 2]
        return (a * lx + b * ly) + kc

    un, vn, dn = win_field(11), win_field(14), win_field(17)
    rcp = 1.0 / torch.where(torch.abs(dn) > 1e-20, dn, 1.0)
    zq = key.to(torch.int32).view(torch.float32)
    return (torch.where(hit, zq, _BIG),
            torch.where(hit, slot, -1).to(torch.int32),
            torch.where(hit, un * rcp, 0.0),
            torch.where(hit, vn * rcp, 0.0))


def raster_tiles_reference(coef, lists, starts, counts, *, num_tx: int,
                           tile_h: int = 8, tile_w: int = 128,
                           cap: int = 2048):
    """Plain PyTorch version of kernel R.  For each tile t the winner over
    list positions i < min(counts[t], cap) is the minimum of (z with its 7
    low mantissa bits cleared, i) among slots whose pixel passes the
    edge and depth tests.  Same operations in the same order as the
    kernel.  Returns (z, slot, u, v), each (T, tile_h * tile_w)."""
    dev = coef.device
    T = counts.shape[0]
    P = tile_h * tile_w
    gx, gy = _tile_pixels(T, num_tx, tile_h, tile_w, dev)
    gx, gy = gx[:, None, :], gy[:, None, :]
    n = torch.clamp(counts.long(), max=cap)
    s0 = starts[:T].long()
    maxn = int(n.max()) if T else 0
    # list positions per vectorized step, bounding the (T, chunk, P) temps
    chunk = max(1, min(64, (1 << 24) // max(T * P, 1)))
    best = torch.full((T, P), _NEVER, dtype=torch.int64, device=dev)
    last = max(lists.shape[0] - 1, 0)
    for i0 in range(0, maxn, chunk):
        pos = torch.arange(i0, min(i0 + chunk, maxn), device=dev)
        live = pos[None, :] < n[:, None]                      # (T, C)
        # a position past a tile's list may hold anything (the sorted
        # lists' tail is undefined): no slot is read from it
        slot = torch.where(live, lists[torch.clamp(
            s0[:, None] + pos[None, :], max=last)], 0)
        comp = (_slot_keys(coef[slot.long()], gx, gy) << 32) \
            | pos[None, :, None]
        comp = torch.where(live[..., None], comp, _NEVER)
        best = torch.minimum(best, comp.min(dim=1).values)
    win = best & 0xFFFFFFFF
    slot = lists[torch.clamp(s0[:, None] + win, max=last)].long() \
        if lists.numel() else torch.zeros_like(win)
    return _resolve_winners(coef, best >> 32, slot, gx[:, 0], gy[:, 0])


def list_length_stats(counts: torch.Tensor, cap: int) -> dict:
    """Distribution of the tile lists a ``raster_tiles`` launch walks,
    min(count, cap) slots a tile: mean, median (``p50``), 99th percentile
    (``p99``, linear interpolation, as ``numpy.percentile``) and longest
    length, and ``top1_share``, the share of the walked (tile, slot)
    pairs that lie in the longest 1% of tiles (at least one tile)."""
    n = torch.clamp(counts.reshape(-1).long(), max=cap).sort().values
    tiles = n.shape[0]
    if tiles == 0:
        return dict(tiles=0, pairs=0, mean=0.0, p50=0.0, p99=0.0, max=0,
                    top1_share=0.0)
    nd = n.double()
    pairs = int(n.sum())
    top = n[tiles - max(1, -(-tiles // 100)):]
    return dict(tiles=tiles, pairs=pairs, mean=float(nd.mean()),
                p50=float(torch.quantile(nd, 0.5)),
                p99=float(torch.quantile(nd, 0.99)), max=int(n[-1]),
                top1_share=float(top.sum()) / pairs if pairs else 0.0)


def _check_tiles(name, coef, ints, T, tile_h, tile_w):
    if coef.dtype != torch.float32 or coef.dim() != 2 \
            or coef.shape[1] != _NCOEF:
        raise ValueError(f"{name}: coef must be (S, {_NCOEF}) float32, got "
                         f"{tuple(coef.shape)} {coef.dtype}")
    for arg, x in ints.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {x.dtype}")
    if not 1 <= tile_h * tile_w <= 1024:
        raise ValueError(f"{name}: a tile of {tile_h * tile_w} pixels "
                         "exceeds one thread block")
    tensors = (coef, *ints.values())
    if all(x.device.type == "cpu" for x in tensors):
        return True
    if not all(x.is_cuda and x.device == coef.device for x in tensors):
        raise ValueError(f"{name}: inputs must all be on one CUDA device "
                         "(or all on the CPU)")
    return False


def _outputs(T, P, dev):
    return (torch.empty((T, P), dtype=torch.float32, device=dev),
            torch.empty((T, P), dtype=torch.int32, device=dev),
            torch.empty((T, P), dtype=torch.float32, device=dev),
            torch.empty((T, P), dtype=torch.float32, device=dev))


def raster_tiles(coef: torch.Tensor, lists: torch.Tensor,
                 starts: torch.Tensor, counts: torch.Tensor, *, num_tx: int,
                 tile_h: int = 8, tile_w: int = 128, cap: int = 2048):
    """Kernel R wrapper (see :func:`raster_tiles_reference`): CUDA tensors
    launch ``csrc/raster_tiles.cu``; CPU tensors run the plain version.
    ``coef`` (S, 24) f32 slot table (:func:`slot_coefficients`), ``lists``
    (pairs,) i32 slot ids in tile order, ascending within each tile,
    ``starts`` (T+1,) / ``counts`` (T,) i32."""
    T = counts.shape[0]
    ints = dict(lists=lists, starts=starts, counts=counts)
    if any(x.dim() != 1 for x in ints.values()):
        raise ValueError("raster_tiles: lists, starts and counts must be "
                         "1-D")
    if starts.shape[0] != T + 1:
        raise ValueError("starts must hold one more entry than counts")
    if _check_tiles("raster_tiles", coef, ints, T, tile_h, tile_w):
        return raster_tiles_reference(coef, lists, starts, counts,
                                      num_tx=num_tx, tile_h=tile_h,
                                      tile_w=tile_w, cap=cap)
    coef, lists, starts, counts = (
        x.contiguous() for x in (coef, lists, starts, counts))
    z, slot, u, v = _outputs(T, tile_h * tile_w, coef.device)
    code = _cuda.library().vri_raster_tiles(
        coef.data_ptr(), lists.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), T, num_tx, tile_h, tile_w, cap, z.data_ptr(),
        slot.data_ptr(), u.data_ptr(), v.data_ptr(), _cuda.stream_ptr(coef))
    _cuda.check(code, "raster_tiles")
    raster_tiles.launches += 1
    return z, slot, u, v


raster_tiles.launches = 0


def _tile_span(xs, ys, tile_h: int, tile_w: int):
    """Inclusive tile span (tx0, tx1, ty0, ty1), each int32, of slots
    with screen corners ``xs``, ``ys`` (..., 3): the floor of the bbox's
    extremes over the tile size.  The sorted tier emits a (tile, slot)
    pair for each tile of a valid slot's span; the ranged walk tests
    exactly those pairs (``csrc/raster_ranged.cu:in_span``)."""
    return (_to_i32(torch.floor(xs.min(dim=-1).values / tile_w)),
            _to_i32(torch.floor(xs.max(dim=-1).values / tile_w)),
            _to_i32(torch.floor(ys.min(dim=-1).values / tile_h)),
            _to_i32(torch.floor(ys.max(dim=-1).values / tile_h)))


def ranged_pairs(coef, order, ranges, words, *, n_global: int,
                 num_tx: int, tile_h: int = 8, tile_w: int = 128):
    """The (tile, slot) pairs the ranged walk tests, as (tile ids, slot
    ids), each (N,) int64, in walk order.  Tile t walks chunks 0 ..
    n_global-1, then ranges[t, 0] .. ranges[t, 1]-1, each only when its
    bit in words[t] is set; chunk c holds the slots order[128c ..
    128c+127].  Of a walked chunk it keeps only the slots that the sorted
    tier lists for the tile: live (column 7 of the slot table) with the
    tile inside their tile span (:func:`_tile_span` on columns 0-5, the
    floats ``prepare_sorted`` reads)."""
    dev = coef.device
    T = ranges.shape[0]
    lo = ranges[:, 0].long()
    steps = n_global + torch.clamp(ranges[:, 1].long() - lo, min=0)
    total = int(steps.sum())
    tile_of = torch.repeat_interleave(torch.arange(T, device=dev), steps,
                                      output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(steps, 0)
                                           - steps)[tile_of]
    c = torch.where(k < n_global, k, lo[tile_of] + k - n_global)
    word = words[tile_of, c >> 5].long() & 0xFFFFFFFF
    live = ((word >> (c & 31)) & 1) != 0
    tile_of, c = tile_of[live], c[live]
    sid = order.view(-1, _TC)[c].long()                       # (N, 128)
    tx0, tx1, ty0, ty1 = _tile_span(coef[:, 0:6:2], coef[:, 1:6:2],
                                    tile_h, tile_w)
    col = (tile_of % num_tx)[:, None]
    row = torch.div(tile_of, num_tx, rounding_mode="floor")[:, None]
    keep = (coef[sid, 7] > 0.5) & (tx0[sid] <= col) & (col <= tx1[sid]) \
        & (ty0[sid] <= row) & (row <= ty1[sid])
    return tile_of[:, None].expand_as(sid)[keep], sid[keep]


def raster_ranged_reference(coef, order, ranges, words, *, n_global: int,
                            num_tx: int, tile_h: int = 8, tile_w: int = 128,
                            pairs: bool = False):
    """Plain PyTorch version of ``raster_ranged``: per pixel, the minimum
    of (z with its 7 low mantissa bits cleared, slot index) over the
    (tile, slot) pairs of :func:`ranged_pairs` whose pixel passes the
    edge and depth tests -- exactly the pairs the sorted tier lists, so
    the tiers agree by construction.  The pairs are evaluated in batches
    and reduced per tile.  Returns (z, slot, u, v), each (T, P), and with
    ``pairs`` the (T,) int32 count of each tile's tested pairs."""
    dev = coef.device
    T = ranges.shape[0]
    P = tile_h * tile_w
    gx, gy = _tile_pixels(T, num_tx, tile_h, tile_w, dev)
    tile_of, sid = ranged_pairs(coef, order, ranges, words,
                                n_global=n_global, num_tx=num_tx,
                                tile_h=tile_h, tile_w=tile_w)
    best = torch.full((T, P), _NEVER, dtype=torch.int64, device=dev)
    batch = max(1, (1 << 22) // P)
    for b0 in range(0, tile_of.shape[0], batch):
        tb, sb = tile_of[b0:b0 + batch], sid[b0:b0 + batch]
        comp = (_slot_keys(coef[sb], gx[tb], gy[tb]) << 32) | sb[:, None]
        best.scatter_reduce_(0, tb[:, None].expand(-1, P), comp, "amin")
    out = _resolve_winners(coef, best >> 32, best & 0xFFFFFFFF, gx, gy)
    if pairs:
        out += (torch.bincount(tile_of, minlength=T).to(torch.int32),)
    return out


def raster_ranged(coef: torch.Tensor, order: torch.Tensor,
                  ranges: torch.Tensor, words: torch.Tensor, *,
                  n_global: int, num_tx: int, tile_h: int = 8,
                  tile_w: int = 128, pairs: bool = False):
    """Ranged kernel wrapper (see :func:`raster_ranged_reference`): CUDA
    tensors launch ``csrc/raster_ranged.cu``; CPU tensors run the plain
    version.  ``coef`` (S, 24) f32 slot table in setup order, ``order``
    (C * 128,) i32 slot ids in Morton order, ``ranges`` (T, 2) i32 local
    chunk ranges, ``words`` (T, ceil(C / 32)) i32 overlap bits.  With
    ``pairs`` it also returns each tile's count of tested (tile, slot)
    pairs, (T,) int32."""
    T = ranges.shape[0]
    ints = dict(order=order, ranges=ranges, words=words)
    if order.dim() != 1 or order.shape[0] % _TC:
        raise ValueError(f"raster_ranged: order must be 1-D with a multiple "
                         f"of {_TC} entries, got {tuple(order.shape)}")
    num_chunks = order.shape[0] // _TC
    if ranges.shape != (T, 2) or words.dim() != 2 or words.shape[0] != T \
            or words.shape[1] * 32 < num_chunks:
        raise ValueError("raster_ranged: ranges must be (T, 2) and words "
                         "(T, >= chunks / 32)")
    if not 0 <= n_global <= num_chunks:
        raise ValueError(f"raster_ranged: n_global {n_global} outside "
                         f"[0, {num_chunks}]")
    if _check_tiles("raster_ranged", coef, ints, T, tile_h, tile_w):
        return raster_ranged_reference(coef, order, ranges, words,
                                       n_global=n_global, num_tx=num_tx,
                                       tile_h=tile_h, tile_w=tile_w,
                                       pairs=pairs)
    coef, order, ranges, words = (
        x.contiguous() for x in (coef, order, ranges, words))
    out = _outputs(T, tile_h * tile_w, coef.device)
    if pairs:
        out += (torch.empty((T,), dtype=torch.int32, device=coef.device),)
    code = _cuda.library().vri_raster_ranged(
        coef.data_ptr(), order.data_ptr(), ranges.data_ptr(),
        words.data_ptr(), T, n_global, words.shape[1], num_tx, tile_h,
        tile_w, *(x.data_ptr() for x in out[:4]),
        out[4].data_ptr() if pairs else 0, _cuda.stream_ptr(coef))
    _cuda.check(code, "raster_ranged")
    raster_ranged.launches += 1
    return out


raster_ranged.launches = 0


def slot_coefficients(tx, ty, tz, tw, b1, b2, valid):
    """(S, 24) per-slot table of the raster kernels.  Columns: 0-5 the
    corners (x0 y0 x1 y1 x2 y2) in global pixel coordinates for the edge
    tests and the tile spans, 6 the sign of the screen area, 7 the live
    flag (1 for a valid slot, 0 else: the ranged walk's cull); then affine (a, b, c) triples in
    the slot's local frame (origin = floor of its screen-bbox min, held
    on the screen): 8-10 depth, 11-13 / 14-16 / 17-19 the perspective-correct attribute fields
    un, vn, den; 20-21 the frame origin (ox, oy); 22-23 pad.  Dead slots
    get depth 10 (culled by the depth test) and den 1.

    The affine triples are built in float64 and rounded once: near-plane
    clipped slots carry 1/w up to 1e4, and their attribute fields cancel
    badly in float32 construction."""
    lox = tx.min(dim=1).values
    loy = ty.min(dim=1).values
    # the frame origin is held on the screen: a near-plane-clipped slot's
    # bbox can start 1e6 pixels off it, and an origin there makes every
    # on-screen field value a float32 cancellation of terms ~1e3
    ox = torch.floor(torch.clamp(lox, min=0.0))
    oy = torch.floor(torch.clamp(loy, min=0.0))
    gx32 = tx - ox[:, None]
    gy32 = ty - oy[:, None]
    area32 = (gx32[:, 1] - gx32[:, 0]) * (gy32[:, 2] - gy32[:, 0]) \
        - (gy32[:, 1] - gy32[:, 0]) * (gx32[:, 2] - gx32[:, 0])
    dead = ~valid | (torch.abs(area32) <= 1e-12)
    f64 = torch.float64
    gx = tx.to(f64) - ox.to(f64)[:, None]
    gy = ty.to(f64) - oy.to(f64)[:, None]
    ax_, bx_, cx_ = gx[:, 0], gx[:, 1], gx[:, 2]
    ay_, by_, cy_ = gy[:, 0], gy[:, 1], gy[:, 2]
    az_, bz_, cz_ = (tz[:, k].to(f64) for k in range(3))
    area = (bx_ - ax_) * (cy_ - ay_) - (by_ - ay_) * (cx_ - ax_)
    inv = torch.where(dead, 0.0, 1.0 / torch.where(dead, 1.0, area))
    ka1 = -(ay_ - cy_) * inv
    kb1 = (ax_ - cx_) * inv
    kc1 = (cx_ * (ay_ - cy_) - cy_ * (ax_ - cx_)) * inv
    ka2 = -(by_ - ay_) * inv
    kb2 = (bx_ - ax_) * inv
    kc2 = (ax_ * (by_ - ay_) - ay_ * (bx_ - ax_)) * inv
    dz1, dz2 = bz_ - az_, cz_ - az_
    kaz = torch.where(dead, 0.0, ka1 * dz1 + ka2 * dz2)
    kbz = torch.where(dead, 0.0, kb1 * dz1 + kb2 * dz2)
    kcz = torch.where(dead, 10.0, az_ + kc1 * dz1 + kc2 * dz2)
    # perspective-corrected attributes are rational affine in screen
    # space: numerator sum_i l_i w_i su_i and denominator sum_i l_i w_i
    w0_, w1_, w2_ = (tw[:, k].to(f64) for k in range(3))
    su0, su1, su2 = (b1[:, k].to(f64) for k in range(3))
    sv0, sv1, sv2 = (b2[:, k].to(f64) for k in range(3))
    au_ = w1_ * su1 - w0_ * su0
    bu_ = w2_ * su2 - w0_ * su0
    av_ = w1_ * sv1 - w0_ * sv0
    bv_ = w2_ * sv2 - w0_ * sv0
    ad_ = w1_ - w0_
    bd_ = w2_ - w0_
    fields = torch.stack(
        [kaz, kbz, kcz,
         ka1 * au_ + ka2 * bu_, kb1 * au_ + kb2 * bu_,
         w0_ * su0 + kc1 * au_ + kc2 * bu_,
         ka1 * av_ + ka2 * bv_, kb1 * av_ + kb2 * bv_,
         w0_ * sv0 + kc1 * av_ + kc2 * bv_,
         ka1 * ad_ + ka2 * bd_, kb1 * ad_ + kb2 * bd_,
         torch.where(dead, 1.0, w0_ + kc1 * ad_ + kc2 * bd_)],
        dim=1).to(torch.float32)
    sign = torch.sign((tx[:, 1] - tx[:, 0]) * (ty[:, 2] - ty[:, 0])
                      - (ty[:, 1] - ty[:, 0]) * (tx[:, 2] - tx[:, 0]))
    zero = torch.zeros_like(ox)
    return torch.cat(
        [torch.stack([tx[:, 0], ty[:, 0], tx[:, 1], ty[:, 1], tx[:, 2],
                      ty[:, 2], sign, valid.to(torch.float32)], dim=1),
         fields, torch.stack([ox, oy, zero, zero], dim=1)],
        dim=1).contiguous()


def _screen_morton_order(tx, ty, valid, height: int, width: int,
                         large_span: float = 160.0,
                         partition_large: bool = True):
    """Spatial-locality permutation of the slots (``vri_tpu``'s
    ``_screen_morton_order``): a stable sort on the Morton code of each
    slot's screen-bbox center, invalid slots last.  With
    ``partition_large`` slots spanning more than ``large_span`` pixels sort
    to a front block that every tile walks.  Returns (order (S,) int64,
    number of large valid slots)."""
    dev = tx.device
    lox, hix = tx.min(dim=1).values, tx.max(dim=1).values
    loy, hiy = ty.min(dim=1).values, ty.max(dim=1).values
    sx = torch.tensor(1024.0 / width, dtype=torch.float32, device=dev)
    sy = torch.tensor(1024.0 / height, dtype=torch.float32, device=dev)
    cx = torch.clamp((lox + hix) * 0.5, 0, width - 1) * sx
    cy = torch.clamp((loy + hiy) * 0.5, 0, height - 1) * sy

    def spread(v):
        v = v.to(torch.int64)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    code = (spread(cx) << 1) | spread(cy)
    if partition_large:
        large = ((hix - lox) > large_span) | ((hiy - loy) > large_span)
        key = torch.where(large, 0, code + 1)
        n_large = int((large & valid).sum())
    else:
        key = code
        n_large = 0
    key = torch.where(valid, key, 0xFFFFFFFF)
    return torch.sort(key, stable=True).indices, n_large


def _bboxes(tx, ty, valid, order, size: int):
    """(N, 4) screen bboxes [x_lo, x_hi, y_lo, y_hi] of consecutive runs
    of ``size`` slots in ``order``, over valid slots only (an all-invalid
    run gets an empty box)."""
    v = valid[order][:, None]
    x, y = tx[order], ty[order]
    n = order.shape[0] // size
    return torch.stack(
        [torch.where(v, x, _BIG).reshape(n, -1).min(dim=1).values,
         torch.where(v, x, -_BIG).reshape(n, -1).max(dim=1).values,
         torch.where(v, y, _BIG).reshape(n, -1).min(dim=1).values,
         torch.where(v, y, -_BIG).reshape(n, -1).max(dim=1).values], dim=1)


def _tile_overlap(box, rows, gx: int, tile_h: int, tile_w: int):
    """(len(rows), gx, N) bool: box n overlaps tile (row, col), with the
    reference's closed tests against the tile's edges."""
    dev = box.device
    tx0 = torch.arange(gx, device=dev).float() * tile_w
    ty0 = rows.float() * tile_h
    ov_x = (box[None, :, 0] <= tx0[:, None] + tile_w) \
        & (box[None, :, 1] >= tx0[:, None])
    ov_y = (box[None, :, 2] <= ty0[:, None] + tile_h) \
        & (box[None, :, 3] >= ty0[:, None])
    return ov_y[:, None, :] & ov_x[None, :, :]


def _sorted_sizes(num_tri: int, *, height: int, width: int, tile_h: int,
                  tile_w: int, cap: int, pairs_cap: int | None,
                  caps_scale: int, culled: bool):
    """The sorted tier's capacities from the face count and the caps:
    (cap, pairs_cap, extra_cap, padded slot count, (gy, gx))."""
    cap = _round_up(cap * caps_scale, _TC)
    extra = max(num_tri // 16, 256) * caps_scale
    slots = _round_up(num_tri + extra + 1, _TC)
    if pairs_cap is None:
        # backface culling roughly halves the live pairs on solid scenes
        pairs_cap = max(min((4 if culled else 6) * slots, 2 * 1024 * 1024),
                        128 * 1024)
    pairs_cap = _round_up(pairs_cap * caps_scale, _TC)
    grid = (_round_up(height, tile_h) // tile_h,
            _round_up(width, tile_w) // tile_w)
    return cap, pairs_cap, extra, slots, grid


def prepare_sorted(world_verts, tri_vertices, num_faces, view_proj, *,
                   height: int, width: int, tile_h: int = 8,
                   tile_w: int = 128, cap: int = 2048,
                   pairs_cap: int | None = None, caps_scale: int = 1,
                   cull_sign=None, src_map=None, face_mask=None,
                   proj_height: int | None = None, y_offset=None):
    """Everything before the sorted tier's walk: setup, exact emission and
    the per-tile lists.  On a band (rows [y_offset, y_offset + height) of
    a ``proj_height``-row frame) the setup projects with ``proj_height``
    and the tiles, lists and outputs cover the band.  Returns a dict with
    the kernel's inputs (coef, lists, starts, counts, cap, num_tx), the
    slot-to-triangle map ``src`` and the ``overflow`` flag (0-d int32).
    ``lists`` is ``pairs_cap`` long; its entries past ``starts[-1]`` are
    undefined.  CUDA tensors run :func:`raster_prep`'s kernels, CPU
    tensors the plain version :func:`prepare_sorted_reference`."""
    fn = (prepare_sorted_reference if world_verts.device.type == "cpu"
          else raster_prep)
    return fn(world_verts, tri_vertices, num_faces, view_proj,
              height=height, width=width, tile_h=tile_h, tile_w=tile_w,
              cap=cap, pairs_cap=pairs_cap, caps_scale=caps_scale,
              cull_sign=cull_sign, src_map=src_map, face_mask=face_mask,
              proj_height=proj_height, y_offset=y_offset)


def prepare_sorted_reference(world_verts, tri_vertices, num_faces,
                             view_proj, *, height: int, width: int,
                             tile_h: int = 8, tile_w: int = 128,
                             cap: int = 2048, pairs_cap: int | None = None,
                             caps_scale: int = 1, cull_sign=None,
                             src_map=None, face_mask=None,
                             proj_height: int | None = None, y_offset=None):
    """Plain PyTorch version of :func:`raster_prep` (the arguments and dict
    of :func:`prepare_sorted`).  Every visible slot emits one (tile, slot)
    pair per tile of its on-screen window, slot-major and row-major in the
    window, into a stream of ``pairs_cap`` positions: pairs past it are
    dropped and counted in ``overflow``, positions past the pairs carry
    the sentinel tile ``num_tiles``.  One stable sort on the tile key
    gives the lists, ascending slots within a tile."""
    cap, pairs_cap, extra, _, (gy, gx) = _sorted_sizes(
        tri_vertices.shape[0], height=height, width=width, tile_h=tile_h,
        tile_w=tile_w, cap=cap, pairs_cap=pairs_cap, caps_scale=caps_scale,
        culled=cull_sign is not None)
    num_tiles = gy * gx
    dev = world_verts.device
    tx, ty, tz, tw, b1, b2, src, valid, clip_over = _padded_setup(
        world_verts, tri_vertices, num_faces, view_proj,
        height=proj_height or height, width=width, extra_cap=extra,
        cull_sign=cull_sign, src_map=src_map, face_mask=face_mask,
        y_offset=y_offset)
    fp = tx.shape[0]

    # per-slot inclusive tile span from the screen bbox
    tx0, tx1, ty0, ty1 = _tile_span(tx, ty, tile_h, tile_w)
    on_screen = (tx1 >= 0) & (tx0 < gx) & (ty1 >= 0) & (ty0 < gy)
    vis = valid & on_screen

    # exact emission: slot-major, row-major over each slot's tile window;
    # position p belongs to the first slot whose running pair count
    # exceeds p
    ry0 = torch.clamp(ty0, 0, gy - 1).long()
    rx0 = torch.clamp(tx0, 0, gx - 1).long()
    zero = torch.zeros_like(ry0)
    e_rows = torch.where(vis, torch.clamp(ty1, 0, gy - 1) - ry0 + 1, zero)
    e_cols = torch.where(vis, torch.clamp(tx1, 0, gx - 1) - rx0 + 1, zero)
    area_t = e_rows * e_cols
    ends = torch.cumsum(area_t, 0)
    total = ends[-1]
    pos = torch.arange(pairs_cap, device=dev)
    sid = torch.clamp(torch.searchsorted(ends, pos, right=True), max=fp - 1)
    k_local = pos - (ends - area_t)[sid]
    cols = torch.clamp(e_cols[sid], min=1)
    dy = torch.div(k_local, cols, rounding_mode="floor")
    dx = k_local - dy * cols
    tile_of = torch.where(pos < total, (ry0[sid] + dy) * gx + rx0[sid] + dx,
                          num_tiles)
    lists, starts, counts = _segment_lists(tile_of, sid, num_tiles)
    overflow = ((counts > cap).any() | (total > pairs_cap)
                | (clip_over > 0)).to(torch.int32)
    return dict(coef=slot_coefficients(tx, ty, tz, tw, b1, b2, valid),
                lists=lists, starts=starts, counts=counts, cap=cap,
                num_tx=gx, grid=(gy, gx), src=src, overflow=overflow)


def _on_card(name, x, dev, dtype, shape=None):
    """``x`` as a contiguous ``dtype`` tensor on ``dev`` (converted on the
    card where its dtype differs), or a ValueError."""
    if x.device != dev:
        raise ValueError(f"raster_prep: {name} must be on {dev}, got "
                         f"{x.device}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"raster_prep: {name} must be {shape}, got "
                         f"{tuple(x.shape)}")
    return x.to(dtype).contiguous()


def raster_prep(world_verts, tri_vertices, num_faces, view_proj, *,
                height: int, width: int, tile_h: int = 8, tile_w: int = 128,
                cap: int = 2048, pairs_cap: int | None = None,
                caps_scale: int = 1, cull_sign=None, src_map=None,
                face_mask=None, proj_height: int | None = None,
                y_offset=None):
    """Kernel wrapper of the sorted tier's prep (``csrc/raster_prep.cu``):
    CUDA tensors only, the arguments and dict of :func:`prepare_sorted`,
    equal to :func:`prepare_sorted_reference` bit for bit over the live
    part of ``lists``, from one C call of a dozen launches that neither
    syncs with the host nor reads a size back.  ``num_faces`` is an int
    or a 0-d integer tensor on the card; ``y_offset`` a host number."""
    dev = world_verts.device
    if dev.type != "cuda":
        raise ValueError(f"raster_prep: needs CUDA tensors, got {dev}")
    f = tri_vertices.shape[0]
    cap, pairs_cap, extra, slots, (gy, gx) = _sorted_sizes(
        f, height=height, width=width, tile_h=tile_h, tile_w=tile_w,
        cap=cap, pairs_cap=pairs_cap, caps_scale=caps_scale,
        culled=cull_sign is not None)
    num_tiles = gy * gx
    verts = _on_card("world_verts", world_verts, dev, torch.float32)
    tri = _on_card("tri_vertices", tri_vertices, dev, torch.int32, (f, 3))
    vp = _on_card("view_proj", view_proj, dev, torch.float32, (4, 4))
    opt = {name: None if x is None else _on_card(name, x, dev, dtype, (f,))
           for name, x, dtype in (("cull_sign", cull_sign, torch.float32),
                                  ("src_map", src_map, torch.int32),
                                  ("face_mask", face_mask, torch.bool))}
    if isinstance(num_faces, torch.Tensor) and num_faces.is_cuda:
        nf = _on_card("num_faces", num_faces.reshape(()), dev, torch.int32)
        nf_ptr, nf_host = nf.data_ptr(), 0
    else:
        nf_ptr, nf_host = 0, int(num_faces)
    lib = _cuda.library()
    nbytes = lib.vri_raster_prep_scratch(f, slots, pairs_cap, num_tiles)
    if nbytes < 0:
        raise ValueError(f"raster_prep: pairs_cap {pairs_cap} needs over "
                         "2 GiB of scratch")
    i32 = dict(dtype=torch.int32, device=dev)
    coef = torch.empty((slots, _NCOEF), dtype=torch.float32, device=dev)
    src = torch.empty((slots,), **i32)
    lists = torch.empty((pairs_cap,), **i32)
    starts = torch.empty((num_tiles + 1,), **i32)
    counts = torch.empty((num_tiles,), **i32)
    overflow = torch.empty((), **i32)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    code = lib.vri_raster_prep(
        verts.data_ptr(), tri.data_ptr(), nf_ptr, nf_host, vp.data_ptr(),
        *(0 if x is None else x.data_ptr() for x in opt.values()),
        f, extra, slots, float(width), float(proj_height or height),
        float(y_offset or 0.0), tile_h, tile_w, gx, gy, pairs_cap, cap,
        coef.data_ptr(), src.data_ptr(), lists.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), overflow.data_ptr(), scratch.data_ptr(),
        _cuda.stream_ptr(verts))
    _cuda.check(code, "raster_prep")
    raster_prep.launches += 1
    return dict(coef=coef, lists=lists, starts=starts, counts=counts,
                cap=cap, num_tx=gx, grid=(gy, gx), src=src,
                overflow=overflow)


raster_prep.launches = 0


def _bin_groups(box, grid, tile_h: int, tile_w: int, cap_groups: int):
    """Per-tile lists of Morton slot groups (``vri_tpu``'s
    ``_bin_groups``): a group belongs to a tile when its bbox overlaps
    it; a tile keeps its first ``cap_groups`` groups.  Returns (group ids
    (T, k), in-list mask (T, k), overflowed (T,) bool) with k =
    min(groups, cap_groups)."""
    gy, gx = grid
    overlap = _tile_overlap(box, torch.arange(gy, device=box.device), gx,
                            tile_h, tile_w).reshape(gy * gx, -1)
    overflowed = overlap.sum(dim=1) > cap_groups
    # overlapping group ids first, in group order (stable sort)
    first = torch.sort((~overlap).to(torch.uint8), dim=1,
                       stable=True).indices[:, :cap_groups]
    return first, torch.gather(overlap, 1, first), overflowed


def prepare_binned(world_verts, tri_vertices, num_faces, view_proj, *,
                   height: int, width: int, tile_h: int = 8,
                   tile_w: int = 128, cap_groups: int = 64,
                   caps_scale: int = 1, cull_sign=None, face_mask=None,
                   proj_height: int | None = None, y_offset=None):
    """Everything before the binned tier's walk: setup with one second
    slot per face, the Morton order, 8-slot groups and per-tile group
    lists.  Each tile's list holds the slot ids of its groups sorted to
    ascending setup order, so kernel R's list-position tie rule is the
    setup-order rule.  Returns the dict of :func:`prepare_sorted`; its
    ``overflow`` counts the tiles with more than ``cap_groups *
    caps_scale`` overlapping groups (0-d int32), as ``vri_tpu``'s binned
    tier does.  ``proj_height`` and ``y_offset`` as in
    :func:`prepare_sorted`."""
    group = 8
    cap_groups = cap_groups * caps_scale
    hp = _round_up(height, tile_h)
    wp = _round_up(width, tile_w)
    gy, gx = hp // tile_h, wp // tile_w
    tx, ty, tz, tw, b1, b2, src, valid, _ = _padded_setup(
        world_verts, tri_vertices, num_faces, view_proj,
        height=proj_height or height, width=width, extra_cap=None,
        cull_sign=cull_sign, face_mask=face_mask, y_offset=y_offset)
    order, _ = _screen_morton_order(tx, ty, valid, height, width,
                                    partition_large=False)
    groups, in_list, overflowed = _bin_groups(
        _bboxes(tx, ty, valid, order, group), (gy, gx), tile_h, tile_w,
        cap_groups)
    members = order.view(-1, group)[groups]              # (T, k, 8)
    # the last pad slot (dead, the highest id) fills the rows' tails
    dead = tx.shape[0] - 1
    lists = torch.where(in_list[..., None], members, dead).reshape(
        gy * gx, -1)
    lists = torch.sort(lists, dim=1).values.to(torch.int32)
    width_l = lists.shape[1]
    starts = torch.arange(gy * gx + 1, dtype=torch.int32,
                          device=tx.device) * width_l
    counts = (in_list.sum(dim=1) * group).to(torch.int32)
    return dict(coef=slot_coefficients(tx, ty, tz, tw, b1, b2, valid),
                lists=lists.reshape(-1), starts=starts, counts=counts,
                cap=_round_up(max(width_l, 1), _TC), num_tx=gx,
                grid=(gy, gx), src=src,
                overflow=overflowed.sum().to(torch.int32))


def prepare_ranged(world_verts, tri_vertices, num_faces, view_proj, *,
                   height: int, width: int, tile_h: int = 8,
                   tile_w: int = 128, cull_sign=None, face_mask=None,
                   proj_height: int | None = None, y_offset=None):
    """Everything before the ranged walk: setup with one second slot per
    face (S = 2F, no clip overflow), the Morton order with screen-spanning
    slots in front, and the per-tile metadata of ``vri_tpu``'s ranged
    tier: ``n_global`` front chunks every tile walks, each tile's local
    chunk range [lo, hi) and its chunk overlap bits packed in 32-bit
    words.  Returns a dict with the kernel's inputs (coef, order, ranges,
    words, n_global, num_tx), ``grid`` and ``src``; ``proj_height`` and
    ``y_offset`` as in :func:`prepare_sorted`."""
    hp = _round_up(height, tile_h)
    wp = _round_up(width, tile_w)
    gy, gx = hp // tile_h, wp // tile_w
    dev = world_verts.device
    tx, ty, tz, tw, b1, b2, src, valid, _ = _padded_setup(
        world_verts, tri_vertices, num_faces, view_proj,
        height=proj_height or height, width=width, extra_cap=None,
        cull_sign=cull_sign, face_mask=face_mask, y_offset=y_offset)
    order, n_large = _screen_morton_order(tx, ty, valid, height, width)
    box = _bboxes(tx, ty, valid, order, _TC)
    num_chunks = box.shape[0]
    n_global = min(-(-n_large // _TC), num_chunks)
    n_words = -(-num_chunks // 32)
    cid = torch.arange(num_chunks, device=dev)
    local = cid >= n_global
    shifts = torch.arange(32, device=dev)
    ranges, words = [], []
    # tile rows per slab, bounding the (rows, gx, chunks) temporaries
    slab = max(1, (1 << 22) // (gx * n_words * 32))
    for r0 in range(0, gy, slab):
        ov = _tile_overlap(box, torch.arange(r0, min(r0 + slab, gy),
                                             device=dev), gx, tile_h, tile_w)
        ov = ov.reshape(-1, num_chunks)
        lo = torch.where(ov & local, cid, 1 << 30).min(dim=1).values
        hi = torch.where(ov & local, cid + 1, 0).max(dim=1).values
        ranges.append(torch.stack([torch.minimum(lo, hi), hi], dim=1))
        bits = torch.nn.functional.pad(ov, (0, n_words * 32 - num_chunks))
        w = (bits.view(-1, n_words, 32).long() << shifts).sum(dim=2)
        words.append(torch.where(w >= 1 << 31, w - (1 << 32), w))
    return dict(coef=slot_coefficients(tx, ty, tz, tw, b1, b2, valid),
                order=order.to(torch.int32),
                ranges=torch.cat(ranges).to(torch.int32).contiguous(),
                words=torch.cat(words).to(torch.int32).contiguous(),
                n_global=n_global, num_tx=gx, grid=(gy, gx), src=src)


def _frame_hit(prep, out, *, height: int, width: int, tile_h: int,
               tile_w: int, overflow) -> Tuple[HitRecord, torch.Tensor]:
    """Per-tile kernel outputs (z, slot, u, v) -> (HitRecord over the
    height x width frame with source triangle ids, depth image)."""
    z, slot, u, v = out
    gy, gx = prep["grid"]

    def plane(a):
        return a.reshape(gy, gx, tile_h, tile_w).permute(0, 2, 1, 3) \
            .reshape(gy * tile_h, gx * tile_w)[:height, :width]

    slot = plane(slot)
    hit_mask = slot >= 0
    tri = torch.where(hit_mask, prep["src"][torch.clamp(slot, min=0).long()],
                      -1)
    z = plane(z)
    hit = HitRecord(t=z.reshape(-1), tri=tri.reshape(-1),
                    u=plane(u).reshape(-1), v=plane(v).reshape(-1),
                    overflow=overflow)
    return hit, z


def _walk_lists(prep, *, height: int, width: int, tile_h: int, tile_w: int):
    out = raster_tiles(prep["coef"], prep["lists"], prep["starts"],
                       prep["counts"], num_tx=prep["num_tx"], tile_h=tile_h,
                       tile_w=tile_w, cap=prep["cap"])
    return _frame_hit(prep, out, height=height, width=width, tile_h=tile_h,
                      tile_w=tile_w, overflow=prep["overflow"])


def rasterize_sorted(world_verts: torch.Tensor, tri_vertices: torch.Tensor,
                     num_faces, view_proj: torch.Tensor, *, height: int,
                     width: int, tile_h: int = 8, tile_w: int = 128,
                     cap: int = 2048, pairs_cap: int | None = None,
                     caps_scale: int = 1, cull_sign=None,
                     walker: str = "steps", src_map=None, face_mask=None,
                     proj_height: int | None = None, y_offset=None
                     ) -> Tuple[HitRecord, torch.Tensor]:
    """Visibility raster with sort-built exact per-tile lists.  ``cap``
    bounds one tile's list, ``pairs_cap`` the emitted pair stream (default
    6x the slot count, 4x with culling); both scale with ``caps_scale``
    (the renderer's overflow response).  Any capacity overflow sets
    ``HitRecord.overflow``.  ``src_map`` maps compacted face indices to
    the scene's face ids; ``face_mask`` (F,) keeps only the faces it marks
    (the LOD selection).  ``walker`` names the JAX package's two list
    walkers, K1 ("steps") and K7 ("tileloop", one grid step per tile);
    both run kernel R, whose schedule is K7's.  A band renders rows
    [y_offset, y_offset + height) of a ``proj_height``-row frame.  Returns
    (HitRecord, depth image)."""
    if walker not in ("steps", "tileloop"):
        raise ValueError(f"unknown walker {walker!r}")
    prep = prepare_sorted(world_verts, tri_vertices, num_faces, view_proj,
                          height=height, width=width, tile_h=tile_h,
                          tile_w=tile_w, cap=cap, pairs_cap=pairs_cap,
                          caps_scale=caps_scale, cull_sign=cull_sign,
                          src_map=src_map, face_mask=face_mask,
                          proj_height=proj_height, y_offset=y_offset)
    return _walk_lists(prep, height=height, width=width, tile_h=tile_h,
                       tile_w=tile_w)


def rasterize_binned(world_verts: torch.Tensor, tri_vertices: torch.Tensor,
                     num_faces, view_proj: torch.Tensor, *, height: int,
                     width: int, tile_h: int = 8, tile_w: int = 128,
                     cap_groups: int = 64, caps_scale: int = 1,
                     cull_sign=None, face_mask=None,
                     proj_height: int | None = None, y_offset=None
                     ) -> Tuple[HitRecord, torch.Tensor]:
    """Visibility raster with per-tile lists of 8-slot Morton groups
    (``vri_tpu``'s ``rasterize_binned``), walked by kernel R.  A tile
    holding more than ``cap_groups * caps_scale`` groups walks only the
    first and is counted in ``HitRecord.overflow``; ``face_mask`` as in
    :func:`rasterize_sorted`, and so are the band arguments.  Returns
    (HitRecord, depth image)."""
    prep = prepare_binned(world_verts, tri_vertices, num_faces, view_proj,
                          height=height, width=width, tile_h=tile_h,
                          tile_w=tile_w, cap_groups=cap_groups,
                          caps_scale=caps_scale, cull_sign=cull_sign,
                          face_mask=face_mask, proj_height=proj_height,
                          y_offset=y_offset)
    return _walk_lists(prep, height=height, width=width, tile_h=tile_h,
                       tile_w=tile_w)


def rasterize(world_verts: torch.Tensor, tri_vertices: torch.Tensor,
              num_faces, view_proj: torch.Tensor, *, height: int,
              width: int, tile_h: int = 8, tile_w: int = 128,
              cull_sign=None, face_mask=None,
              proj_height: int | None = None, y_offset=None
              ) -> Tuple[HitRecord, torch.Tensor]:
    """The capacity-free ranged raster (``vri_tpu``'s ``rasterize``,
    kernel K6), walked by ``raster_ranged``.  It reports no overflow
    (``HitRecord.overflow`` is None); ``face_mask`` and the band
    arguments as in :func:`rasterize_sorted`.  Returns (HitRecord, depth
    image)."""
    prep = prepare_ranged(world_verts, tri_vertices, num_faces, view_proj,
                          height=height, width=width, tile_h=tile_h,
                          tile_w=tile_w, cull_sign=cull_sign,
                          face_mask=face_mask, proj_height=proj_height,
                          y_offset=y_offset)
    out = raster_ranged(prep["coef"], prep["order"], prep["ranges"],
                        prep["words"], n_global=prep["n_global"],
                        num_tx=prep["num_tx"], tile_h=tile_h, tile_w=tile_w)
    return _frame_hit(prep, out, height=height, width=width, tile_h=tile_h,
                      tile_w=tile_w, overflow=None)
