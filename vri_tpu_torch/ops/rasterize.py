"""Sort-binned tiled visibility raster (counterpart of the sorted path of
``vri_tpu/ops/rasterize.py``, ``rasterize_sorted``).

Per frame:

1. ``triangle_setup_clipped``: clip-space transform, near-plane clipping
   (each source triangle owns up to two clipped slots; second slots are
   compacted into a counted ``extra_cap``), the USD cull sign, and pixel
   space projection.
2. Exact emission: every visible slot emits one (tile, slot) pair per
   8x128 tile its screen bbox covers, in slot order; pairs beyond
   ``pairs_cap`` are dropped and counted.
3. One stable sort on the tile key turns the pair stream into per-tile
   lists (``_segment_lists``); a list longer than ``cap`` is walked only
   to ``cap`` and counted.
4. Kernel R (``raster_tiles``, ``csrc/raster_tiles.cu``) walks each tile's
   list and returns the winner slot, its quantized depth and the
   perspective-correct source barycentrics (u, v) from the slot's
   rational-affine fields (un, vn, den) -- the JAX package's fused resolve.

The TPU-only layers of the JAX path -- the bf16 cascade split of the
edge coefficients, the packed work-list words and the grouped-tile
packing -- have no counterpart: the kernel evaluates every field in
scalar FP32 and walks each tile's own list.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vri_tpu_torch import _cuda
from vri_tpu_torch.ops.intersect import HitRecord

_BIG = 3.0e38
_MISS_KEY = 0x40000000           # bit pattern of 2.0f: the key of a miss
_NCOEF = 24                      # see slot_coefficients


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
                           cull_sign: torch.Tensor | None = None):
    """Near-plane-clipped triangle setup (vectorized Sutherland-Hodgman
    against w = eps).  Each output corner carries its source-triangle
    barycentrics so hits map back to the authored triangle.

    Returns (tx, ty, tz, inv_w, bary1, bary2, src_id, valid,
    clip_overflow); the per-corner arrays are (S, 3) with S = F + E slots
    (E = ``extra_cap`` compacted second slots, or F when None)."""
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
    bt = torch.tensor([[[0., 0.], [1., 0.], [0., 1.]],
                       [[1., 0.], [0., 1.], [0., 0.]],
                       [[0., 1.], [0., 0.], [1., 0.]]],
                      dtype=torch.float32, device=dev)
    br = torch.where(sel == 1, bt[1], torch.where(sel == 2, bt[2], bt[0]))
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
    if cull_sign is not None:
        # backface culling from the homogeneous [x y w] determinant (the
        # orientation as seen, valid on both sides of the near plane)
        cw = c[..., 3]
        cx, cy = c[..., 0], c[..., 1]
        dhom = (cx[:, 0] * (cy[:, 1] * cw[:, 2] - cy[:, 2] * cw[:, 1])
                - cy[:, 0] * (cx[:, 1] * cw[:, 2] - cx[:, 2] * cw[:, 1])
                + cw[:, 0] * (cx[:, 1] * cy[:, 2] - cx[:, 2] * cy[:, 1]))
        in_range &= (cull_sign == 0.0) | (dhom * cull_sign > 0.0)
    ids = torch.arange(f, dtype=torch.int32, device=dev)
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
    tz = ndc[..., 2]
    area = ((tx[:, 1] - tx[:, 0]) * (ty[:, 2] - ty[:, 0])
            - (ty[:, 1] - ty[:, 0]) * (tx[:, 2] - tx[:, 0]))
    valid &= torch.abs(area) > 1e-12
    return (tx, ty, tz, inv_w, bary[..., 0], bary[..., 1], src_id, valid,
            clip_overflow)


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
    origin: (a*lx + b*ly) + c -- kernel R's order."""
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
    pix = torch.arange(P, device=dev)
    px = 0.5 + (pix % tile_w).float()
    py = 0.5 + (pix // tile_w).float()
    tid = torch.arange(T, device=dev)
    fx0 = ((tid % num_tx) * tile_w).float()
    fy0 = ((tid // num_tx) * tile_h).float()
    n = torch.clamp(counts.long(), max=cap)
    s0 = starts[:T].long()
    maxn = int(n.max()) if T else 0
    # list positions per vectorized step, bounding the (T, chunk, P) temps
    chunk = max(1, min(64, (1 << 24) // max(T * P, 1)))
    never = torch.iinfo(torch.int64).max
    best = torch.full((T, P), never, dtype=torch.int64, device=dev)
    last = max(lists.shape[0] - 1, 0)
    for i0 in range(0, maxn, chunk):
        pos = torch.arange(i0, min(i0 + chunk, maxn), device=dev)
        live = pos[None, :] < n[:, None]                      # (T, C)
        slot = lists[torch.clamp(s0[:, None] + pos[None, :], max=last)]
        c = coef[slot.long()]                                 # (T, C, 24)
        gx = fx0[:, None, None] + px
        gy = fy0[:, None, None] + py
        z = _field(c, 8, gx - c[..., 20, None], gy - c[..., 21, None])
        ok = _covers(c, gx, gy) & (z >= 0.0) & (z <= 1.0)
        zm = torch.where(ok, z, 2.0)
        key = (zm.view(torch.int32) & ~127).to(torch.int64)
        comp = (key << 32) | pos[None, :, None]
        comp = torch.where(live[..., None], comp, never)
        best = torch.minimum(best, comp.min(dim=1).values)
    key = best >> 32
    hit = key < _MISS_KEY
    win = torch.where(hit, best & 0xFFFFFFFF, 0)
    slot = lists[torch.clamp(s0[:, None] + win, max=last)].long() \
        if lists.numel() else torch.zeros_like(win)
    c = coef[slot] if lists.numel() else torch.zeros(
        (T, P, _NCOEF), dtype=torch.float32, device=dev)
    lx = (fx0[:, None] + px) - c[..., 20]
    ly = (fy0[:, None] + py) - c[..., 21]

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


def raster_tiles(coef: torch.Tensor, lists: torch.Tensor,
                 starts: torch.Tensor, counts: torch.Tensor, *, num_tx: int,
                 tile_h: int = 8, tile_w: int = 128, cap: int = 2048):
    """Kernel R wrapper (see :func:`raster_tiles_reference`): CUDA tensors
    launch ``csrc/raster_tiles.cu``; CPU tensors run the plain version.
    ``coef`` (S, 24) f32 slot table (:func:`slot_coefficients`), ``lists`` (pairs,) i32 slot
    ids in tile order, ``starts`` (T+1,) / ``counts`` (T,) i32."""
    T = counts.shape[0]
    P = tile_h * tile_w
    if coef.dtype != torch.float32 or coef.dim() != 2 \
            or coef.shape[1] != _NCOEF:
        raise ValueError(f"coef must be (S, {_NCOEF}) float32, got "
                         f"{tuple(coef.shape)} {coef.dtype}")
    for name, x in (("lists", lists), ("starts", starts),
                    ("counts", counts)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if starts.shape[0] != T + 1:
        raise ValueError("starts must hold one more entry than counts")
    if not 1 <= P <= 1024:
        raise ValueError(f"tile of {P} pixels exceeds one thread block")
    tensors = (coef, lists, starts, counts)
    if all(x.device.type == "cpu" for x in tensors):
        return raster_tiles_reference(coef, lists, starts, counts,
                                      num_tx=num_tx, tile_h=tile_h,
                                      tile_w=tile_w, cap=cap)
    if not all(x.is_cuda and x.device == coef.device for x in tensors):
        raise ValueError("raster_tiles: inputs must all be on one CUDA "
                         "device (or all on the CPU)")
    coef, lists, starts, counts = (x.contiguous() for x in tensors)
    dev = coef.device
    z = torch.empty((T, P), dtype=torch.float32, device=dev)
    slot = torch.empty((T, P), dtype=torch.int32, device=dev)
    u = torch.empty((T, P), dtype=torch.float32, device=dev)
    v = torch.empty((T, P), dtype=torch.float32, device=dev)
    code = _cuda.library().vri_raster_tiles(
        coef.data_ptr(), lists.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), T, num_tx, tile_h, tile_w, cap, z.data_ptr(),
        slot.data_ptr(), u.data_ptr(), v.data_ptr(), _cuda.stream_ptr(coef))
    _cuda.check(code, "raster_tiles")
    raster_tiles.launches += 1
    return z, slot, u, v


raster_tiles.launches = 0


def slot_coefficients(tx, ty, tz, tw, b1, b2, valid):
    """(S, 24) per-slot table for kernel R.  Columns: 0-5 the corners
    (x0 y0 x1 y1 x2 y2) in global pixel coordinates for the edge tests, 6
    the sign of the screen area, 7 pad; then affine (a, b, c) triples in
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
                      ty[:, 2], sign, zero], dim=1),
         fields, torch.stack([ox, oy, zero, zero], dim=1)],
        dim=1).contiguous()


def prepare_sorted(world_verts, tri_vertices, num_faces, view_proj, *,
                   height: int, width: int, tile_h: int = 8,
                   tile_w: int = 128, cap: int = 2048,
                   pairs_cap: int | None = None, caps_scale: int = 1,
                   cull_sign=None):
    """Everything before the walk: setup, exact emission and the per-tile
    lists.  Returns a dict with the kernel's inputs (coef, lists, starts,
    counts, cap, num_tx), the slot-to-triangle map ``src`` and the
    ``overflow`` flag (0-d int32)."""
    tc = 128                           # slot padding quantum
    cap = _round_up(cap * caps_scale, tc)
    if pairs_cap is not None:
        pairs_cap = pairs_cap * caps_scale
    hp = _round_up(height, tile_h)
    wp = _round_up(width, tile_w)
    gy, gx = hp // tile_h, wp // tile_w
    num_tiles = gy * gx
    dev = world_verts.device

    extra = max(tri_vertices.shape[0] // 16, 256) * caps_scale
    tx, ty, tz, tw, b1, b2, src, valid, clip_over = triangle_setup_clipped(
        world_verts, tri_vertices, num_faces, view_proj, height, width,
        extra_cap=extra, cull_sign=cull_sign)
    f2 = tx.shape[0]
    fp = _round_up(f2 + 1, tc)         # >= 1 guaranteed-invalid pad slot
    pad = fp - f2

    def padf(a):
        return torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                         device=dev)])
    tx, ty, tz, tw, b1, b2, valid, src = map(
        padf, (tx, ty, tz, tw, b1, b2, valid, src))
    tz = torch.where(valid[:, None], tz, 10.0)

    # per-slot inclusive tile span from the screen bbox
    lox, hix = tx.min(dim=1).values, tx.max(dim=1).values
    loy, hiy = ty.min(dim=1).values, ty.max(dim=1).values
    tx0 = _to_i32(torch.floor(lox / tile_w))
    tx1 = _to_i32(torch.floor(hix / tile_w))
    ty0 = _to_i32(torch.floor(loy / tile_h))
    ty1 = _to_i32(torch.floor(hiy / tile_h))
    on_screen = (tx1 >= 0) & (tx0 < gx) & (ty1 >= 0) & (ty0 < gy)
    vis = valid & on_screen
    if pairs_cap is None:
        # backface culling roughly halves the live pairs on solid scenes
        mult = 6 if cull_sign is None else 4
        pairs_cap = max(min(mult * fp, 2 * 1024 * 1024),
                        128 * 1024) * caps_scale
    pairs_cap = _round_up(pairs_cap, tc)

    # exact emission: slot-major, row-major over each slot's tile window
    ry0 = torch.clamp(ty0, 0, gy - 1).long()
    rx0 = torch.clamp(tx0, 0, gx - 1).long()
    zero = torch.zeros_like(ry0)
    e_rows = torch.where(vis, torch.clamp(ty1, 0, gy - 1) - ry0 + 1, zero)
    e_cols = torch.where(vis, torch.clamp(tx1, 0, gx - 1) - rx0 + 1, zero)
    area_t = e_rows * e_cols
    total = int(area_t.sum())
    emit_over = max(total - pairs_cap, 0)
    sid = torch.repeat_interleave(
        torch.arange(fp, device=dev), area_t, output_size=total)[:pairs_cap]
    starts_x = torch.cumsum(area_t, 0) - area_t
    k_local = torch.arange(sid.shape[0], device=dev) - starts_x[sid]
    cols = e_cols[sid]
    dy = torch.div(k_local, cols, rounding_mode="floor")
    dx = k_local - dy * cols
    tile_of = (ry0[sid] + dy) * gx + rx0[sid] + dx
    lists, starts, counts = _segment_lists(tile_of, sid, num_tiles)
    overflow = ((counts > cap).any() | (emit_over > 0)
                | (clip_over > 0)).to(torch.int32)
    return dict(coef=slot_coefficients(tx, ty, tz, tw, b1, b2, valid),
                lists=lists, starts=starts, counts=counts, cap=cap,
                num_tx=gx, grid=(gy, gx), src=src, overflow=overflow)


def rasterize_sorted(world_verts: torch.Tensor, tri_vertices: torch.Tensor,
                     num_faces, view_proj: torch.Tensor, *, height: int,
                     width: int, tile_h: int = 8, tile_w: int = 128,
                     cap: int = 2048, pairs_cap: int | None = None,
                     caps_scale: int = 1, cull_sign=None
                     ) -> Tuple[HitRecord, torch.Tensor]:
    """Visibility raster with sort-built exact per-tile lists.  ``cap``
    bounds one tile's list, ``pairs_cap`` the emitted pair stream (default
    6x the slot count, 4x with culling); both scale with ``caps_scale``
    (the renderer's overflow response).  Any capacity overflow sets
    ``HitRecord.overflow``.  Returns (HitRecord, depth image)."""
    prep = prepare_sorted(world_verts, tri_vertices, num_faces, view_proj,
                          height=height, width=width, tile_h=tile_h,
                          tile_w=tile_w, cap=cap, pairs_cap=pairs_cap,
                          caps_scale=caps_scale, cull_sign=cull_sign)
    z, slot, u, v = raster_tiles(prep["coef"], prep["lists"],
                                 prep["starts"], prep["counts"],
                                 num_tx=prep["num_tx"], tile_h=tile_h,
                                 tile_w=tile_w, cap=prep["cap"])
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
                    overflow=prep["overflow"])
    return hit, z
