"""Plain visibility and G-buffer: the nearest triangle along each pixel's
camera ray, by ray casting in float64.

The camera is rebuilt from the stage's eye, target, vertical field of
view and clipping range (right-handed, +Y up, looking down -Z), with an
optional sub-pixel jitter given in NDC units.  Each triangle is tested
against the pixels inside its screen bounding box (a triangle crossing
the near plane is clipped to it first): a hit needs the barycentrics in
[0, 1], a view depth within [near, far], and for a single-sided instance
a front face (counter-clockwise seen from the camera).  The nearest hit
wins, ties to the lower triangle.  The G-buffer of the winner: world
position, unit geometric normal facing the viewer, the instance's
colours, and the ray distance as depth.
"""

from __future__ import annotations

import math

import torch

#: (pixel, triangle) pairs tested at once
PAIRS_PER_CHUNK = 1 << 23


def camera_rays(cam: dict, width: int, height: int, device,
                jitter_ndc=(0.0, 0.0), dtype=torch.float64):
    """Unit ray directions (H*W, 3) through the pixel centers, the eye
    and the forward axis."""
    f64 = dict(dtype=torch.float64, device=device)
    eye = torch.as_tensor(cam["eye"], **f64)
    fwd = torch.as_tensor(cam["target"], **f64) - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    up = torch.tensor([0.0, 1.0, 0.0], **f64)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    upv = torch.linalg.cross(right, fwd)
    th = math.tan(0.5 * math.radians(cam["fov_deg"]))
    aspect = width / height
    xs = (torch.arange(width, **f64) + 0.5) / width * 2.0 - 1.0 \
        - jitter_ndc[0]
    ys = 1.0 - (torch.arange(height, **f64) + 0.5) / height * 2.0 \
        - jitter_ndc[1]
    d = (fwd[None, None, :]
         + (xs[None, :, None] * th * aspect) * right[None, None, :]
         + (ys[:, None, None] * th) * upv[None, None, :])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return (d.reshape(-1, 3).to(dtype), eye.to(dtype), fwd.to(dtype),
            right.to(dtype), upv.to(dtype), th, aspect)


def _screen_boxes(v, eye, fwd, right, upv, th, aspect, near, width, height,
                  jitter_ndc):
    """Inclusive pixel boxes (x0, y0, x1, y1) of each triangle (T, 3, 3),
    clipped to the screen; empty where nothing lies beyond ``near``."""
    rel = v - eye
    z = rel @ fwd                                            # (T, 3)
    x = rel @ right
    y = rel @ upv
    front = z > near
    pts_x, pts_y, pts_z, ok = [x], [y], [z], [front]
    # where an edge crosses the near plane, its crossing point bounds the
    # clipped polygon as well
    for i, j in ((0, 1), (1, 2), (2, 0)):
        cross = front[:, i] != front[:, j]
        den = torch.where(cross, z[:, j] - z[:, i], torch.ones_like(z[:, i]))
        s = (near - z[:, i]) / den
        pts_x.append((x[:, i] + s * (x[:, j] - x[:, i]))[:, None])
        pts_y.append((y[:, i] + s * (y[:, j] - y[:, i]))[:, None])
        pts_z.append(torch.full_like(s, near)[:, None])
        ok.append(cross[:, None])
    px, py = torch.cat(pts_x, 1), torch.cat(pts_y, 1)
    pz, ok = torch.cat(pts_z, 1), torch.cat(ok, 1)
    pz = torch.clamp(pz, min=near)
    sx = ((px / pz / (th * aspect) + jitter_ndc[0]) + 1.0) * 0.5 * width \
        - 0.5
    sy = (1.0 - (py / pz / th + jitter_ndc[1])) * 0.5 * height - 0.5
    inf = torch.full_like(sx, math.inf)
    x0 = torch.floor(torch.where(ok, sx, inf).min(1).values) - 1
    x1 = torch.ceil(torch.where(ok, sx, -inf).max(1).values) + 1
    y0 = torch.floor(torch.where(ok, sy, inf).min(1).values) - 1
    y1 = torch.ceil(torch.where(ok, sy, -inf).max(1).values) + 1
    live = ok.any(1) & torch.isfinite(x0) & torch.isfinite(y0)
    x0 = torch.clamp(torch.nan_to_num(x0, 0.0, 0.0, 0.0), 0, width - 1)
    x1 = torch.clamp(torch.nan_to_num(x1, 0.0, 0.0, 0.0), -1, width - 1)
    y0 = torch.clamp(torch.nan_to_num(y0, 0.0, 0.0, 0.0), 0, height - 1)
    y1 = torch.clamp(torch.nan_to_num(y1, 0.0, 0.0, 0.0), -1, height - 1)
    live = live & (x1 >= x0) & (y1 >= y0)
    return x0.long(), y0.long(), x1.long(), y1.long(), live


def visibility(arrays: dict, width: int, height: int, device,
               jitter_ndc=(0.0, 0.0), quantize=None) -> dict:
    """Nearest triangle and G-buffer of every pixel (row-major).

    ``quantize`` (the control) rounds the inputs and the stored results
    to a lower precision."""
    q = quantize or (lambda t: t)
    f64 = dict(dtype=torch.float64, device=device)
    v = q(torch.as_tensor(arrays["corners"], **f64))          # (T, 3, 3)
    tri_inst = torch.as_tensor(arrays["tri_instance"], device=device).long()
    single = ~torch.as_tensor(arrays["double_sided"], device=device)
    cam = {k: arrays[k] for k in ("eye", "target", "fov_deg", "near", "far")}
    cam["eye"] = q(torch.as_tensor(cam["eye"], **f64)).cpu().numpy()
    d, eye, fwd, right, upv, th, aspect = camera_rays(
        cam, width, height, device, jitter_ndc)
    near, far = cam["near"], cam["far"]
    n_pix = width * height

    x0, y0, x1, y1, live = _screen_boxes(v, eye, fwd, right, upv, th,
                                         aspect, near, width, height,
                                         jitter_ndc)
    bw = (x1 - x0 + 1) * live
    bh = (y1 - y0 + 1) * live
    area = bw * bh
    ids = torch.nonzero(area > 0).reshape(-1)
    cum = torch.cumsum(area[ids], 0)

    best_t = torch.full((n_pix,), math.inf, **f64)
    best_tri = torch.full((n_pix,), -1, dtype=torch.int64, device=device)
    fragments = 0
    start, done = 0, 0
    total = int(cum[-1]) if ids.numel() else 0
    while done < total:
        # the next run of triangles whose boxes hold PAIRS_PER_CHUNK pairs
        stop = int(torch.searchsorted(cum, done + PAIRS_PER_CHUNK,
                                      right=True))
        stop = max(stop, start + 1)
        tid = ids[start:stop]
        cnt = area[tid]
        tri = torch.repeat_interleave(tid, cnt)
        base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        k = torch.arange(tri.numel(), device=device) - base
        px = x0[tri] + k % bw[tri]
        py = y0[tri] + k // bw[tri]
        pix = py * width + px
        a, b, c = v[tri, 0], v[tri, 1], v[tri, 2]
        dd = d[pix]
        e1, e2 = b - a, c - a
        pvec = torch.linalg.cross(dd, e2)
        det = (e1 * pvec).sum(-1)
        inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        s = eye - a
        u = (s * pvec).sum(-1) * inv
        qv = torch.linalg.cross(s, e1)
        w = (dd * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        zv = t * (dd @ fwd)
        # det = -d . ((b - a) x (c - a)): positive where the ray sees the
        # counter-clockwise side
        facing = det > 0
        hit = ((det != 0) & (u >= 0) & (w >= 0) & (u + w <= 1)
               & (zv >= near) & (zv <= far)
               & (facing | ~single[tri_inst[tri]]))
        fragments += int(hit.sum())
        pix, t, tri = pix[hit], t[hit], tri[hit]
        chunk_t = torch.full((n_pix,), math.inf, **f64)
        chunk_t.scatter_reduce_(0, pix, t, "amin")
        at_min = t == chunk_t[pix]
        cand = torch.full((n_pix,), 1 << 62, dtype=torch.int64,
                          device=device)
        cand.scatter_reduce_(0, pix[at_min], tri[at_min], "amin")
        better = chunk_t < best_t
        best_t = torch.where(better, chunk_t, best_t)
        best_tri = torch.where(better, cand, best_tri)
        done = int(cum[stop - 1])
        start = stop

    valid = best_tri >= 0
    tri = torch.clamp(best_tri, min=0)
    a, b, c = v[tri, 0], v[tri, 1], v[tri, 2]
    n = torch.linalg.cross(b - a, c - a)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-300)
    n = torch.where(((n * d).sum(-1) > 0)[:, None], -n, n)
    t = torch.where(valid, best_t, torch.zeros_like(best_t))
    inst = torch.where(valid, tri_inst[tri], torch.full_like(tri, -1))
    alb = torch.as_tensor(arrays["albedo"], **f64)[torch.clamp(inst, min=0)]
    emi = torch.as_tensor(arrays["emissive"], **f64)[torch.clamp(inst,
                                                                 min=0)]
    zero = torch.zeros_like(n)
    return {
        "valid": valid,
        "instance": inst,
        "depth": q(t),
        "position": q(eye + d * t[:, None]),
        "normal": q(torch.where(valid[:, None], n, zero)),
        "albedo": q(torch.where(valid[:, None], alb, zero)),
        "emissive": q(torch.where(valid[:, None], emi, zero)),
        "eye": eye,
        "fragments": fragments,
    }
