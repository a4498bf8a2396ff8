"""Plain lightloop of the production temporal GI frame.

From a G-buffer (``visibility.visibility``) and cascades (``sdf.build``):

* direct light: for every ``shadow_scale``-th pixel of every
  ``shadow_scale``-th row a shadow ray to each light, lifted off the
  surface by 0.75 of the finest voxel there and ending two lifts short of
  the light, marched through the cascades; the visibility upsampled to
  every pixel, times the lights' N.L, inverse-square falloff (at least
  the 0.1 light radius squared), intensity and colour;
* indirect light: at every ``gi_scale``-th pixel and row one
  cosine-weighted ray a sample (from the frame's uniforms), lifted the
  same way and marched to half the coarsest cascade's span; a hit reads
  the voxel's shading row: albedo times baked irradiance plus emissive,
  clamped to 4, the normal turned to face the ray; a miss sees the sky;
* the history: each GI pixel reprojected through the previous frame's
  camera and blended bilinearly from the previous history (taps on the
  screen, depth within 2% widened by the screen velocity, normals within
  60 degrees, with a history of their own), then a running mean capped
  at ``history_cap`` frames, upsampled to every pixel;
* colour = emissive + albedo * (direct + indirect).

The march is the plain version of the frame's voxel march, from a frozen
copy of the program's reference march (kernel M's plain version), read
from boolean grids instead of packed words: a ray steps through the
finest cascade holding it, skips empty 16^3 cells by their Chebyshev
distance, and in a cell holding a surface stops at the first surface
voxel it enters past a grace of 1.75 voxels; its step budget is twice
the configured steps plus 16.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.sdf import dot3, finest_voxel_size

BIG = 3.0e38
LIGHT_RADIUS = 0.1
GI_CLAMP = 4.0
BIAS_VOXELS = 0.75
GRACE_VOXELS = 1.75
DEPTH_TOL = 0.02
BAKE_SHADOW_STEPS = 32


def _steps(steps: int) -> int:
    return steps * 2 + 16


def march(cas: dict, origins, dirs, t_max, max_steps: int):
    """(t, hit voxel flat index or -1) of each ray."""
    vs, org, r = cas["vs"], cas["origins"], cas["r"]
    n_cas = vs.shape[0]
    s = r // 16
    surf = cas["surf"].reshape(-1)
    coarse = cas["coarse"].reshape(-1)
    m = origins.shape[0]
    dev = origins.device
    f32, i32 = torch.float32, torch.int32
    t_max = torch.as_tensor(t_max, dtype=f32, device=dev).expand(m)
    # clipmap entry
    t_grace = GRACE_VOXELS * finest_voxel_size(vs, org, r, origins)
    lo = org[-1]
    hi = lo + r * vs[-1]
    inv_d = 1.0 / torch.where(torch.abs(dirs) < 1e-12,
                              torch.full_like(dirs, 1e-12), dirs)
    t0s = (lo - origins) * inv_d
    t1s = (hi - origins) * inv_d
    t_enter = torch.minimum(t0s, t1s).max(-1).values
    t_exit = torch.maximum(t0s, t1s).min(-1).values
    t = torch.minimum(torch.clamp(t_enter + 1e-4, min=1e-3), t_max)
    never = t_exit < torch.clamp(t_enter, min=0.0)
    t = torch.where(never, t_max + 1.0, t)

    ox, oy, oz = origins.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    vsl_c = vs[-1]
    inv = [1.0 / vs[i] for i in range(n_cas)]
    big = torch.full((m,), BIG, dtype=f32, device=dev)

    def exit_t(lo_, width, ls, vsl):
        out = big
        for d, l, lo_ax in zip((dx, dy, dz), ls, lo_):
            tgt = torch.where(d > 0, lo_ax + width, lo_ax)
            ad = torch.abs(d)
            small = ad < 1e-9
            safe = torch.where(small, torch.full_like(ad, 1e-9), ad)
            out = torch.minimum(out, torch.where(
                small, big, torch.abs(tgt - l) * vsl / safe))
        return torch.clamp(out, min=0.0)

    act = t < t_max
    hv = torch.full((m,), -1, dtype=i32, device=dev)
    it = torch.zeros((m,), dtype=i32, device=dev)
    zero = torch.zeros((m,), dtype=f32, device=dev)
    for _ in range(max_steps):
        marched = act & (it < max_steps)
        if not bool(marched.any()):
            break
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        cas_i = torch.full((m,), n_cas, dtype=i32, device=dev)
        lx = ly = lz = zero
        vsl = zero + vsl_c
        for c in reversed(range(n_cas)):
            lxi = (px - org[c, 0]) * inv[c]
            lyi = (py - org[c, 1]) * inv[c]
            lzi = (pz - org[c, 2]) * inv[c]
            ins = ((lxi >= 0) & (lxi < r) & (lyi >= 0) & (lyi < r)
                   & (lzi >= 0) & (lzi < r))
            cas_i = torch.where(ins, torch.full_like(cas_i, c), cas_i)
            lx = torch.where(ins, lxi, lx)
            ly = torch.where(ins, lyi, ly)
            lz = torch.where(ins, lzi, lz)
            vsl = torch.where(ins, vs[c], vsl)
        inside = cas_i < n_cas
        cc = torch.clamp(cas_i, max=n_cas - 1)
        vx = torch.clamp(lx.to(i32), 0, r - 1)
        vy = torch.clamp(ly.to(i32), 0, r - 1)
        vz = torch.clamp(lz.to(i32), 0, r - 1)
        cx, cy, cz = vx // s, vy // s, vz // s
        cd = coarse[(cc * 4096 + (cz * 16 + cy) * 16 + cx).long()]
        near = inside & (cd == 0)
        flat = cc * r ** 3 + (vz * r + vy) * r + vx
        occ = surf[flat.long()]
        hit_now = marched & near & occ & (t >= t_grace)
        ls = (lx, ly, lz)
        vox_exit = exit_t((vx.float(), vy.float(), vz.float()), 1.0, ls, vsl)
        cell_exit = exit_t(((cx * s).float(), (cy * s).float(),
                            (cz * s).float()), float(s), ls, vsl)
        skip = torch.maximum(cell_exit, (cd.float() - 1.0) * (vsl * s)) \
            + 0.05 * vsl
        adv = torch.where(near, vox_exit + 0.01 * vsl, skip)
        adv = torch.where(inside, adv, vsl_c)
        escaped = marched & ~inside & (t > t_enter + 1e-3)
        new_t = t + adv
        over = new_t >= t_max
        hv = torch.where(hit_now, flat, hv)
        act = act & ~(marched & (hit_now | over | escaped))
        t = torch.where(marched & ~hit_now, new_t, t)
        it = it + marched.to(i32)
    return t, hv


def _lights(arrays, device):
    def f(k):
        return torch.as_tensor(arrays[k], dtype=torch.float32, device=device)
    return f("light_position"), f("light_color"), f("light_intensity")


def _bias(cas, points):
    return BIAS_VOXELS * finest_voxel_size(cas["vs"], cas["origins"],
                                           cas["r"], points)


def shadow(cas, points, normals, lp, steps):
    """Visibility (N, L) of point lights ``lp`` from lifted points."""
    bias = _bias(cas, points)[:, None]                      # (N, 1)
    to_l = lp[None, :, :] - points[:, None, :]
    dist = torch.sqrt(dot3(to_l, to_l))
    wi = to_l / torch.clamp(dist, min=1e-12)[..., None]
    t_max = torch.clamp((dist - 2.0 * bias).reshape(-1), min=1e-3)
    o = (points[:, None, :] + normals[:, None, :] * bias[..., None]).expand(
        -1, lp.shape[0], 3).reshape(-1, 3)
    _, hv = march(cas, o, wi.reshape(-1, 3), t_max, _steps(steps))
    return (1.0 - (hv >= 0).float()).reshape(points.shape[0], -1)


def direct(points, normals, occ, lp, lc, li):
    to_l = lp[None, :, :] - points[:, None, :]
    dist = torch.sqrt(dot3(to_l, to_l))
    wi = to_l / torch.clamp(dist, min=1e-12)[..., None]
    ndotl = torch.clamp(dot3(normals[:, None, :], wi), min=0.0)
    falloff = 1.0 / torch.clamp(dist * dist, min=LIGHT_RADIUS ** 2)
    irr = li[None, :] * ndotl * occ * falloff
    return (irr[..., None] * lc[None, :, :]).sum(1)


def bake(cas, centers, normals, arrays, sdf, quantize=None):
    """Irradiance (B, 3) at brick centers lifted along their normals."""
    q = quantize or (lambda t: t)
    lp, lc, li = _lights(arrays, centers.device)
    pts = q(centers + normals * _bias(cas, centers)[:, None])
    occ = shadow(cas, pts, normals, lp, BAKE_SHADOW_STEPS)
    return direct(pts, normals, occ, lp, lc, li)


def cosine_dirs(n, u):
    """Cosine-weighted directions about unit normals n from uniforms u."""
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b,
                     -sign * n[:, 0]], -1)
    bt = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return t * x[:, None] + bt * y[:, None] + n * z[:, None]


def _sub(h, w, s, device):
    ys = torch.arange(0, h, s, device=device)
    xs = torch.arange(0, w, s, device=device)
    return (ys[:, None] * w + xs[None, :]).reshape(-1)


def _up(a, hs, ws, s):
    rest = tuple(a.shape[1:])
    a = a.reshape((hs, ws) + rest)
    a = a.repeat_interleave(s, 0).repeat_interleave(s, 1)
    return a.reshape((hs * s * ws * s,) + rest)


def reproject(prev, view_proj, eye, position, normal, valid, h, w):
    """Bilinear history (indirect, count) of each point, from the
    previous frame's history ``prev`` (h * w, 8) and camera."""
    clip = (position[:, 0:1] * view_proj[:, 0]
            + position[:, 1:2] * view_proj[:, 1]
            + position[:, 2:3] * view_proj[:, 2] + view_proj[:, 3])
    cw = clip[:, 3]
    ndc = clip[:, :3] / torch.clamp(cw, min=1e-6)[:, None]
    px = (ndc[:, 0] * 0.5 + 0.5) * w - 0.5
    py = (0.5 - ndc[:, 1] * 0.5) * h - 0.5
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx = px - x0.float()
    fy = py - y0.float()
    n = position.shape[0]
    ar = torch.arange(n, dtype=torch.float32, device=position.device)
    vel = torch.sqrt((px - ar % w) ** 2 + (py - torch.floor(ar / w)) ** 2)
    tol = DEPTH_TOL * (1.0 + 0.25 * torch.clamp(vel, max=8.0))
    t_prev = torch.sqrt(dot3(position - eye[None, :], position - eye[None, :]))
    ind = torch.zeros((n, 3), device=position.device)
    cnt = torch.zeros((n,), device=position.device)
    wsum = torch.zeros((n,), device=position.device)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = ((cw > 1e-6) & (xi >= 0) & (xi < w) & (yi >= 0)
                      & (yi < h))
            f = prev[(torch.clamp(yi, 0, h - 1) * w
                      + torch.clamp(xi, 0, w - 1)).long()]
            depth_ok = torch.abs(f[:, 3] - t_prev) <= tol * t_prev + 1e-3
            normal_ok = dot3(f[:, 4:7], normal) > 0.5
            ok = inside & depth_ok & normal_ok & (f[:, 7] > 0.0)
            wgt = torch.where(ok, (fy if dy else 1.0 - fy)
                              * (fx if dx else 1.0 - fx), 0.0)
            ind = ind + f[:, 0:3] * wgt[:, None]
            cnt = cnt + f[:, 7] * wgt
            wsum = wsum + wgt
    scale = 1.0 / torch.clamp(wsum, min=1e-6)
    ok = valid & (wsum > 0.05)
    return (torch.where(ok[:, None], ind * scale[:, None], 0.0),
            torch.where(ok, cnt * scale, 0.0))


def temporal_frame(vis, cas, arrays, cfg, uniforms, prev, quantize=None):
    """Colour (H * W, 3) and new history (GI pixels, 8) of one production
    frame from the G-buffer ``vis``, the cascades ``cas``, the frame's
    uniforms (samples, GI pixels, 2) and the previous history
    ``prev = (data, view_proj, eye)``."""
    q = quantize or (lambda t: t)
    h, w = cfg["height"], cfg["width"]
    fr, sdf = cfg["frame"], cfg["sdf"]
    dev = vis["position"].device
    pos = vis["position"].float()
    nrm = vis["normal"].float()
    alb, emi = vis["albedo"].float(), vis["emissive"].float()
    valid = vis["valid"]
    eye = vis["eye"].float()
    lp, lc, li = _lights(arrays, dev)

    ss = sdf["shadow_scale"]
    si = _sub(h, w, ss, dev)
    occ = q(shadow(cas, pos[si], nrm[si], lp, sdf["shadow_steps"]))
    dir_l = direct(pos, nrm, _up(occ, h // ss, w // ss, ss), lp, lc, li)

    g = fr["gi_scale"]
    gi = _sub(h, w, g, dev)
    gp, gn, gv = pos[gi], nrm[gi], valid[gi]
    sky = torch.as_tensor(cfg["sky_color"], dtype=torch.float32, device=dev)
    gi_range = cas["vs"][-1] * cas["r"] * sdf["gi_range_factor"]
    ind = torch.zeros((gp.shape[0], 3), device=dev)
    for k in range(fr["samples"]):
        o = gp + gn * _bias(cas, gp)[:, None]
        wi = cosine_dirs(gn, uniforms[k].float())
        _, hv = march(cas, o, wi, gi_range, _steps(sdf["gi_steps"]))
        sh = cas["voxel_shade"][torch.clamp(hv, min=0).long()].float()
        bounce = torch.clamp(sh[:, 0:3] * sh[:, 6:9] + sh[:, 9:12],
                             max=GI_CLAMP)
        ind = ind + torch.where((hv >= 0)[:, None], bounce, sky[None, :])
    ind = q(ind / fr["samples"])

    data, view_proj, peye = prev
    hs, ws = h // g, w // g
    h_ind, h_cnt = reproject(q(data.float()), view_proj.float(),
                             peye.float(), gp, gn, gv, hs, ws)
    count = torch.clamp(h_cnt, max=fr["history_cap"]) + 1.0
    ind_state = h_ind + (ind - h_ind) / count[:, None]
    t_s = torch.sqrt(dot3(gp - eye[None, :], gp - eye[None, :]))
    state = torch.cat([ind_state, t_s[:, None], gn, count[:, None]], 1)
    color = emi + alb * (dir_l + _up(ind_state, hs, ws, g))
    color = torch.where(valid[:, None], color, 0.0)
    return {"color": q(color), "state": q(state)}
