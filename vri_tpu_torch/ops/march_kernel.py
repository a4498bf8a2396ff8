"""Voxel-precision SDF march for occlusion and GI rays (counterpart of
``vri_tpu/ops/march_kernel.py``).

Rays march through the per-cascade 16^3 coarse cell grid (4-bit
Chebyshev distances in cell units) and, inside surface cells, test
per-voxel surface bits -- the tables ``sdf.build_march_tables`` packs.
One march serves the contracts of both ``march`` and ``march_stream`` of
the JAX package: their kernels give the same result per ray.  On the GPU
(``csrc/march_rays.cu``) persistent warps march one ray a lane and
refill a lane from a global ray counter when its ray ends -- K3's
persistent-lane queues, written for a warp.

``march_rays`` is the kernel's wrapper: it launches the CUDA kernel for
CUDA tensors and runs ``march_rays_reference``, the plain PyTorch version
with the same operation order, for CPU tensors.
"""

from __future__ import annotations

import torch

from vri_tpu_torch.config import SDFConfig
from vri_tpu_torch import _cuda
from vri_tpu_torch.ops.sdf import SDFCascades, cascade_origin
from vri_tpu_torch.ops.sdf_trace import BIG, SDFHit


def supports(config: SDFConfig) -> bool:
    r = config.cascade_resolution
    return r % 16 == 0 and r // 16 in (1, 2, 4)


def _log2s(r: int) -> int:
    return {1: 0, 2: 1, 4: 2}[r // 16]


def march_rays_reference(rays, meta, coarse, fine0, fine1, *, r: int,
                         max_steps: int):
    """Plain PyTorch version of kernel M: all rays step in lock-step with
    per-ray activity masks; each ray's trajectory is exactly the kernel's
    (same operations, same order, each rounded once).

    rays (10, m) f32 [ox oy oz dx dy dz t0 tmax tent tgrace]; meta
    (4, n_cas) f32 [voxel size, grid origin x, y, z].  Returns flat
    (t f32, hv i32, it i32, act i32)."""
    n_cas = meta.shape[1]
    s = r // 16
    log2s = _log2s(r)
    s3 = s ** 3
    ox, oy, oz, dx, dy, dz, t0, tmax, tent, tgrace = rays
    vs = [meta[0, i] for i in range(n_cas)]
    inv = [1.0 / v for v in vs]
    og = [(meta[1, i], meta[2, i], meta[3, i]) for i in range(n_cas)]
    vs_coarse = vs[-1]
    rf = float(r)
    dev = rays.device
    m = rays.shape[1]
    i32 = torch.int32
    big = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    zero_f = torch.zeros((m,), dtype=torch.float32, device=dev)
    coarse_f, fine0_f, fine1_f = (coarse.reshape(-1), fine0.reshape(-1),
                                  fine1.reshape(-1))

    def axis_exit(d, l, lo, width, vsl):
        tgt = torch.where(d > 0, lo + width, lo)
        ad = torch.abs(d)
        small = ad < 1e-9
        safe = torch.where(small, torch.full_like(ad, 1e-9), ad)
        return torch.where(small, big, torch.abs(tgt - l) * vsl / safe)

    def exit_t(lo, width, ls, vsl):
        out = big
        for d_ax, l_ax, lo_ax in zip((dx, dy, dz), ls, lo):
            out = torch.minimum(out, axis_exit(d_ax, l_ax, lo_ax, width, vsl))
        return torch.clamp(out, min=0.0)

    t = t0.clone()
    act = t0 < tmax
    hv = torch.full((m,), -1, dtype=i32, device=dev)
    it = torch.zeros((m,), dtype=i32, device=dev)
    cell = torch.full((m,), -1, dtype=i32, device=dev)
    w0 = torch.zeros((m,), dtype=i32, device=dev)
    w1 = torch.zeros((m,), dtype=i32, device=dev)
    for _ in range(max_steps):
        marched = act & (it < max_steps)
        if not bool(marched.any()):
            break
        px = ox + dx * t
        py = oy + dy * t
        pz = oz + dz * t
        cas = torch.full((m,), n_cas, dtype=i32, device=dev)
        lx, ly, lz = zero_f, zero_f, zero_f
        vsl = torch.full((m,), 0.0, dtype=torch.float32, device=dev) \
            + vs_coarse
        for c in reversed(range(n_cas)):
            lxi = (px - og[c][0]) * inv[c]
            lyi = (py - og[c][1]) * inv[c]
            lzi = (pz - og[c][2]) * inv[c]
            ins = ((lxi >= 0) & (lxi < rf) & (lyi >= 0) & (lyi < rf)
                   & (lzi >= 0) & (lzi < rf))
            cas = torch.where(ins, torch.full_like(cas, c), cas)
            lx = torch.where(ins, lxi, lx)
            ly = torch.where(ins, lyi, ly)
            lz = torch.where(ins, lzi, lz)
            vsl = torch.where(ins, vs[c], vsl)
        inside = cas < n_cas
        cas_c = torch.clamp(cas, max=n_cas - 1)
        vx = torch.clamp(lx.to(i32), 0, r - 1)
        vy = torch.clamp(ly.to(i32), 0, r - 1)
        vz = torch.clamp(lz.to(i32), 0, r - 1)
        ccx, ccy, ccz = vx >> log2s, vy >> log2s, vz >> log2s
        cflat = cas_c * 4096 + (ccz * 16 + ccy) * 16 + ccx
        word = coarse_f[(cflat >> 3).long()]
        cd = (word >> ((cflat & 7) * 4)) & 15
        near = inside & (cd == 0)
        need = marched & near & (cflat != cell)
        nw0 = fine0_f[cflat.long()]
        nw1 = fine1_f[cflat.long()] if s3 > 32 else nw0
        w0 = torch.where(need, nw0, w0)
        w1 = torch.where(need, nw1, w1)
        cell = torch.where(need, cflat, cell)
        bit = ((vz & (s - 1)) * s + (vy & (s - 1))) * s + (vx & (s - 1))
        wd = torch.where(bit < 32, w0, w1) if s3 > 32 else w0
        occ = (wd >> (bit & 31)) & 1
        hit_now = marched & near & (occ > 0) & (t >= tgrace)

        ls = (lx, ly, lz)
        vox_exit = exit_t((vx.float(), vy.float(), vz.float()), 1.0, ls, vsl)
        cell_exit = exit_t(((ccx << log2s).float(), (ccy << log2s).float(),
                            (ccz << log2s).float()), float(s), ls, vsl)
        cell_w = vsl * float(s)
        skip = torch.maximum(cell_exit, (cd.float() - 1.0) * cell_w) \
            + 0.05 * vsl
        adv = torch.where(near, vox_exit + 0.01 * vsl, skip)
        adv = torch.where(inside, adv, vs_coarse)
        escaped = marched & ~inside & (t > tent + 1e-3)
        new_t = t + adv
        over = new_t >= tmax
        hv = torch.where(hit_now,
                         cas_c * (r * r * r) + (vz * r + vy) * r + vx, hv)
        act = act & ~(marched & (hit_now | over | escaped))
        t = torch.where(marched & ~hit_now, new_t, t)
        it = it + marched.to(i32)
    return t, hv, it, act.to(i32)


def march_rays(rays: torch.Tensor, meta: torch.Tensor, coarse: torch.Tensor,
               fine0: torch.Tensor, fine1: torch.Tensor, *, r: int,
               max_steps: int):
    """Kernel M wrapper: flat (t, hv, it, act) for the rays in ``rays``
    (see :func:`march_rays_reference`).  CUDA tensors launch
    ``csrc/march_rays.cu``; CPU tensors run the plain version."""
    n_cas = meta.shape[1]
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 10:
        raise ValueError(f"rays must be (10, m) float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if meta.dtype != torch.float32 or meta.shape[0] != 4 or not 1 <= n_cas <= 16:
        raise ValueError(f"meta must be (4, n<=16) float32, got "
                         f"{tuple(meta.shape)}")
    for name, tab, rows in (("coarse", coarse, n_cas * 4),
                            ("fine0", fine0, n_cas * 32),
                            ("fine1", fine1, n_cas * 32)):
        if tab.dtype != torch.int32 or tuple(tab.shape) != (rows, 128):
            raise ValueError(f"{name} must be ({rows}, 128) int32, got "
                             f"{tuple(tab.shape)} {tab.dtype}")
    if r % 16 or r // 16 not in (1, 2, 4):
        raise ValueError(f"unsupported cascade resolution {r}")
    tensors = (rays, meta, coarse, fine0, fine1)
    if all(x.device.type == "cpu" for x in tensors):
        return march_rays_reference(rays, meta, coarse, fine0, fine1, r=r,
                                    max_steps=max_steps)
    if not all(x.is_cuda and x.device == rays.device for x in tensors):
        raise ValueError("march_rays: inputs must all be on one CUDA "
                         "device (or all on the CPU)")
    rays, meta, coarse, fine0, fine1 = (x.contiguous() for x in tensors)
    m = rays.shape[1]
    t = torch.empty((m,), dtype=torch.float32, device=rays.device)
    hv = torch.empty((m,), dtype=torch.int32, device=rays.device)
    it = torch.empty((m,), dtype=torch.int32, device=rays.device)
    act = torch.empty((m,), dtype=torch.int32, device=rays.device)
    # the persistent lanes' next-ray counter
    counter = torch.zeros((1,), dtype=torch.int32, device=rays.device)
    lib = _cuda.library()
    code = lib.vri_march_rays(
        rays.data_ptr(), m, meta.data_ptr(), n_cas, r, _log2s(r),
        coarse.data_ptr(), fine0.data_ptr(), fine1.data_ptr(), max_steps,
        t.data_ptr(), hv.data_ptr(), it.data_ptr(), act.data_ptr(),
        counter.data_ptr(), _cuda.stream_ptr(rays))
    _cuda.check(code, "march_rays")
    march_rays.launches += 1
    return t, hv, it, act


march_rays.launches = 0


def persistent_lanes(n_cas: int, m: int) -> int:
    """Lanes of a ``march_rays`` launch over ``m`` rays at ``n_cas``
    cascades on the current card: as many 256-lane blocks as fit the card
    at once, or fewer when ``m`` rays need fewer.  Every ray past them is
    taken by a refill."""
    lanes = _cuda.library().vri_march_lanes(n_cas, m)
    if lanes < 0:
        raise RuntimeError("march_rays: the occupancy query failed")
    return lanes


def warp_step_efficiency(it: torch.Tensor, warp: int = 32):
    """Divergence of a march with one ray a lane: the iteration counts
    ``it`` grouped in launch order, ``warp`` rays a warp (the last warp's
    idle lanes count as idle slots).  Returns (sum of it / sum over warps
    of warp x max it, mean it, max it): the share of warp-steps that did
    work, which a march that refills finished lanes can recover."""
    it = it.reshape(-1).to(torch.int64)
    m = it.shape[0]
    if m == 0:
        return 1.0, 0.0, 0
    pad = torch.zeros(((m + warp - 1) // warp * warp - m,),
                      dtype=torch.int64, device=it.device)
    per_warp = torch.cat([it, pad]).reshape(-1, warp).max(dim=1).values
    slots = float(per_warp.sum()) * warp
    total = float(it.sum())
    return (total / slots if slots else 1.0, total / m, int(it.max()))


def finest_voxel_size(sdf: SDFCascades, points: torch.Tensor,
                      config: SDFConfig) -> torch.Tensor:
    """Voxel size of the finest cascade containing each point (pure
    arithmetic, for bias and grace distances)."""
    r = config.cascade_resolution
    org = cascade_origin(sdf.center, sdf.voxel_size, r)        # (N, 3)
    local = (points[:, None, :] - org[None]) / sdf.voxel_size[None, :, None]
    inside = ((local >= 0) & (local < r)).all(-1)              # (M, N)
    inf = torch.full_like(local[..., 0], float("inf"))
    vs = torch.where(inside, sdf.voxel_size[None, :].expand_as(inf),
                     inf).min(-1).values
    return torch.where(torch.isfinite(vs), vs, sdf.voxel_size[-1])


def ray_table(sdf: SDFCascades, origins, dirs, t_max, config: SDFConfig,
              grace_voxels: float = 1.75) -> torch.Tensor:
    """(10, m) ray table the kernel reads: origin, direction and the
    clipmap entry (t_init, t_max, t_enter, t_grace), with rays that never
    meet the clipmap encoded as t_init = t_max + 1."""
    r = config.cascade_resolution
    m = origins.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=origins.device).expand(m).contiguous()
    t_grace = grace_voxels * finest_voxel_size(sdf, origins, config)
    vs_c = sdf.voxel_size[-1]
    lo = cascade_origin(sdf.center[-1], vs_c, r)
    hi = lo + r * vs_c
    inv_d = 1.0 / torch.where(torch.abs(dirs) < 1e-12,
                              torch.full_like(dirs, 1e-12), dirs)
    t0s = (lo - origins) * inv_d
    t1s = (hi - origins) * inv_d
    t_enter = torch.minimum(t0s, t1s).max(-1).values
    t_exit = torch.maximum(t0s, t1s).min(-1).values
    t_init = torch.minimum(torch.clamp(t_enter + 1e-4, min=1e-3), t_max)
    never = t_exit < torch.clamp(t_enter, min=0.0)
    t_init = torch.where(never, t_max + 1.0, t_init)
    return torch.stack([origins[:, 0], origins[:, 1], origins[:, 2],
                        dirs[:, 0], dirs[:, 1], dirs[:, 2],
                        t_init, t_max, t_enter, t_grace]).contiguous()


def pack_meta(sdf: SDFCascades, config: SDFConfig):
    """(4, n_cas) per-cascade voxel size and grid origin."""
    org = cascade_origin(sdf.center, sdf.voxel_size,
                         config.cascade_resolution)
    return torch.stack([sdf.voxel_size, org[:, 0], org[:, 1],
                        org[:, 2]]).contiguous()


def march(sdf: SDFCascades, origins: torch.Tensor, dirs: torch.Tensor,
          t_max, *, config: SDFConfig, max_steps: int | None = None,
          payload: bool = True, grace_voxels: float = 1.75) -> SDFHit:
    """Voxel-precision march with the ``SDFHit`` payload of
    ``sdf_trace.march``.  Hits within ``grace_voxels`` local voxels of the
    ray start are ignored (the ray's own surface band).  ``payload=False``
    skips the brick / uvw recovery: occlusion rays need only hit and t."""
    max_steps = max_steps or config.march_max_steps
    t, hv, it, _ = march_rays(
        ray_table(sdf, origins, dirs, t_max, config, grace_voxels),
        pack_meta(sdf, config), sdf.march_coarse, sdf.march_fine0,
        sdf.march_fine1, r=config.cascade_resolution, max_steps=max_steps)
    return _payload(sdf, config, origins, dirs, t, hv, it, payload)


def _payload(sdf: SDFCascades, config: SDFConfig, origins, dirs, t, hv, it,
             payload: bool) -> SDFHit:
    m = origins.shape[0]
    r = config.cascade_resolution
    hit = hv >= 0
    hv_c = torch.clamp(hv, min=0)
    cas = hv_c // (r * r * r)
    neg = torch.full_like(hv, -1)
    voxel = torch.where(hit, hv_c, neg)
    t_hit = torch.where(hit, t, torch.full_like(t, BIG))
    if not payload:
        return SDFHit(t=t_hit, hit=hit, iterations=it,
                      cascade=torch.where(hit, cas, neg),
                      brick=torch.where(hit, torch.zeros_like(hv), neg),
                      uvw=torch.zeros((m, 3), dtype=torch.float32,
                                      device=origins.device),
                      voxel=voxel)
    # hv is the flat (cascade-major) brick_map index of the hit voxel
    brick = torch.where(hit, sdf.brick_map.reshape(-1)[hv_c.long()], neg)
    p_hit = origins + dirs * t[:, None]
    orgs = cascade_origin(sdf.center, sdf.voxel_size, r)
    cl = cas.long()
    local = (p_hit - orgs[cl]) / sdf.voxel_size[cl][:, None]
    uvw = torch.where(hit[:, None], local - torch.floor(local),
                      torch.zeros_like(local))
    return SDFHit(t=t_hit, hit=hit, iterations=it,
                  cascade=torch.where(hit, cas, neg), brick=brick, uvw=uvw,
                  voxel=voxel)
