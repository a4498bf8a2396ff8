"""SDF ray marching entry points (counterpart of
``vri_tpu/ops/sdf_trace.py``).

Two tiers, dispatched as the JAX package's TPU branch does
(``sdf_trace.py:218-229`` and ``:311-321``):

* the approximate tier -- occlusion, shadow and GI-gather rays at voxel
  precision -- runs the march kernel (``march_kernel.march``, one launch
  whatever ``compact`` or ``config.compact_march`` say) with the step
  budget ``ks = max_steps * 2 + 16``: kernel steps are voxel-granular, so
  the budget is scaled;
* everything else -- ``approx=False`` (the ``reference`` preset's GI
  rays, the SDF debug views) and the nearest-texel tier without
  ``config.kernel_march`` -- runs the lock-step sphere march of
  :func:`_march_loop` over :func:`_sample`, in plain PyTorch on the
  rays' device.  The JAX package runs this loop in XLA, not in Pallas,
  so it has no kernel of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from vri_tpu_torch.config import SDFConfig
from vri_tpu_torch.ops.sdf import SDFCascades, cascade_origin

BIG = 3.0e38

#: steps the trilinear loop runs between two checks for a live ray (each
#: check is a host sync on the card)
_CHECK_EVERY = 8


@dataclasses.dataclass
class SDFHit:
    t: torch.Tensor           # (M,) f32 — BIG on miss
    hit: torch.Tensor         # (M,) bool
    iterations: torch.Tensor  # (M,) i32
    cascade: torch.Tensor     # (M,) i32 — cascade of the hit voxel
    brick: torch.Tensor       # (M,) i32 — atlas brick at the hit
    uvw: torch.Tensor         # (M, 3) f32 — position within the voxel
    #: flat hit-voxel id (cas * R^3 + voxel), -1 on miss; the kernel
    #: march gives it, the trilinear loop leaves it None
    voxel: torch.Tensor | None = None


def _kernel_steps(max_steps: int | None, config: SDFConfig) -> int:
    return (max_steps or config.march_max_steps) * 2 + 16


def _sample(sdf: SDFCascades, p: torch.Tensor, config: SDFConfig,
            dirs: torch.Tensor | None = None, trilinear: bool = True):
    """Sample the cascade set at world points p (M, 3).

    Returns (d_world, cascade, brick, uvw, inside_any, exit_t): the
    truncated distance where a brick exists, else BIG; the finest
    cascade containing the point (-1 outside all), its brick (-1 outside
    all; ``-esd`` in an empty voxel) and the position within the voxel;
    and the world distance along ``dirs`` to the voxel's exit face (0
    when dirs is None).  ``trilinear=False`` reads the nearest texel and
    subtracts half a texel diagonal, a conservative sphere-march bound.
    Every operation is the JAX function's, in its order."""
    n_cas = config.num_cascades
    r = config.cascade_resolution
    bsz = config.brick_size
    m = p.shape[0]
    dev = p.device

    vs_all = sdf.voxel_size                                   # (N,)
    org_all = cascade_origin(sdf.center, vs_all, r)           # (N, 3)
    local_all = (p[:, None, :] - org_all[None]) / vs_all[None, :, None]
    inside_all = ((local_all >= 0) & (local_all < r)).all(-1)  # (m, N)
    ncol = torch.arange(n_cas, dtype=torch.int32, device=dev)
    cas = torch.where(inside_all, ncol[None, :],
                      torch.full_like(ncol, n_cas)[None, :]).min(-1).values
    chosen = cas < n_cas
    cas_c = torch.clamp(cas, max=n_cas - 1)
    cl = cas_c.long()

    vs = vs_all[cl]                                           # (m,)
    local = local_all[torch.arange(m, device=dev), cl]        # (m, 3)
    vox = torch.floor(local).to(torch.int32)
    vox_c = torch.clamp(vox, 0, r - 1)
    vl = vox_c.long()
    brick = sdf.brick_map[cl, vl[:, 2], vl[:, 1], vl[:, 0]]
    frac = local - vox_c.float()                  # [0,1) within voxel

    b_idx = torch.clamp(brick, min=0).long()
    flat = sdf.atlas.reshape(-1)

    def texel(iz, iy, ix):
        v = flat[((b_idx * bsz + iz) * bsz + iy) * bsz + ix]
        return v.float() * (1.0 / 255.0) if v.dtype == torch.uint8 else v

    if trilinear:
        tc = frac * bsz - 0.5
        t0 = torch.floor(tc)
        fr = tc - t0
        t0i = t0.to(torch.int32).long()
        iz0 = torch.clamp(t0i[:, 2], 0, bsz - 1)
        iz1 = torch.clamp(t0i[:, 2] + 1, 0, bsz - 1)
        iy0 = torch.clamp(t0i[:, 1], 0, bsz - 1)
        iy1 = torch.clamp(t0i[:, 1] + 1, 0, bsz - 1)
        ix0 = torch.clamp(t0i[:, 0], 0, bsz - 1)
        ix1 = torch.clamp(t0i[:, 0] + 1, 0, bsz - 1)
        fx, fy, fz = fr[:, 0], fr[:, 1], fr[:, 2]
        # the four (z, y) rows, each interpolated along x
        dx = [texel(iz, iy, ix0) * (1 - fx) + texel(iz, iy, ix1) * fx
              for iz, iy in ((iz0, iy0), (iz0, iy1), (iz1, iy0), (iz1, iy1))]
        d0 = dx[0] * (1 - fy) + dx[1] * fy
        d1 = dx[2] * (1 - fy) + dx[3] * fy
        d01v = d0 * (1 - fz) + d1 * fz                # normalized [0,1]
    else:
        ti = torch.clamp((frac * bsz).to(torch.int32), 0, bsz - 1).long()
        d01v = texel(ti[:, 2], ti[:, 1], ti[:, 0])
        # conservative: the value holds at the texel center, the point is
        # within half a texel diagonal of it
        d01v = torch.clamp(
            d01v - 0.8660254 / (config.truncation_voxels * bsz), min=0.0)

    trunc_w = config.truncation_voxels * vs
    has_brick = (brick >= 0) & chosen
    d_best = torch.where(has_brick, d01v * trunc_w, BIG)

    if dirs is not None:
        # distance (world) along the ray to this voxel's exit planes; axes
        # the ray does not move along never produce an exit
        small = torch.abs(dirs) < 1e-9
        safe_d = torch.where(small, torch.where(dirs < 0, -1e-9, 1e-9),
                             dirs)
        vox_f = vox_c.float()
        target = torch.where(dirs > 0, vox_f + 1.0, vox_f)
        t_ax = (target - local) * vs[:, None] / safe_d
        t_ax = torch.where(small, BIG, t_ax)
        exit_t = torch.clamp(t_ax.min(-1).values, min=0.0)
    else:
        exit_t = torch.zeros((m,), dtype=torch.float32, device=dev)

    neg = torch.full_like(cas, -1)
    cas_best = torch.where(chosen, cas_c, neg)
    brick_best = torch.where(chosen, brick, neg)
    uvw_best = torch.where(chosen[:, None], frac, 0.0)
    return d_best, cas_best, brick_best, uvw_best, chosen, exit_t


_RAY_FIELDS = ("t", "active", "hit", "it", "cascade", "brick", "uvw")


def _march_loop(sdf: SDFCascades, config: SDFConfig, approx: bool,
                origins, dirs, t_max, t_enter, state: dict,
                max_steps: int) -> dict:
    """Lock-step sphere march over the rays ``state`` describes, for at
    most ``max_steps`` steps or until no ray is active.

    The JAX loop tests ``any(active)`` before every step; here the test
    (a host sync on the card) runs every ``_CHECK_EVERY`` steps, the run
    clamped to the remaining budget.  A step over an all-inactive state
    changes nothing but the step count, which is not returned, so the
    extra steps leave the result as the JAX loop's."""
    vs_c = sdf.voxel_size[-1]

    def body(s):
        act = s["active"]
        p = origins + dirs * s["t"][:, None]
        d, cas, brick, uvw, inside, exit_t = _sample(
            sdf, p, config, dirs, trilinear=not approx)
        vs_here = torch.where(
            cas >= 0, sdf.voxel_size[torch.clamp(cas, min=0).long()], vs_c)
        texel = vs_here / config.brick_size
        eps_w = config.march_epsilon * texel
        has_brick = brick >= 0
        hit_now = act & inside & has_brick & (d < eps_w)
        # outside every cascade after entering: the ray left the clipmap
        escaped = act & ~inside & (s["t"] > t_enter + 1e-3)
        # brick voxel: sphere step; empty voxel: skip the Chebyshev
        # empty-space distance of the brick map (at least to the exit)
        sphere = torch.maximum(d * 0.9, config.march_min_step * texel)
        esd = torch.clamp(-brick, min=1).float()
        skip = torch.maximum(exit_t, (esd - 1.0) * vs_here)
        dda = skip + 0.05 * vs_here
        adv = torch.where(has_brick, sphere, dda)
        adv = torch.where(inside, adv, vs_c)     # outside: coarse stride
        new_t = s["t"] + adv
        over = new_t >= t_max
        return dict(
            t=torch.where(act, torch.where(hit_now, s["t"], new_t),
                          s["t"]),
            active=act & ~hit_now & ~over & ~escaped,
            hit=s["hit"] | hit_now,
            it=s["it"] + act.to(torch.int32),
            cascade=torch.where(hit_now, cas, s["cascade"]),
            brick=torch.where(hit_now, brick, s["brick"]),
            uvw=torch.where(hit_now[:, None], uvw, s["uvw"]),
        )

    step = 0
    while step < max_steps and bool(state["active"].any()):
        for _ in range(min(_CHECK_EVERY, max_steps - step)):
            state = body(state)
            step += 1
    return state


def march(sdf: SDFCascades, origins: torch.Tensor, dirs: torch.Tensor,
          t_max, *, config: SDFConfig, max_steps: int | None = None,
          approx: bool = False, compact: bool = False) -> SDFHit:
    """Sphere march rays (M, 3) through the cascades.

    ``approx=True`` with ``config.kernel_march`` on a supported resolution
    runs the voxel-precision march kernel in one launch, ``compact`` or
    not: its persistent lanes already refill as rays end.  Otherwise the
    lock-step loop marches: trilinear samples unless ``approx`` (nearest
    texel).  There ``compact=True`` runs the loop 8 steps at full width,
    gathers the surviving rays (a stable sort, at most a quarter of them)
    into a smaller buffer for the remaining budget, then finishes at full
    width whatever did not fit, as the JAX loop does."""
    from vri_tpu_torch.ops import march_kernel

    if approx and config.kernel_march and march_kernel.supports(config):
        return march_kernel.march(sdf, origins, dirs, t_max, config=config,
                                  max_steps=_kernel_steps(max_steps, config))
    m = origins.shape[0]
    dev = origins.device
    i32 = torch.int32
    max_steps = max_steps or config.march_max_steps
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(m).contiguous()

    # coarsest cascade bounds: rays starting outside skip to entry
    vs_c = sdf.voxel_size[-1]
    r = config.cascade_resolution
    lo = cascade_origin(sdf.center[-1], vs_c, r)
    hi = lo + r * vs_c
    inv_d = 1.0 / torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
    t0s = (lo - origins) * inv_d
    t1s = (hi - origins) * inv_d
    t_enter = torch.minimum(t0s, t1s).max(-1).values
    t_exit = torch.maximum(t0s, t1s).min(-1).values
    t_init = torch.minimum(torch.clamp(t_enter + 1e-4, min=1e-3), t_max)
    never = t_exit < torch.clamp(t_enter, min=0.0)

    s = dict(t=t_init, active=~never & (t_init < t_max),
             hit=torch.zeros((m,), dtype=torch.bool, device=dev),
             it=torch.zeros((m,), dtype=i32, device=dev),
             cascade=torch.full((m,), -1, dtype=i32, device=dev),
             brick=torch.full((m,), -1, dtype=i32, device=dev),
             uvw=torch.zeros((m, 3), dtype=torch.float32, device=dev))

    if not compact or m < 512:
        s = _march_loop(sdf, config, approx, origins, dirs, t_max, t_enter,
                        s, max_steps)
    else:
        k1 = min(8, max_steps)
        s = _march_loop(sdf, config, approx, origins, dirs, t_max, t_enter,
                        s, k1)
        # surviving rays first, in ray order (jnp.argsort is stable)
        idx = torch.argsort((~s["active"]).to(torch.uint8),
                            stable=True)[:m // 4]
        sub = _march_loop(sdf, config, approx, origins[idx], dirs[idx],
                          t_max[idx], t_enter[idx],
                          {k: s[k][idx] for k in _RAY_FIELDS},
                          max_steps - k1)
        s = {k: s[k].index_put((idx,), sub[k]) for k in _RAY_FIELDS}
        # exactness cleanup: rays that did not fit the buffer finish at
        # full width (one check when none is active)
        s = _march_loop(sdf, config, approx, origins, dirs, t_max, t_enter,
                        s, max_steps - k1)

    return SDFHit(t=torch.where(s["hit"], s["t"], BIG), hit=s["hit"],
                  iterations=s["it"], cascade=s["cascade"],
                  brick=s["brick"], uvw=s["uvw"])


def normal(sdf: SDFCascades, p: torch.Tensor, *, config: SDFConfig
           ) -> torch.Tensor:
    """SDF gradient by central differences, h = half a texel of the
    finest cascade at p (unit length; zero where the field is flat)."""
    _, cas, _, _, _, _ = _sample(sdf, p, config)
    vs = torch.where(cas >= 0,
                     sdf.voxel_size[torch.clamp(cas, min=0).long()],
                     sdf.voxel_size[-1])
    h = (0.5 * vs / config.brick_size)[:, None]
    grads = []
    for ax in range(3):
        e = torch.zeros((1, 3), dtype=torch.float32, device=p.device)
        e[0, ax] = 1.0
        dp = _sample(sdf, p + e * h, config)[0]
        dm = _sample(sdf, p - e * h, config)[0]
        # clamp: points just outside brick coverage sample BIG
        grads.append(torch.clamp(dp, max=1e3) - torch.clamp(dm, max=1e3))
    g = torch.stack(grads, dim=-1)
    return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True),
                           min=1e-12)


def occlusion(sdf: SDFCascades, origins: torch.Tensor, dirs: torch.Tensor,
              t_max, *, config: SDFConfig, max_steps: int | None = None
              ) -> torch.Tensor:
    """Shadow factor in [0,1]: 0 = blocked.  With ``config.kernel_march``
    on a supported resolution, the march kernel (hit / t only, one launch
    whatever ``config.compact_march`` says); otherwise :func:`march` at
    ``config.approx_occlusion``, its loop in two stages under
    ``config.compact_march``."""
    from vri_tpu_torch.ops import march_kernel

    if config.kernel_march and march_kernel.supports(config):
        rec = march_kernel.march(sdf, origins, dirs, t_max, config=config,
                                 max_steps=_kernel_steps(max_steps, config),
                                 payload=False)
        return 1.0 - rec.hit.float()
    rec = march(sdf, origins, dirs, t_max, config=config,
                max_steps=max_steps, approx=config.approx_occlusion,
                compact=config.compact_march)
    return 1.0 - rec.hit.float()
