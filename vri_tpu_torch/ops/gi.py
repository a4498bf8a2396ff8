"""The lightloop: SDF-shadowed direct lighting + one SDF-marched diffuse
GI bounce (counterpart of ``vri_tpu/ops/gi.py``).

Random numbers: :func:`indirect_radiance` takes either explicit
``uniforms`` of shape (samples, n, 2) or a ``torch.Generator``; nothing
else in the port draws random numbers.  ``jax.random`` and torch's
generators give different numbers from one seed, so a parity test hands
both sides the same uniforms.
"""

from __future__ import annotations

import math

import torch

from vri_tpu.config import SDFConfig
from vri_tpu_torch.ops import sdf_trace
from vri_tpu_torch.ops.geometry import dot3, norm3
from vri_tpu_torch.ops.sdf import SDFCascades


def cosine_sample_hemisphere(normal: torch.Tensor, u1: torch.Tensor,
                             u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about ``normal`` (N, 3)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    # orthonormal basis around the normal (branchless Frisvad)
    n = normal
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b,
                     -sign * n[:, 0]], dim=-1)
    bt = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], dim=-1)
    return t * x[:, None] + bt * y[:, None] + n * z[:, None]


def _light_arrays(scene):
    nl = scene.light_position.shape[0]
    live = (torch.arange(nl, device=scene.light_position.device)
            < scene.num_lights).float()
    return (scene.light_position, scene.light_color,
            scene.light_intensity * live, scene.light_type)


def surface_bias(points: torch.Tensor, cascades: SDFCascades,
                 config: SDFConfig) -> torch.Tensor:
    """Per-point shadow-ray offset: 0.75 voxel of the finest cascade
    containing the point (rays must start clear of the surface band)."""
    from vri_tpu_torch.ops import march_kernel

    return 0.75 * march_kernel.finest_voxel_size(cascades, points, config)


def _to_lights(points, lp, lt):
    is_distant = (lt == 1)[None, :]
    to_l = torch.where(is_distant[..., None], lp[None, :, :],
                       lp[None, :, :] - points[:, None, :])
    dist = norm3(to_l)
    wi = to_l / torch.clamp(dist, min=1e-12)[..., None]
    return is_distant, dist, wi


def shadow_rays(points: torch.Tensor, normals: torch.Tensor, scene,
                cascades: SDFCascades, config: SDFConfig):
    """One shadow ray per (point, light): origins lifted off the surface
    by the bias, unit directions to the light, and the march range (the
    coarsest cascade's span for distant lights).  Returns flat
    (origins, dirs, t_max), point-major."""
    lp, lc, li, lt = _light_arrays(scene)
    n_pts, n_lights = points.shape[0], lp.shape[0]
    is_distant, dist, wi = _to_lights(points, lp, lt)
    bias = surface_bias(points, cascades, config)[:, None]
    shadow_span = cascades.voxel_size[-1] * config.cascade_resolution
    t_max = torch.where(is_distant, shadow_span, dist - 2.0 * bias)
    o = (points[:, None, :] + normals[:, None, :] * bias[..., None]).expand(
        n_pts, n_lights, 3).reshape(-1, 3)
    return o, wi.reshape(-1, 3), torch.clamp(t_max.reshape(-1), min=1e-3)


def shadow_occlusion(points: torch.Tensor, normals: torch.Tensor, scene,
                     cascades: SDFCascades, config: SDFConfig,
                     shadow_steps: int | None = None) -> torch.Tensor:
    """SDF-marched per-(point, light) visibility factors (N, L)."""
    shadow_steps = shadow_steps or config.shadow_steps
    o, wi, t_max = shadow_rays(points, normals, scene, cascades, config)
    return sdf_trace.occlusion(
        cascades, o, wi, t_max=t_max, config=config,
        max_steps=shadow_steps).reshape(points.shape[0], -1)


def direct_radiance_analytic(points: torch.Tensor, normals: torch.Tensor,
                             scene, occ: torch.Tensor,
                             light_radius: float = 0.1) -> torch.Tensor:
    """The non-marched half of direct lighting: N.L, falloff, colors."""
    lp, lc, li, lt = _light_arrays(scene)
    is_distant, dist, wi = _to_lights(points, lp, lt)
    ndotl = torch.clamp(dot3(normals[:, None, :], wi), min=0.0)
    falloff = torch.where(is_distant, 1.0,
                          1.0 / torch.clamp(dist * dist,
                                            min=light_radius ** 2))
    irr = li[None, :] * ndotl * occ * falloff
    return (irr[..., None] * lc[None, :, :]).sum(dim=1)


def direct_radiance(points: torch.Tensor, normals: torch.Tensor, scene,
                    cascades: SDFCascades, config: SDFConfig,
                    shadow_steps: int | None = None,
                    light_radius: float = 0.1,
                    return_visibility: bool = False):
    """Incoming direct radiance (N, 3) at surface points, SDF-shadowed."""
    occ = shadow_occlusion(points, normals, scene, cascades, config,
                           shadow_steps)
    out = direct_radiance_analytic(points, normals, scene, occ, light_radius)
    if return_visibility:
        return out, occ
    return out


def lightloop(gb, scene, cascades: SDFCascades, *, config: SDFConfig,
              samples: int = 1, generator: torch.Generator | None = None,
              uniforms: torch.Tensor | None = None,
              gi_steps: int | None = None, shadow_steps: int | None = None,
              gi_clamp: float = 4.0, use_cache: bool = False
              ) -> torch.Tensor:
    """Full shading: emissive + albedo * (direct + 1-bounce GI)."""
    if config.cached_shadows and use_cache:
        raise NotImplementedError(
            "cached_shadows needs the trilinear sampler (sdf_trace._sample); "
            "see ROADMAP.md 'What comes next', item 1")
    gi_steps = gi_steps or config.gi_steps
    shadow_steps = shadow_steps or config.shadow_steps
    direct = direct_radiance(gb.position, gb.normal, scene, cascades,
                             config, shadow_steps=shadow_steps)
    if samples == 0:   # direct-only (SDF-shadowed) fast path
        color = gb.emissive + gb.albedo * direct
        return torch.where(gb.valid[:, None], color, 0.0)
    indirect = indirect_radiance(gb, scene, cascades, config=config,
                                 samples=samples, generator=generator,
                                 uniforms=uniforms, gi_steps=gi_steps,
                                 gi_clamp=gi_clamp, use_cache=use_cache)
    color = gb.emissive + gb.albedo * (direct + indirect)
    return torch.where(gb.valid[:, None], color, 0.0)


def gi_rays(points: torch.Tensor, normals: torch.Tensor, u: torch.Tensor,
            cascades: SDFCascades, config: SDFConfig):
    """Cosine-weighted gather rays from uniforms ``u`` (N, 2): (origins,
    dirs, range), the range a fraction of the coarsest cascade's span."""
    bias = surface_bias(points, cascades, config)[:, None]
    gi_range = (cascades.voxel_size[-1] * config.cascade_resolution
                * config.gi_range_factor)
    wi = cosine_sample_hemisphere(normals, u[:, 0], u[:, 1])
    return points + normals * bias, wi, gi_range


def indirect_radiance(gb, scene, cascades: SDFCascades, *,
                      config: SDFConfig, samples: int = 1,
                      generator: torch.Generator | None = None,
                      uniforms: torch.Tensor | None = None,
                      gi_steps: int | None = None,
                      shadow_steps: int | None = None, gi_clamp: float = 4.0,
                      use_cache: bool = False) -> torch.Tensor:
    """Incoming 1-bounce diffuse irradiance estimate (N, 3).  Sample s uses
    ``uniforms[s]`` when given, else draws (N, 2) from ``generator``."""
    gi_steps = gi_steps or config.gi_steps
    n = gb.position.shape[0]
    dev = gb.position.device
    if samples <= 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if uniforms is None and generator is None:
        raise ValueError("indirect_radiance needs uniforms or a generator")
    if uniforms is not None and tuple(uniforms.shape) != (samples, n, 2):
        raise ValueError(f"uniforms must be ({samples}, {n}, 2), got "
                         f"{tuple(uniforms.shape)}")
    indirect = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(samples):
        u = (uniforms[s] if uniforms is not None else
             torch.rand((n, 2), generator=generator, device=dev))
        o, wi, gi_range = gi_rays(gb.position, gb.normal, u, cascades,
                                  config)
        rec = sdf_trace.march(cascades, o, wi, t_max=gi_range,
                              config=config, max_steps=gi_steps,
                              approx=config.approx_occlusion,
                              compact=config.compact_march)
        hit_p = o + wi * torch.minimum(rec.t, gi_range)[:, None]
        if cascades.voxel_shade is not None and rec.voxel is not None:
            # bf16 rows keyed on the hit voxel; shading math in f32
            sh = cascades.voxel_shade[torch.clamp(rec.voxel,
                                                  min=0).long()].float()
        else:
            shade_tab = torch.cat(
                [cascades.brick_albedo, cascades.brick_normal,
                 cascades.brick_irradiance, cascades.brick_emissive], dim=1)
            sh = shade_tab[torch.clamp(rec.brick, min=0).long()]
        alb_hit = sh[:, 0:3]
        n_hit = sh[:, 3:6]
        # two-sided surface cache: face the incoming ray
        n_hit = torch.where(dot3(n_hit, wi)[:, None] > 0, -n_hit, n_hit)
        if use_cache:
            l_hit = sh[:, 6:9]       # radiance cache baked per brick
        else:
            hit_bias = surface_bias(hit_p, cascades, config)[:, None]
            l_hit = direct_radiance(hit_p + n_hit * hit_bias, n_hit, scene,
                                    cascades, config,
                                    shadow_steps=shadow_steps)
        emis_hit = sh[:, 9:12]
        bounce = torch.clamp(alb_hit * l_hit + emis_hit, max=gi_clamp)
        contrib = torch.where(rec.hit[:, None], bounce,
                              scene.sky_color[None, :])
        indirect = indirect + contrib
    return indirect / samples
