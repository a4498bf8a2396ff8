"""Per-frame LOD selection (counterpart of ``vri_tpu/ops/lod.py``).

The registry packs discrete decimated levels per mesh (``registry.py``'s
LOD tail, built by the native QEM simplifier).  Each frame, every
instance picks the coarsest level whose object-space deviation projects
below ``tau`` pixels at the instance's distance; a per-face boolean mask
then feeds the raster tiers' emission, so faces of the levels not chosen
never emit a (tile, triangle) pair.  Only primary visibility reads the
mask; the SDF build, the BVH and the brute-force tracer keep full-rate
geometry (``SceneBuffers.base_view``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vri_tpu_torch.ops.geometry import dot3, norm3
from vri_tpu_torch.registry import SceneBuffers


def instance_levels(scene: SceneBuffers, eye: torch.Tensor,
                    focal_px: torch.Tensor, tau: float = 0.75
                    ) -> torch.Tensor:
    """Chosen LOD level per instance (I,) i32.

    The projected error of level l of instance i is
    ``deviation[i, l] * scale_i * focal_px / dist_i``: ``scale_i`` the
    largest row norm of the instance's 3x3, ``dist_i`` the distance from
    the eye to the instance's world AABB (at least 1e-3, so an eye inside
    the box keeps level 0) and ``focal_px`` pixels per unit tangent (1 /
    ``FrameParams.pixel_spread``).  A level is usable only when every
    finer one is (the cumulative product of the per-level tests), and the
    count of usable levels minus one is the level chosen."""
    errs = scene.instance_lod_error                      # (I, L+1)
    m = scene.instance_transform[:, :3, :3]              # (I, 3, 3)
    scale = torch.sqrt(dot3(m, m).max(dim=1).values)     # (I,)
    lo, hi = scene.instance_aabb_lo, scene.instance_aabb_hi
    closest = torch.minimum(torch.maximum(eye[None, :], lo), hi)
    dist = norm3(closest - eye[None, :])
    px = errs * (scale * focal_px / torch.clamp(dist, min=1e-3))[:, None]
    usable = torch.cumprod((px <= tau).to(torch.int32), dim=1)
    return torch.clamp(usable.sum(dim=1) - 1, min=0).to(torch.int32)


def face_mask(scene: SceneBuffers, eye: torch.Tensor, focal_px: torch.Tensor,
              tau: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask (F,) bool, levels (I,)): True for the faces of each
    instance's chosen level.  The raster takes ``scene.num_faces_total``
    as its face count beside this mask."""
    levels = instance_levels(scene, eye, focal_px, tau)
    mask = scene.tri_lod == levels[scene.tri_instance.long()]
    return mask, levels
