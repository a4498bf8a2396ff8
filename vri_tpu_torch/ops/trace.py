"""Scene-level ray tracing entry points through the LBVH (counterpart of
``vri_tpu/ops/trace.py``).

The BVH has no backface culling: ``trace_scene`` ignores USD
doubleSided, as the reference's does, so a BVH frame may see the back of
a one-sided face that the raster tiers cull."""

from __future__ import annotations

import torch

from vri_tpu_torch.ops import bvh as bvh_mod
from vri_tpu_torch.ops.intersect import INF, HitRecord


def trace_scene(scene, world_verts: torch.Tensor, origins: torch.Tensor,
                dirs: torch.Tensor, t_max=INF, leaf_size: int = 8,
                batch: int = 1 << 16) -> HitRecord:
    """Build the LBVH over the current world-space geometry and trace:
    one ``bvh_traverse`` launch on the card, ray batches of ``batch`` for
    the plain version on the CPU."""
    accel = bvh_mod.build_bvh(world_verts, scene.tri_vertices,
                              scene.num_faces, leaf_size=leaf_size)
    return bvh_mod.trace_batched(accel, origins, dirs, t_max=t_max,
                                 batch=batch)


def occluded_scene(scene, world_verts: torch.Tensor, origins: torch.Tensor,
                   dirs: torch.Tensor, t_max, leaf_size: int = 8,
                   batch: int = 1 << 16) -> torch.Tensor:
    rec = trace_scene(scene, world_verts, origins, dirs, t_max=t_max,
                      leaf_size=leaf_size, batch=batch)
    return rec.tri >= 0
