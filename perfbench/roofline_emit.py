"""The yardstick of the SDF emit kernel's roofline share, in the manner of
``perfbench/roofline.py`` (whose peaks it uses): the least work the emit
of one animated frame must do, counted from the frame's own inputs.

* ``sdf_emit`` (SDF update): the bricks a frame must re-emit are the
  occupied voxels of the reference's cascades at the frame's time code
  that lie within max(truncation, 1.5) voxels of the old or the new
  bounds of the geometry that moved (the reach of a texel's truncated
  distance; the old and new bounds from the stage at the two time codes).
  Each texel of such a brick takes its exact distance to the k nearest
  candidate triangles (``max_triangles_per_brick``):
  ``EMIT_FLOP_PER_DISTANCE`` operations each (the point-triangle distance
  of ``geometry.point_triangle_distance``: 15 subtractions for the edge
  and point vectors, 6 dot products of 5, 9 for the barycentric
  determinants, 2 for their sum, 4 divisions with their 7 subtractions
  and additions, 2 products, 1 subtraction, 12 for the closest point, 3
  and 5 for the offset and its squared length, 1 square root).  Every
  such brick writes its atlas row (one byte a texel, four with a float
  atlas) and 36 bytes of albedo, emissive and normal.  The candidate scan
  is left out: how many candidates a brick has depends on the lists the
  program keeps.
"""

from __future__ import annotations

import torch

from perfbench.roofline import least_s

EMIT_FLOP_PER_DISTANCE = 90
EMIT_SHADING_BYTES = 36


def moved_boxes(before: dict, after: dict) -> torch.Tensor:
    """(2M, 3, 2) bounds (lo, hi on the last axis) of the M instances whose
    triangles moved between two readings of a stage (``stage_arrays``),
    before and after."""
    a = torch.as_tensor(before["corners"])
    b = torch.as_tensor(after["corners"])
    inst = torch.as_tensor(after["tri_instance"]).long()
    moved = (a != b).any(-1).any(-1)
    boxes = []
    for i in torch.unique(inst[moved]).tolist():
        for c in (a, b):
            pts = c[inst == i].reshape(-1, 3)
            boxes.append(torch.stack([pts.min(0).values, pts.max(0).values],
                                     -1))
    if not boxes:
        return torch.zeros((0, 3, 2), dtype=torch.float64)
    return torch.stack(boxes)


def near_voxels(cas: dict, boxes: torch.Tensor, sdf: dict) -> torch.Tensor:
    """(N, R, R, R) voxels of the reference cascades ``cas`` (on the CPU)
    whose voxel box lies within max(truncation, 1.5) voxels of any of
    ``boxes``: the region a bounded update of those boxes re-emits."""
    r = cas["r"]
    reach = max(sdf["truncation_voxels"], 1.5)
    k = torch.arange(r, dtype=torch.float64)
    near = torch.zeros(tuple(cas["occ"].shape), dtype=torch.bool)
    for i in range(near.shape[0]):
        v = float(cas["vs"][i])
        o = cas["origins"][i].double().cpu()
        for box in boxes:
            lo, hi = box[:, 0] - reach * v, box[:, 1] + reach * v
            ax = [((o[d] + k * v) <= hi[d]) & ((o[d] + (k + 1) * v) >= lo[d])
                  for d in range(3)]
            near[i] |= (ax[2][:, None, None] & ax[1][None, :, None]
                        & ax[0][None, None, :])
    return near


def emit_bricks(cas: dict, boxes: torch.Tensor, sdf: dict) -> int:
    """Occupied voxels of the reference cascades ``cas`` in
    :func:`near_voxels` of ``boxes``."""
    return int((cas["occ"].cpu() & near_voxels(cas, boxes, sdf)).sum())


def emit_least_s(bricks: int, sdf: dict) -> float:
    texels = sdf["brick_size"] ** 3
    flops = (bricks * texels * sdf["max_triangles_per_brick"]
             * EMIT_FLOP_PER_DISTANCE)
    nbytes = bricks * (texels * (1 if sdf["atlas_u8"] else 4)
                       + EMIT_SHADING_BYTES)
    return least_s(flops, nbytes)
