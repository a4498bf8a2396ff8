"""A plain orbit camera, and the voxels a clipmap scroll owns.

The camera of frame ``n`` of an orbit (a configuration's ``camera``
block) is worked out here in float64 from the orbit's numbers alone: the
eye on a circle of ``radius`` around ``center`` at ``eye_height``, at
azimuth ``azimuth0 + 2 pi n / frames_per_turn`` (x = radius sin, z =
radius cos), looking at ``center``: the keys ``visibility.visibility``
reads from a stage's arrays.

``entered_voxels`` marks the voxels of a set of reference cascades
(``sdf.build``) whose 16^3 cell lay outside the windows the cascades had
around an earlier eye: the region the clipmap scrolls of the frames
between re-binned and re-emitted.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import sdf as ref_sdf


def camera(cam: dict, n: int) -> dict:
    """Eye, target, vertical field of view and clipping range of frame
    ``n`` of the orbit ``cam``."""
    a = cam["azimuth0"] + 2.0 * math.pi * n / cam["frames_per_turn"]
    cx, _, cz = cam["center"]
    eye = [cx + cam["radius"] * math.sin(a), cam["eye_height"],
           cz + cam["radius"] * math.cos(a)]
    return {"eye": eye, "target": list(cam["center"]),
            "fov_deg": cam["fov_deg"], "near": cam["near"],
            "far": cam["far"]}


def entered_voxels(cas: dict, arrays: dict, sdf: dict, eye) -> torch.Tensor:
    """(N, R, R, R) bool, on the CPU: the voxels of the cascades ``cas``
    whose cell lay outside the same cascade's window around ``eye`` (the
    window ``sdf.build`` centres on ``eye`` clamped into the stage's
    bounds, snapped to the cascade's cells)."""
    corners = torch.as_tensor(arrays["corners"], dtype=torch.float64)
    lo = corners.reshape(-1, 3).min(0).values.float()
    hi = corners.reshape(-1, 3).max(0).values.float()
    focus = torch.minimum(torch.maximum(
        torch.as_tensor(eye, dtype=torch.float64).float(), lo), hi)
    _, _, old_origins = ref_sdf.cascade_frames(sdf, focus, "cpu")
    r = cas["r"]
    s = r // 16
    k = torch.arange(16, dtype=torch.float64)
    out = torch.zeros(tuple(cas["occ"].shape), dtype=torch.bool)
    for i in range(out.shape[0]):
        cw = float(cas["vs"][i]) * s
        o_new = cas["origins"][i].double().cpu()
        o_old = old_origins[i].double()
        # a cell's center inside the old window on every axis
        inside = [((o_new[d] + (k + 0.5) * cw > o_old[d])
                   & (o_new[d] + (k + 0.5) * cw < o_old[d] + 16 * cw))
                  for d in range(3)]
        kept = (inside[2][:, None, None] & inside[1][None, :, None]
                & inside[0][None, None, :])
        cells = ~kept
        out[i] = cells.repeat_interleave(s, 0).repeat_interleave(
            s, 1).repeat_interleave(s, 2)
    return out
