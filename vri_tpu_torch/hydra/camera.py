# Copy of vri_tpu/hydra/camera.py for the port; only the imports differ.
"""Camera sync + scripted free camera.

The reference drives an interactive WASD/mouse ``FreeCamera`` hooked into the
Win32 message loop (Source/FreeCamera.cpp:10-105) and pushes view/projection
matrices into Hydra via ``SetMatrices`` (FreeCamera.cpp:107-136).  Headless on
TPU, the equivalent is a camera state struct produced either from a Camera
prim or from scripted paths (orbit / flythrough) for benchmarks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from vri_tpu_torch.usd.stage import Stage
from vri_tpu_torch.usd.usda import Prim
from vri_tpu_torch.utils import math3d


@dataclasses.dataclass
class CameraState:
    eye: np.ndarray                     # (3,)
    view: np.ndarray                    # (4,4) world -> camera
    proj: np.ndarray                    # (4,4) camera -> clip
    near: float = 0.05
    far: float = 100.0
    fov_y: float = math.radians(45.0)

    @property
    def view_proj(self) -> np.ndarray:
        return (self.proj @ self.view).astype(np.float32)

    @property
    def inv_view_proj(self) -> np.ndarray:
        return math3d.inverse(self.view_proj)


def make_camera(eye, target, fov_y_deg: float, aspect: float,
                near: float = 0.05, far: float = 100.0,
                up=(0.0, 1.0, 0.0)) -> CameraState:
    fov = math.radians(fov_y_deg)
    return CameraState(
        eye=np.asarray(eye, np.float32),
        view=math3d.look_at(eye, target, up),
        proj=math3d.perspective(fov, aspect, near, far),
        near=near, far=far, fov_y=fov)


def make_ortho_camera(eye, target, half_height: float, aspect: float,
                      near: float = 0.05, far: float = 100.0,
                      up=(0.0, 1.0, 0.0)) -> CameraState:
    return CameraState(
        eye=np.asarray(eye, np.float32),
        view=math3d.look_at(eye, target, up),
        proj=math3d.orthographic(half_height, aspect, near, far),
        near=near, far=far, fov_y=0.0)


def sync_camera(stage: Stage, prim: Prim, aspect: float) -> CameraState:
    eye = np.asarray(prim.get("vri:eye", (0, 0, 3)), np.float32)
    target = np.asarray(prim.get("vri:target", (0, 0, 0)), np.float32)
    fov = float(prim.get("vri:fovDegrees", 45.0))
    clip = np.asarray(prim.get("clippingRange", (0.05, 100.0)), np.float32)
    # apply any authored transform on the camera prim to eye/target
    m = stage.world_transform(prim)
    eye = math3d.transform_points(m, eye[None])[0]
    target = math3d.transform_points(m, target[None])[0]
    return make_camera(eye, target, fov, aspect, float(clip[0]), float(clip[1]))


class FreeCamera:
    """Scripted flythrough camera (orbit by default)."""

    def __init__(self, center=(0.0, 0.0, 0.0), radius: float = 3.5,
                 height: float = 0.5, fov_y_deg: float = 45.0,
                 near: float = 0.05, far: float = 100.0):
        self.center = np.asarray(center, np.float32)
        self.radius = radius
        self.height = height
        self.fov_y_deg = fov_y_deg
        self.near, self.far = near, far

    def at_time(self, t: float, aspect: float,
                orbit_period: float = 8.0) -> CameraState:
        ang = 2.0 * math.pi * (t / orbit_period)
        eye = self.center + np.asarray(
            [self.radius * math.sin(ang), self.height,
             self.radius * math.cos(ang)], np.float32)
        return make_camera(eye, self.center, self.fov_y_deg, aspect,
                           self.near, self.far)


def find_camera(stage: Stage) -> Optional[Prim]:
    cams = stage.prims_of_type("Camera")
    return cams[0] if cams else None
