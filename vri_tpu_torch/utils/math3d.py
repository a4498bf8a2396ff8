# Copy of vri_tpu/utils/math3d.py for the port; only the imports differ
# (the array namespace is always numpy: the port's host code has no jax).
"""Host/device 3D math helpers.

Conventions (used consistently across the framework):
  * column vectors; composed transforms apply right-to-left: ``clip = P @ V @ M @ p``
  * right-handed world space, +Y up
  * camera space: camera looks down -Z (like the reference's glm usage,
    Source/FreeCamera.cpp:107-136)
  * clip space: after perspective divide, x,y in [-1,1] (NDC), depth z in
    [0,1] with near=0 (D3D/Vulkan-style, matching the reference's HLSL
    pipeline rather than GL)
  * screen space: pixel (0,0) is the top-left; +x right, +y down.

Everything here works on numpy arrays (pure functions of their inputs).
"""

from __future__ import annotations

import numpy as np


def normalize(v, axis=-1, eps=1e-12):
    xp = _xp(v)
    n = xp.sqrt(xp.sum(v * v, axis=axis, keepdims=True))
    return v / xp.maximum(n, eps)


def _xp(a):
    """Return the array namespace for ``a`` (numpy)."""
    return np


def cross(a, b):
    xp = _xp(a)
    return xp.cross(a, b)


def dot(a, b, axis=-1, keepdims=False):
    xp = _xp(a)
    return xp.sum(a * b, axis=axis, keepdims=keepdims)


# ---------------------------------------------------------------------------
# Matrix builders (host-side, numpy float32)
# ---------------------------------------------------------------------------

def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_x(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World -> camera (view) matrix. Camera looks down -Z."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = normalize(target - eye)          # forward
    r = normalize(np.cross(f, up))       # right
    u = np.cross(r, f)                   # true up
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective(fov_y_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Perspective projection, depth mapped to [0,1] (near=0, far=1).

    Matches D3D/Vulkan z conventions used by the reference's HLSL shaders.
    NDC y is up; the raster step flips y into screen space.
    """
    f = 1.0 / np.tan(0.5 * fov_y_rad)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def orthographic(half_height: float, aspect: float, near: float,
                 far: float) -> np.ndarray:
    """Orthographic projection, depth mapped to [0,1] like perspective()."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (half_height * aspect)
    m[1, 1] = 1.0 / half_height
    m[2, 2] = 1.0 / (near - far)
    m[2, 3] = near / (near - far)
    m[3, 3] = 1.0
    return m


def transform_points(m, pts):
    """Apply a (4,4) matrix to (..., 3) points; returns (..., 3)."""
    xp = _xp(pts)
    p = pts @ xp.asarray(m[:3, :3]).T + xp.asarray(m[:3, 3])
    return p


def transform_points_h(m, pts):
    """Apply a (4,4) matrix to (..., 3) points; returns homogeneous (..., 4)."""
    xp = _xp(pts)
    p = pts @ xp.asarray(m[:3, :3]).T + xp.asarray(m[:3, 3])
    w = pts @ xp.asarray(m[3, :3]).T + m[3, 3]
    return xp.concatenate([p, w[..., None]], axis=-1)


def transform_dirs(m, dirs):
    xp = _xp(dirs)
    return dirs @ xp.asarray(m[:3, :3]).T


def inverse(m):
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)


def quat_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation (GfQuat layout in usda)."""
    w, x, y, z = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def compose_trs(translate_v, quat_wxyz=None, scale_v=None) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    r = quat_to_matrix(quat_wxyz) if quat_wxyz is not None else np.eye(3)
    s = np.ones(3) if scale_v is None else np.asarray(scale_v, np.float32)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = np.asarray(translate_v, np.float32)
    return m


def decompose_rigid(m: np.ndarray):
    """Split a rigid(+uniform scale) transform into (rotation3x3*scale, translation)."""
    return m[:3, :3].copy(), m[:3, 3].copy()
