# Copy of vri_tpu/hydra/meshutil.py for the port; only the imports differ.
"""Polygon-mesh triangulation utilities.

TPU-native equivalent of the reference's use of pxr ``HdMeshUtil``:
``ComputeTriangleIndices`` (Source/Mesh.cpp:52-60) and
``ComputeTriangulatedFaceVaryingPrimvar`` (Source/Mesh.cpp:63-79).  Fully
vectorized numpy (host side — runs once per topology change during prim sync,
not per frame).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def triangulate(counts: np.ndarray, indices: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fan-triangulate polygon faces.

    Args:
      counts: (F,) int — vertices per face.
      indices: (sum(counts),) int — flat face-vertex indices.

    Returns:
      tris: (T, 3) int32 — triangle vertex indices (into the points array).
      tri_face: (T,) int32 — source polygon index per triangle (USD
        "primitive param"), used to invert primID -> authored face.
      tri_corners: (T, 3) int32 — flat *corner* indices into the
        face-varying value stream, for triangulating faceVarying primvars.
    """
    counts = np.asarray(counts, np.int64)
    indices = np.asarray(indices, np.int64)
    tri_per_face = np.maximum(counts - 2, 0)
    total = int(tri_per_face.sum())
    if total == 0:
        z3 = np.zeros((0, 3), np.int32)
        return z3, np.zeros((0,), np.int32), z3.copy()

    face_of_tri = np.repeat(np.arange(len(counts)), tri_per_face)
    # k = triangle index within its face (0..count-3)
    first_tri = np.concatenate([[0], np.cumsum(tri_per_face)[:-1]])
    k = np.arange(total) - first_tri[face_of_tri]
    face_offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
    base = face_offset[face_of_tri]

    corner0 = base
    corner1 = base + k + 1
    corner2 = base + k + 2
    tri_corners = np.stack([corner0, corner1, corner2], axis=1)
    tris = indices[tri_corners]
    return (tris.astype(np.int32), face_of_tri.astype(np.int32),
            tri_corners.astype(np.int32))


def triangulate_face_varying(values: np.ndarray, tri_corners: np.ndarray
                             ) -> np.ndarray:
    """Flatten a faceVarying primvar to per-triangle-corner values.

    values: (num_corners, C); tri_corners from :func:`triangulate`.
    Returns (T, 3, C).
    """
    return np.asarray(values)[tri_corners]


def expand_primvar(values: np.ndarray, interpolation: str,
                   counts: np.ndarray, tris: np.ndarray,
                   tri_face: np.ndarray, tri_corners: np.ndarray) -> np.ndarray:
    """Expand a primvar of any USD interpolation to per-triangle-corner (T,3,C)."""
    values = np.asarray(values)
    if values.ndim == 1:
        values = values[:, None]
    if interpolation == "faceVarying":
        return triangulate_face_varying(values, tri_corners)
    if interpolation in ("vertex", "varying"):
        return values[tris]
    if interpolation == "uniform":            # per-face
        return np.repeat(values[tri_face][:, None, :], 3, axis=1)
    if interpolation == "constant":
        return np.broadcast_to(values[0], (len(tris), 3, values.shape[-1])).copy()
    raise ValueError(f"unknown interpolation {interpolation!r}")


def compute_extent(points: np.ndarray) -> np.ndarray:
    if len(points) == 0:
        return np.zeros((2, 3), np.float32)
    return np.stack([points.min(0), points.max(0)]).astype(np.float32)
