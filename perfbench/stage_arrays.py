"""The benchmark's input as plain arrays for the reference.

A configuration names a procedural stage; the harness builds it once and
hands the same stage to the program (``Renderer.load_stage``) and, read
here into numpy arrays, to the plain reference.  Reading follows the USD
rules the stages use and nothing of the program's sync: Mesh prims with
``points`` / ``faceVertexCounts`` / ``faceVertexIndices`` (fan
triangulation), their ``xformOp`` stacks (translate, rotateY, scale,
transform) composed down the prim hierarchy, PointInstancers (translate
by ``positions``, then ``scales``, applied to each prototype, whose own
Mesh prims are not drawn), the ``UsdPreviewSurface`` colours of the
bound material, ``doubleSided`` (single-sided when not authored),
SphereLights and the camera.
"""

from __future__ import annotations

import numpy as np


def _ops_matrix(prim) -> np.ndarray:
    m = np.eye(4)
    for op in prim.get("xformOpOrder", []) or []:
        v = prim.get(op)
        k = np.eye(4)
        if op.startswith("xformOp:translate"):
            k[:3, 3] = np.asarray(v, np.float64)
        elif op.startswith("xformOp:scale"):
            k[0, 0], k[1, 1], k[2, 2] = np.broadcast_to(
                np.asarray(v, np.float64), (3,))
        elif op.startswith("xformOp:rotateY"):
            a = np.radians(float(v))
            k[0, 0], k[0, 2], k[2, 0], k[2, 2] = (np.cos(a), np.sin(a),
                                                  -np.sin(a), np.cos(a))
        elif op.startswith("xformOp:transform"):
            # authored in USD's row-vector convention
            k = np.asarray(v, np.float64).reshape(4, 4).T
        else:
            raise ValueError(f"{prim.path}: xformOp {op!r} is not read")
        m = m @ k
    return m


def _world(prim) -> np.ndarray:
    chain = []
    p = prim
    while p is not None:
        chain.append(p)
        p = p.parent
    m = np.eye(4)
    for q in reversed(chain):
        m = m @ _ops_matrix(q)
    return m


def _triangles(prim) -> np.ndarray:
    """(T, 3) vertex indices, each face fanned from its first corner."""
    counts = np.asarray(prim.get("faceVertexCounts"), np.int64)
    idx = np.asarray(prim.get("faceVertexIndices"), np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tris = [np.stack([idx[starts[counts > k]],
                      idx[starts[counts > k] + k - 1],
                      idx[starts[counts > k] + k]], -1)
            for k in range(2, int(counts.max()))]
    # fan order per face: (0, 1, 2), (0, 2, 3), ...
    order = np.concatenate([np.nonzero(counts > k)[0] * 64 + k
                            for k in range(2, int(counts.max()))])
    return np.concatenate(tris)[np.argsort(order, kind="stable")]


def _material(stage, prim):
    rel = prim.get("material:binding")
    if rel is None:
        raise ValueError(f"{prim.path}: no bound material")
    mat = stage.prim_at_path(getattr(rel, "path", rel))
    for shader in mat.children:
        if shader.get("info:id") == "UsdPreviewSurface":
            return (np.asarray(shader.get("inputs:diffuseColor"), np.float32),
                    np.asarray(shader.get("inputs:emissiveColor",
                                          (0.0, 0.0, 0.0)), np.float32))
    raise ValueError(f"{mat.path}: no UsdPreviewSurface")


def stage_arrays(stage) -> dict:
    """Flat world-space triangles of ``stage`` with their instance, and
    per instance its colours and sidedness; the lights; the camera."""
    instancers = stage.prims_of_type("PointInstancer")
    proto_roots = tuple(p.path + "/" for p in instancers)
    corners, inst_of, albedo, emissive, double = [], [], [], [], []

    def add(points_world, tris, alb, emi, ds):
        i = len(albedo)
        corners.append(points_world[tris])
        inst_of.append(np.full(len(tris), i, np.int32))
        albedo.append(alb)
        emissive.append(emi)
        double.append(ds)

    for prim in stage.traverse():
        if prim.type_name == "Mesh" and not prim.path.startswith(proto_roots):
            pts = np.asarray(prim.get("points"), np.float64)
            m = _world(prim)
            add(pts @ m[:3, :3].T + m[:3, 3], _triangles(prim),
                *_material(stage, prim), bool(prim.get("doubleSided", False)))
        elif prim.type_name == "PointInstancer":
            protos = [stage.prim_at_path(getattr(r, "path", r))
                      for r in prim.attributes["prototypes"].value]
            pos = np.asarray(prim.get("positions"), np.float64)
            scl = np.asarray(prim.get("scales"), np.float64)
            which = np.asarray(prim.get("protoIndices"), np.int64)
            m_pi = _world(prim)
            for i in range(len(pos)):
                proto = protos[which[i]]
                k = np.diag([*scl[i], 1.0])
                k[:3, 3] = pos[i]
                m = m_pi @ k @ _ops_matrix(proto)
                pts = np.asarray(proto.get("points"), np.float64)
                add(pts @ m[:3, :3].T + m[:3, 3], _triangles(proto),
                    *_material(stage, proto),
                    bool(proto.get("doubleSided", False)))

    lights = stage.prims_of_type("SphereLight")
    cams = stage.prims_of_type("Camera")
    cam = cams[0]
    clip = np.asarray(cam.get("clippingRange", (0.05, 100.0)), np.float64)
    mc = _world(cam)
    eye = np.asarray(cam.get("vri:eye"), np.float64)
    target = np.asarray(cam.get("vri:target"), np.float64)
    return {
        "corners": np.concatenate(corners),            # (T, 3, 3) f64
        "tri_instance": np.concatenate(inst_of),       # (T,) i32
        "albedo": np.stack(albedo),                    # (I, 3) f32
        "emissive": np.stack(emissive),
        "double_sided": np.asarray(double),
        "light_position": np.stack([np.asarray(p.get("vri:position"),
                                               np.float32) for p in lights]),
        "light_color": np.stack([np.asarray(p.get("inputs:color"),
                                            np.float32) for p in lights]),
        "light_intensity": np.asarray([float(p.get("inputs:intensity"))
                                       for p in lights], np.float32),
        "eye": mc[:3, :3] @ eye + mc[:3, 3],
        "target": mc[:3, :3] @ target + mc[:3, 3],
        "fov_deg": float(cam.get("vri:fovDegrees", 45.0)),
        "near": float(clip[0]),
        "far": float(clip[1]),
    }
