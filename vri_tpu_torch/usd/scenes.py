# Copy of vri_tpu/usd/scenes.py for the port; only the imports differ,
# and the port adds kitchen_anim.
"""Procedural USD stages used for tests and benchmarks.

The reference ships no scenes; it hardcodes three local stage paths (chess
set, cockpit, sibenik — Source/Main.cpp:171-173) that are not in the repo.
With zero network egress we generate our own:

  * :func:`cornell_box` — the classic box, used for the CPU-reference golden
    path (BASELINE config 1).
  * :func:`kitchen_stress` — a parametric many-object interior, our stand-in
    for the USD Kitchen Set workload (BASELINE config 2): hundreds of
    instanced meshes, per-object materials, face-varying UVs.
  * :func:`animated_stage` — a stage with per-frame animated transforms to
    exercise incremental sync + SDF cascade updates (BASELINE config 3).
  * :func:`kitchen_anim` — :func:`kitchen_stress` with its smallest prop
    circling on authored timeSamples: playback of an animated stage.

All geometry is authored as polygonal (quad) meshes so the triangulation path
(reference: HdMeshUtil::ComputeTriangleIndices, Source/Mesh.cpp:52-60) is
exercised.
"""

from __future__ import annotations

import numpy as np

from vri_tpu_torch.usd.stage import Stage
from vri_tpu_torch.usd.usda import Attribute, Prim, PrimPathRef


# ---------------------------------------------------------------------------
# Mesh-building primitives (host-side, numpy)
# ---------------------------------------------------------------------------

def quad_mesh(p0, p1, p2, p3):
    """One quad face; CCW winding determines the normal."""
    points = np.asarray([p0, p1, p2, p3], np.float32)
    counts = np.asarray([4], np.int32)
    indices = np.asarray([0, 1, 2, 3], np.int32)
    st = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    return points, counts, indices, st


def box_mesh(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0), outward=True,
             tess: int = 1):
    """Axis-aligned box as 6 faces of ``tess`` x ``tess`` quads with
    per-face UVs (tess=1 reproduces the plain 6-quad box)."""
    if tess > 1:
        return _box_mesh_tess(size, center, outward, tess)
    sx, sy, sz = [s * 0.5 for s in size]
    cx, cy, cz = center
    # 8 corners
    c = np.array(
        [[cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
         [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
         [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
         [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz]],
        np.float32)
    # quads, CCW seen from outside
    faces = [(4, 5, 6, 7),   # +z
             (1, 0, 3, 2),   # -z
             (5, 1, 2, 6),   # +x
             (0, 4, 7, 3),   # -x
             (7, 6, 2, 3),   # +y
             (0, 1, 5, 4)]   # -y
    if not outward:
        faces = [f[::-1] for f in faces]
    counts = np.full(6, 4, np.int32)
    indices = np.asarray([i for f in faces for i in f], np.int32)
    st = np.tile(np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32), (6, 1))
    return c, counts, indices, st


def _box_mesh_tess(size, center, outward, tess: int):
    """Tessellated box: 6 faces x tess^2 quads (Kitchen-Set-scale meshes)."""
    sx, sy, sz = [s * 0.5 for s in size]
    ctr = np.asarray(center, np.float32)
    u = np.linspace(-1.0, 1.0, tess + 1, dtype=np.float32)
    pts_all, counts_all, idx_all, st_all = [], [], [], []
    base = 0
    # (axis, sign): face plane; (a0, a1): in-plane axes
    for axis, sign in ((2, 1), (2, -1), (0, 1), (0, -1), (1, 1), (1, -1)):
        a0, a1 = [a for a in range(3) if a != axis]
        half = (sx, sy, sz)
        gu, gv = np.meshgrid(u, u, indexing="ij")
        p = np.zeros(((tess + 1) ** 2, 3), np.float32)
        p[:, a0] = gu.ravel() * half[a0]
        p[:, a1] = gv.ravel() * half[a1]
        p[:, axis] = sign * half[axis]
        pts_all.append(p + ctr)
        n = tess + 1
        i0 = (np.arange(tess)[:, None] * n + np.arange(tess)[None, :]).ravel()
        quad = np.stack([i0, i0 + n, i0 + n + 1, i0 + 1], axis=1)
        # orient CCW seen from outside (flip when the (a0, a1, axis) frame
        # with this sign is left-handed)
        flip = (sign < 0) ^ (((a0 + 1) % 3) != a1)
        if flip ^ (not outward):
            quad = quad[:, ::-1]
        idx_all.append((quad + base).ravel())
        counts_all.append(np.full(tess * tess, 4, np.int32))
        suv = np.stack([(gu.ravel() + 1) * 0.5, (gv.ravel() + 1) * 0.5],
                       axis=1).astype(np.float32)
        st_all.append(suv[quad.ravel()])
        base += n * n
    return (np.concatenate(pts_all), np.concatenate(counts_all),
            np.concatenate(idx_all), np.concatenate(st_all))


def _author_mesh(stage: Stage, path: str, points, counts, indices, st,
                 material: str | None = None, transform: np.ndarray | None = None,
                 display_color=None) -> Prim:
    prim = stage.define_prim(path, "Mesh")
    lo, hi = points.min(axis=0), points.max(axis=0)
    stage.set_attr(prim, "extent", "float3[]", np.stack([lo, hi]))
    stage.set_attr(prim, "points", "point3f[]", points)
    stage.set_attr(prim, "faceVertexCounts", "int[]", counts)
    stage.set_attr(prim, "faceVertexIndices", "int[]", indices)
    if st is not None:
        stage.set_attr(prim, "primvars:st", "texCoord2f[]", st,
                       interpolation="faceVarying")
    if display_color is not None:
        stage.set_attr(prim, "primvars:displayColor", "color3f[]",
                       np.asarray([display_color], np.float32),
                       interpolation="constant")
    if material:
        a = stage.set_attr(prim, "material:binding", "rel",
                           PrimPathRef(material))
        a.type_name = "rel"
    if transform is not None:
        # author row-vector USD convention (transpose of our column-vector)
        stage.set_attr(prim, "xformOp:transform", "matrix4d",
                       np.asarray(transform, np.float64).T)
        stage.set_attr(prim, "xformOpOrder", "token[]",
                       ["xformOp:transform"], uniform=True)
    return prim


def _author_material(stage: Stage, path: str, diffuse, emissive=(0, 0, 0),
                     roughness: float = 0.8, texture: str | None = None) -> Prim:
    mat = stage.define_prim(path, "Material")
    shader = stage.define_prim(path + "/Preview", "Shader")
    stage.set_attr(shader, "info:id", "token", "UsdPreviewSurface", uniform=True)
    stage.set_attr(shader, "inputs:diffuseColor", "color3f",
                   np.asarray(diffuse, np.float32))
    stage.set_attr(shader, "inputs:emissiveColor", "color3f",
                   np.asarray(emissive, np.float32))
    stage.set_attr(shader, "inputs:roughness", "float", float(roughness))
    a = stage.set_attr(mat, "outputs:surface", "token", None)
    a.connect = path + "/Preview.outputs:surface"
    if texture:
        tex = stage.define_prim(path + "/Tex", "Shader")
        stage.set_attr(tex, "info:id", "token", "UsdUVTexture", uniform=True)
        from vri_tpu_torch.usd.usda import AssetPath
        stage.set_attr(tex, "inputs:file", "asset", AssetPath(texture))
        ai = stage.set_attr(shader, "inputs:diffuseColor", "color3f",
                            np.asarray(diffuse, np.float32))
        ai.connect = path + "/Tex.outputs:rgb"
    return mat


def _author_camera(stage: Stage, path: str, eye, target, fov_deg=45.0,
                   near=0.05, far=100.0) -> Prim:
    cam = stage.define_prim(path, "Camera")
    stage.set_attr(cam, "vri:eye", "float3", np.asarray(eye, np.float32))
    stage.set_attr(cam, "vri:target", "float3", np.asarray(target, np.float32))
    stage.set_attr(cam, "vri:fovDegrees", "float", float(fov_deg))
    stage.set_attr(cam, "clippingRange", "float2",
                   np.asarray([near, far], np.float32))
    return cam


def _author_light(stage: Stage, path: str, position, color, intensity) -> Prim:
    light = stage.define_prim(path, "SphereLight")
    stage.set_attr(light, "vri:position", "float3", np.asarray(position, np.float32))
    stage.set_attr(light, "inputs:color", "color3f", np.asarray(color, np.float32))
    stage.set_attr(light, "inputs:intensity", "float", float(intensity))
    return light


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def cornell_box() -> Stage:
    """Classic Cornell box in [-1,1]^3-ish, camera on +Z looking -Z."""
    stage = Stage(Prim(name=""), {"defaultPrim": "World", "metersPerUnit": 1})
    stage.define_prim("/World", "Xform")

    white = (0.73, 0.73, 0.73)
    _author_material(stage, "/World/Materials/White", white)
    _author_material(stage, "/World/Materials/Red", (0.63, 0.065, 0.05))
    _author_material(stage, "/World/Materials/Green", (0.14, 0.45, 0.091))
    _author_material(stage, "/World/Materials/Light", (0.78, 0.78, 0.78),
                     emissive=(17.0, 12.0, 4.0))

    s = 1.0
    # interior-facing CCW winding (normals point INTO the box): correct
    # single-sided authoring for a room seen from inside — USD meshes
    # default to doubleSided=false, so backfaces cull
    walls = {
        "Floor": ((-s, -s, s), (s, -s, s), (s, -s, -s), (-s, -s, -s)),
        "Ceiling": ((-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s)),
        "BackWall": ((s, -s, -s), (s, s, -s), (-s, s, -s), (-s, -s, -s)),
        "LeftWall": ((-s, -s, -s), (-s, s, -s), (-s, s, s), (-s, -s, s)),
        "RightWall": ((s, -s, s), (s, s, s), (s, s, -s), (s, -s, -s)),
    }
    mats = {"LeftWall": "Red", "RightWall": "Green"}
    for name, quad in walls.items():
        pts, counts, idx, st = quad_mesh(*quad)
        _author_mesh(stage, f"/World/{name}", pts, counts, idx, st,
                     material=f"/World/Materials/{mats.get(name, 'White')}")

    # area light quad just below ceiling (faces down into the room)
    e = 0.25
    pts, counts, idx, st = quad_mesh((-e, s - 0.01, -e), (e, s - 0.01, -e),
                                     (e, s - 0.01, e), (-e, s - 0.01, e))
    _author_mesh(stage, "/World/LightQuad", pts, counts, idx, st,
                 material="/World/Materials/Light")

    # two boxes (axis-aligned stand-ins for the rotated classic blocks)
    for name, size, center, rot_deg in (
            ("TallBox", (0.6, 1.2, 0.6), (-0.35, -0.4, -0.35), 18.0),
            ("ShortBox", (0.6, 0.6, 0.6), (0.4, -0.7, 0.35), -17.0)):
        pts, counts, idx, st = box_mesh(size, (0, 0, 0))
        prim = _author_mesh(stage, f"/World/{name}", pts, counts, idx, st,
                            material="/World/Materials/White")
        stage.set_attr(prim, "xformOp:translate", "float3",
                       np.asarray(center, np.float32))
        stage.set_attr(prim, "xformOp:rotateY", "float", rot_deg)
        stage.set_attr(prim, "xformOpOrder", "token[]",
                       ["xformOp:translate", "xformOp:rotateY"], uniform=True)

    _author_camera(stage, "/World/Camera", eye=(0, 0, 3.6), target=(0, 0, 0),
                   fov_deg=40.0)
    _author_light(stage, "/World/KeyLight", position=(0.0, 0.93, 0.0),
                  color=(1.0, 0.85, 0.55), intensity=3.0)
    stage._reindex()
    return stage


def kitchen_stress(num_objects: int = 256, seed: int = 7,
                   num_materials: int = 24, tess: int = 1) -> Stage:
    """Many-object interior scene — the Kitchen-Set-scale benchmark stand-in.

    Deterministic: a room shell plus ``num_objects`` boxes ("furniture" /
    "props") in a grid-with-jitter layout, bound round-robin to
    ``num_materials`` distinct materials.  ``tess`` subdivides every box
    face into tess^2 quads: tess=6 with 256 props is ~111k triangles —
    the real Kitchen Set's scale (reference stages, Source/Main.cpp:171).
    """
    rng = np.random.default_rng(seed)
    stage = Stage(Prim(name=""), {"defaultPrim": "World", "metersPerUnit": 1})
    stage.define_prim("/World", "Xform")

    for i in range(num_materials):
        col = 0.15 + 0.8 * rng.random(3)
        _author_material(stage, f"/World/Materials/M{i:03d}", tuple(col))

    room = 8.0
    pts, counts, idx, st = box_mesh((room, room * 0.5, room), (0, room * 0.25, 0),
                                    outward=False, tess=max(1, tess))
    _author_mesh(stage, "/World/Room", pts, counts, idx, st,
                 material="/World/Materials/M000")

    side = int(np.ceil(np.sqrt(num_objects)))
    pitch = (room * 0.9) / side
    for i in range(num_objects):
        gx, gz = i % side, i // side
        base = np.array([(gx + 0.5) / side - 0.5, 0.0, (gz + 0.5) / side - 0.5])
        base *= room * 0.9
        jitter = (rng.random(3) - 0.5) * pitch * 0.4
        size = 0.2 + rng.random(3) * np.array([pitch * 0.7, 1.2, pitch * 0.7])
        center = base + jitter
        center[1] = size[1] * 0.5 + 1e-3
        pts, counts, idx, st = box_mesh(tuple(size), (0, 0, 0), tess=tess)
        prim = _author_mesh(
            stage, f"/World/Props/Prop{i:04d}", pts, counts, idx, st,
            material=f"/World/Materials/M{i % num_materials:03d}")
        stage.set_attr(prim, "xformOp:translate", "float3",
                       center.astype(np.float32))
        stage.set_attr(prim, "xformOp:rotateY", "float",
                       float(rng.random() * 360.0))
        stage.set_attr(prim, "xformOpOrder", "token[]",
                       ["xformOp:translate", "xformOp:rotateY"], uniform=True)

    _author_camera(stage, "/World/Camera",
                   eye=(room * 0.42, room * 0.3, room * 0.42),
                   target=(0, 0.6, 0), fov_deg=55.0, far=200.0)
    # ceiling light inside the room (a light outside a closed room is
    # fully occluded once SDF shadows exist)
    _author_light(stage, "/World/CeilingLight",
                  position=(0.0, room * 0.46, 0.0),
                  color=(1.0, 0.95, 0.8), intensity=18.0)
    stage._reindex()
    return stage


def city_stress(num_buildings: int = 1024, seed: int = 11,
                num_materials: int = 32, tess: int = 10,
                num_protos: int = 16, share_protos: bool = True) -> Stage:
    """Beyond-bench-scale stress stage (VERDICT r3 #6): an aerial city of
    ``num_buildings`` tessellated towers on a ground plane.

    With ``share_protos`` each building's mesh is one of ``num_protos``
    PROTOTYPE boxes (identical point data; per-building size comes from
    ``xformOp:scale``), so the registry's content-hash prototype pooling
    stores only the prototypes while the *instanced* triangle count is
    ``num_buildings * 6 * tess^2 * 2`` (defaults: ~1.23M instanced tris
    from ~19k stored) — the scale regime where the reference's 4096
    bindless-table ceiling (Source/ResourceRegistry.cpp:25-34) breaks
    and per-instance LOD selection has room to act.  ``share_protos=
    False`` authors every tower as a unique mesh (the HBM-heavy
    full-rate contrast).
    """
    rng = np.random.default_rng(seed)
    stage = Stage(Prim(name=""), {"defaultPrim": "World", "metersPerUnit": 1})
    stage.define_prim("/World", "Xform")

    for i in range(num_materials):
        col = 0.2 + 0.7 * rng.random(3)
        _author_material(stage, f"/World/Materials/M{i:03d}", tuple(col))

    side = int(np.ceil(np.sqrt(num_buildings)))
    pitch = 4.0
    extent = side * pitch
    # ground plane (two triangles; the city floor)
    g = extent * 0.55
    pts, counts, idx, st = quad_mesh((-g, 0, -g), (g, 0, -g),
                                     (g, 0, g), (-g, 0, g))
    _author_mesh(stage, "/World/Ground", pts, counts, idx, st,
                 material="/World/Materials/M000")

    # per-instance layout (deterministic)
    base_all = np.zeros((num_buildings, 3), np.float32)
    size_all = np.zeros((num_buildings, 3), np.float32)
    for i in range(num_buildings):
        gx, gz = i % side, i // side
        base_all[i] = [(gx + 0.5 - side / 2) * pitch, 0.0,
                       (gz + 0.5 - side / 2) * pitch]
        base_all[i, [0, 2]] += (rng.random(2) - 0.5) * pitch * 0.3
        size_all[i] = [0.8 + rng.random() * 2.0,
                       2.0 + rng.random() * 14.0,
                       0.8 + rng.random() * 2.0]

    if share_protos:
        # USD PointInstancer: the delegate flattens it per instance but
        # the registry packs each prototype's geometry ONCE (proto keys)
        pi = stage.define_prim("/World/CityPI", "PointInstancer")
        proto_paths = []
        for k in range(max(1, num_protos)):
            pts, counts, idx, st = box_mesh((1.0, 1.0, 1.0),
                                            (0.0, 0.5, 0.0), tess=tess)
            p = f"/World/CityPI/Protos/P{k:02d}"
            _author_mesh(stage, p, pts, counts, idx, st,
                         material=f"/World/Materials/"
                                  f"M{k % num_materials:03d}")
            proto_paths.append(p)
        rel = Attribute(name="prototypes", type_name="rel",
                        value=[PrimPathRef(p) for p in proto_paths])
        pi.attributes["prototypes"] = rel
        stage.set_attr(pi, "positions", "point3f[]", base_all)
        stage.set_attr(pi, "protoIndices", "int[]",
                       (np.arange(num_buildings) % max(1, num_protos))
                       .astype(np.int64))
        stage.set_attr(pi, "scales", "float3[]", size_all)
    else:
        for i in range(num_buildings):
            pts, counts, idx, st = box_mesh(
                (float(size_all[i, 0]), 1.0, float(size_all[i, 2])),
                (0.0, 0.5, 0.0), tess=tess)
            prim = _author_mesh(
                stage, f"/World/Blocks/B{i:05d}", pts, counts, idx, st,
                material=f"/World/Materials/M{i % num_materials:03d}")
            stage.set_attr(prim, "xformOp:translate", "float3",
                           base_all[i])
            stage.set_attr(prim, "xformOp:scale", "float3",
                           np.array([1.0, size_all[i, 1], 1.0],
                                    np.float32))
            stage.set_attr(prim, "xformOpOrder", "token[]",
                           ["xformOp:translate", "xformOp:scale"],
                           uniform=True)

    _author_camera(stage, "/World/Camera",
                   eye=(extent * 0.35, extent * 0.22, extent * 0.35),
                   target=(0.0, 4.0, 0.0), fov_deg=55.0,
                   far=float(extent * 4.0))
    _author_light(stage, "/World/Sun",
                  position=(extent * 0.3, extent * 0.8, -extent * 0.2),
                  color=(1.0, 0.97, 0.9), intensity=float(extent * extent))
    stage._reindex()
    return stage


def animated_stage(num_objects: int = 8, authored_frames: int = 48) -> Stage:
    """Small dynamic stage with AUTHORED animation: every prop's
    ``xformOp:translate`` carries timeSamples (a bobbing motion), so
    ``delegate.sync(time_code=t)`` drives it the way the reference gets
    time-sampled xforms from UsdImagingDelegate (Source/Main.cpp:41-46).
    :func:`animate` remains for procedural (scripted-edit) animation.
    """
    stage = kitchen_stress(num_objects=num_objects, seed=3, num_materials=4)
    for prim in stage.prims_of_type("Mesh"):
        if "/Props/" not in prim.path:
            continue
        a = prim.attributes.get("xformOp:translate")
        if a is None:
            continue
        base = np.asarray(a.value, np.float32)
        phase = hash(prim.path) % 7
        samples = {}
        for f in range(0, authored_frames + 1, 4):
            t = base.copy()
            t[1] = abs(base[1]) + 0.25 * (1 + np.sin(f / 8.0 + phase))
            samples[float(f)] = t
        a.metadata["timeSamples"] = samples
    return stage


def kitchen_anim(num_objects: int = 256, seed: int = 7,
                 num_materials: int = 24, tess: int = 1,
                 radius: float = 0.03, period: int = 9) -> Stage:
    """:func:`kitchen_stress` with authored motion on one prop.

    The prop whose world AABB has the smallest largest side (ties broken
    by path) carries ``timeSamples`` on its ``xformOp:translate``: a
    circle of ``radius`` metres in the floor plane around its authored
    place, one turn every ``period`` time codes, authored at every
    integer code 0..period (the last equal to the first, so looped
    playback has no jump).  The default value stays the authored place.
    Deterministic: nothing depends on ``hash()``."""
    stage = kitchen_stress(num_objects=num_objects, seed=seed,
                           num_materials=num_materials, tess=tess)

    def largest_side(prim):
        pts = np.asarray(prim.get("points"), np.float64)
        m = stage.world_transform(prim).astype(np.float64)
        w = pts @ m[:3, :3].T + m[:3, 3]
        return float((w.max(0) - w.min(0)).max())

    props = [p for p in stage.prims_of_type("Mesh") if "/Props/" in p.path]
    prop = min(props, key=lambda p: (largest_side(p), p.path))
    a = prop.attributes["xformOp:translate"]
    base = np.asarray(a.value, np.float64)
    samples = {}
    for k in range(period + 1):
        ang = 2.0 * np.pi * (k % period) / period
        samples[float(k)] = (base + radius * np.array(
            [np.cos(ang), 0.0, np.sin(ang)])).astype(np.float32)
    a.metadata["timeSamples"] = samples
    return stage


def animate(stage: Stage, time: float) -> list[str]:
    """Advance animated prims; returns the paths whose transforms changed."""
    changed = []
    for prim in stage.prims_of_type("Mesh"):
        if "/Props/" not in prim.path:
            continue
        a = prim.attributes.get("xformOp:translate")
        if a is None:
            continue
        t = np.asarray(a.value, np.float32)
        phase = hash(prim.path) % 7
        t[1] = abs(t[1]) + 0.25 * (1 + np.sin(time * 2.0 + phase))
        a.value = t
        changed.append(prim.path)
    return changed
