"""Render delegate + change tracking (counterpart of
``vri_tpu/hydra/delegate.py``; the host logic is the same).

The delegate owns an explicit :class:`ChangeTracker`, and ``sync()``
re-extracts only dirty prims into the port's
:class:`~vri_tpu_torch.registry.ResourceRegistry`, which packs them into
tensors on the renderer's device.  It shares the jax-free host modules of
``vri_tpu`` (USD stage, camera, material, mesh utilities, the native
triangulator).
"""

from __future__ import annotations

import enum
import logging
import os
import time
from typing import Dict, Optional

import numpy as np

from vri_tpu.config import RenderConfig
from vri_tpu.hydra import camera as camera_mod
from vri_tpu.hydra import material as material_mod
from vri_tpu.hydra import meshutil
from vri_tpu_torch.registry import (LightRecord, MeshRecord,
                                    ResourceRegistry, SceneBuffers)
from vri_tpu.usd.stage import Stage
from vri_tpu.usd.usda import Prim

log = logging.getLogger("vri_tpu_torch")


class DirtyBits(enum.IntFlag):
    """Mirrors the HdChangeTracker dirty-bit model the reference consumes in
    Mesh::Sync (Source/Mesh.cpp:13,117) and Mesh::GetInitialDirtyBitsMask
    (Source/Mesh.cpp:9)."""

    CLEAN = 0
    TOPOLOGY = enum.auto()
    POINTS = enum.auto()
    TRANSFORM = enum.auto()
    MATERIAL = enum.auto()
    PRIMVAR = enum.auto()
    ALL = TOPOLOGY | POINTS | TRANSFORM | MATERIAL | PRIMVAR


class ChangeTracker:
    def __init__(self):
        self._dirty: Dict[str, DirtyBits] = {}

    def mark(self, path: str, bits: DirtyBits = DirtyBits.ALL) -> None:
        self._dirty[path] = self._dirty.get(path, DirtyBits.CLEAN) | bits

    def mark_transform(self, path: str) -> None:
        self.mark(path, DirtyBits.TRANSFORM)

    def bits(self, path: str) -> DirtyBits:
        return self._dirty.get(path, DirtyBits.CLEAN)

    def clean(self, path: str) -> None:
        self._dirty.pop(path, None)

    @property
    def any_dirty(self) -> bool:
        return bool(self._dirty)

    def dirty_paths(self):
        return list(self._dirty)


class RenderDelegate:
    """Owns the stage <-> registry sync boundary.

    Usage::

        delegate = RenderDelegate(config, device="cuda")
        delegate.populate(stage)          # UsdImagingDelegate::Populate analog
        scene = delegate.sync()           # dirty-prim sync + registry commit
        ... edit stage, delegate.tracker.mark(path, bits) ...
        scene = delegate.sync()           # incremental
    """

    def __init__(self, config: Optional[RenderConfig] = None, *, device):
        self.config = config or RenderConfig()
        self.registry = ResourceRegistry(self.config, device=device)
        self.tracker = ChangeTracker()
        self.stage: Optional[Stage] = None
        self.camera: Optional[camera_mod.CameraState] = None

    # -- population ----------------------------------------------------------

    def populate(self, stage: Stage) -> None:
        """Register every renderable prim and mark it fully dirty
        (reference: UsdImagingDelegate::Populate -> CreateRprim/CreateSprim,
        Source/Main.cpp:41-46, Source/RenderDelegate.cpp:30-50)."""
        self.stage = stage
        instanced: set = set()
        for prim in stage.traverse():
            if prim.type_name == "PointInstancer":
                for proto in self._instancer_prototypes(prim):
                    instanced.add(proto.path)
        for prim in stage.traverse():
            if prim.type_name in ("Mesh", "Material", "Camera", "SphereLight",
                                  "DistantLight", "DomeLight",
                                  "PointInstancer"):
                if prim.type_name == "Mesh" and any(
                        prim.path == p or prim.path.startswith(p + "/")
                        for p in instanced):
                    continue  # prototype meshes render only via instances
                self.tracker.mark(prim.path, DirtyBits.ALL)

    # -- sync ----------------------------------------------------------------

    def sync(self, time_code: float | None = None) -> SceneBuffers:
        """Sync dirty prims (optionally advancing stage time first).

        ``time_code`` drives authored timeSamples animation: prims whose
        xformOps or points carry samples are marked dirty between frames
        — the TPU analog of time-sampled prim sync through
        UsdImagingDelegate (Source/Main.cpp:41-46, Source/Mesh.cpp:11).
        Transform-only animation rides the cheap transforms-only commit +
        bounded SDF update path.
        """
        assert self.stage is not None, "populate() first"
        if time_code is not None and time_code != self.stage.time:
            self.stage.set_time(time_code)
            for path, kind in self._animated_prims():
                if kind == "transform":
                    self.tracker.mark_transform(path)
                else:
                    self.tracker.mark(path, DirtyBits.ALL)
        t0 = time.perf_counter()
        aspect = self.config.width / self.config.height
        n_synced = 0
        prepared = self._parallel_prepare()
        for path in self.tracker.dirty_paths():
            prim = self.stage.prim_at_path(path)
            bits = self.tracker.bits(path)
            if prim is None:
                self.registry.remove_mesh(path)
                self.tracker.clean(path)
                continue
            if prim.type_name == "Mesh":
                self._sync_mesh(prim, bits, prepared)
            elif prim.type_name == "PointInstancer":
                self._sync_instancer(prim)
            elif prim.type_name == "Material":
                desc = prepared.get("mat:" + path)
                if desc is not None:
                    self.registry.push_material(desc)
                else:
                    self._sync_material(prim)
            elif prim.type_name == "Camera":
                self.camera = camera_mod.sync_camera(self.stage, prim, aspect)
            elif prim.type_name in ("SphereLight", "DistantLight",
                                    "DomeLight"):
                self._sync_light(prim)
            self.tracker.clean(path)
            n_synced += 1
        scene = self.registry.commit()
        if n_synced:
            log.debug("sync: %d prims in %.2f ms", n_synced,
                      1e3 * (time.perf_counter() - t0))
        if self.camera is None:
            cam_prim = camera_mod.find_camera(self.stage)
            if cam_prim is not None:
                self.camera = camera_mod.sync_camera(self.stage, cam_prim, aspect)
        return scene

    def _parallel_prepare(self) -> dict:
        """Fan the pure per-prim prepare work of every dirty prim over a
        thread pool: mesh triangulation/dedup/primvar expansion
        (`_prepare_mesh`) and material network walk + texture decode
        (`material.sync_material`).  The TPU-native analog of the
        reference's TBB-parallel resource commit (ResourceRegistry.cpp)
        and jthread async scene load (Main.cpp) — numpy, ctypes and PIL
        release the GIL, so plain threads scale; all registry mutation
        stays in the serial loop, in deterministic path order.

        Returns {mesh_path: MeshRecord, "mat:"+path: MaterialDesc}."""
        workers = self.config.sync_workers
        if workers == 0:
            workers = min(8, os.cpu_count() or 1)
        if workers <= 1:
            return {}
        mesh_jobs = []          # (path, prim)
        mat_jobs = {}           # path -> prim
        for path in self.tracker.dirty_paths():
            prim = self.stage.prim_at_path(path)
            if prim is None:
                continue
            bits = self.tracker.bits(path)
            if prim.type_name == "Mesh":
                if (bits == DirtyBits.TRANSFORM
                        and path in self.registry._meshes):
                    continue    # cheap fast path, stays serial
                mesh_jobs.append((path, prim))
                mat = self.stage.bound_material(prim)
                if (mat is not None
                        and mat.path not in self.registry._materials):
                    mat_jobs.setdefault(mat.path, mat)
            elif prim.type_name == "Material":
                mat_jobs.setdefault(path, prim)
        if len(mesh_jobs) + len(mat_jobs) < 2:
            return {}
        from concurrent.futures import ThreadPoolExecutor

        from vri_tpu.runtime import native

        # load (building it if absent) the native library on this thread:
        # its build-on-first-use is not safe from several threads at once
        # (a thread can load the half-written .so and fall back to numpy)
        native.available()
        res = self.config.limits.texture_res
        prepared: dict = {}
        with ThreadPoolExecutor(max_workers=workers) as ex:
            mfuts = {p: ex.submit(self._prepare_mesh, prim)
                     for p, prim in mesh_jobs}
            tfuts = {p: ex.submit(material_mod.sync_material,
                                  self.stage, prim, res)
                     for p, prim in mat_jobs.items()}
            for p, f in mfuts.items():
                prepared[p] = f.result()
            for p, f in tfuts.items():
                prepared["mat:" + p] = f.result()
        return prepared

    def _sync_mesh(self, prim: Prim, bits: DirtyBits,
                   prepared: dict | None = None) -> None:
        """Mesh::Sync analog (Source/Mesh.cpp:11-120): points + extent +
        triangulated topology + triangulated faceVarying st + transform +
        material binding.  ``prepared`` carries records built by the
        parallel prepare phase (keyed by prim path)."""
        stage = self.stage
        if bits == DirtyBits.TRANSFORM and prim.path in self.registry._meshes:
            self.registry.update_transform(
                prim.path, stage.world_transform(prim))
            return
        rec = (prepared or {}).get(prim.path)
        if rec is None:
            rec = self._prepare_mesh(prim)
        mat = stage.bound_material(prim)
        if mat is not None and mat.path not in self.registry._materials:
            desc = (prepared or {}).get("mat:" + mat.path)
            if desc is not None:
                self.registry.push_material(desc)
            else:
                self._sync_material(mat)
        self.registry.push_mesh(rec)

    def _prepare_mesh(self, prim: Prim) -> "MeshRecord":
        """The pure (registry-free) half of mesh sync: triangulation,
        vertex dedup, primvar expansion, extent, transform.  Safe to run
        on a worker thread — stage reads are read-only and the numpy /
        ctypes hot loops release the GIL."""
        stage = self.stage
        points = np.asarray(prim.get_at("points", stage.time, ()),
                            np.float32).reshape(-1, 3)
        counts = np.asarray(prim.get("faceVertexCounts", ()), np.int64).reshape(-1)
        indices = np.asarray(prim.get("faceVertexIndices", ()), np.int64).reshape(-1)
        # native fast path (falls back to hydra.meshutil when the .so is absent)
        from vri_tpu.runtime import native

        tris, tri_face, tri_corners = native.triangulate(counts, indices)
        if self.config.dedup_vertices and len(points):
            remap, points = native.dedup_vertices(points)
            tris = remap[tris]
        st_attr = prim.attributes.get("primvars:st")
        if st_attr is not None and st_attr.value is not None:
            uvs = meshutil.expand_primvar(
                st_attr.value, st_attr.interpolation or "faceVarying",
                counts, tris, tri_face, tri_corners)[..., :2]
        else:
            uvs = np.zeros((len(tris), 3, 2), np.float32)
        extent = prim.get("extent")
        extent = (np.asarray(extent, np.float32) if extent is not None
                  else meshutil.compute_extent(points))
        # USD orientation: leftHanded meshes author CW-front winding;
        # flipping corner order restores the CCW-front convention every
        # downstream consumer assumes (geometric normals, backface cull).
        # Hydra does the same normalization via HdMeshUtil.
        if str(prim.get("orientation", "rightHanded")) == "leftHanded":
            tris = np.ascontiguousarray(tris[:, ::-1])
            uvs = np.ascontiguousarray(uvs[:, ::-1])
        # doubleSided: USD spec default is single-sided (backface-culled);
        # the reference ignores it (VK_CULL_MODE_NONE, Common.cpp:333) —
        # config.force_double_sided restores that behavior for bad content
        ds = bool(prim.get("doubleSided", False)) \
            or self.config.force_double_sided
        mat = stage.bound_material(prim)
        return MeshRecord(
            path=prim.path, points=points, tris=tris, tri_face=tri_face,
            uvs=uvs.astype(np.float32),
            transform=stage.world_transform(prim),
            material_path=mat.path if mat is not None else None,
            extent=extent, double_sided=ds)

    def _instancer_prototypes(self, prim: Prim):
        """Resolve the ``prototypes`` rel targets to Mesh prims (descends
        one level when a target is an Xform wrapping a mesh)."""
        rel = prim.attributes.get("prototypes")
        targets = rel.value if rel is not None and rel.value is not None else []
        if not isinstance(targets, list):
            targets = [targets]
        protos = []
        for t in targets:
            p = self.stage.prim_at_path(str(t))
            if p is None:
                continue
            if p.type_name == "Mesh":
                protos.append(p)
            else:
                mesh = next((c for c in p.traverse()
                             if c.type_name == "Mesh"), None)
                if mesh is not None:
                    protos.append(mesh)
        return protos

    def _sync_instancer(self, prim: Prim) -> None:
        """Flatten a PointInstancer into per-instance draw items —
        UsdImagingDelegate does the same flattening for render delegates
        (like the reference) that don't implement native instancing."""
        from vri_tpu.utils import math3d

        stage = self.stage
        protos = self._instancer_prototypes(prim)
        if not protos:
            log.warning("PointInstancer %s has no resolvable prototypes",
                        prim.path)
            return
        positions = np.asarray(prim.get("positions", ()),
                               np.float32).reshape(-1, 3)
        proto_idx = np.asarray(prim.get("protoIndices", ()),
                               np.int64).reshape(-1)
        orientations = prim.get("orientations")
        scales = prim.get("scales")
        pi_world = stage.world_transform(prim)

        # extract prototype geometry once
        proto_data = []
        from vri_tpu.runtime import native

        for proto in protos:
            points = np.asarray(proto.get("points", ()),
                                np.float32).reshape(-1, 3)
            counts = np.asarray(proto.get("faceVertexCounts", ()),
                                np.int64).reshape(-1)
            indices = np.asarray(proto.get("faceVertexIndices", ()),
                                 np.int64).reshape(-1)
            tris, tri_face, tri_corners = native.triangulate(counts, indices)
            st_attr = proto.attributes.get("primvars:st")
            if st_attr is not None and st_attr.value is not None:
                uvs = meshutil.expand_primvar(
                    st_attr.value, st_attr.interpolation or "faceVarying",
                    counts, tris, tri_face, tri_corners)[..., :2]
            else:
                uvs = np.zeros((len(tris), 3, 2), np.float32)
            extent = proto.get("extent")
            extent = (np.asarray(extent, np.float32) if extent is not None
                      else meshutil.compute_extent(points))
            if str(proto.get("orientation", "rightHanded")) == "leftHanded":
                tris = np.ascontiguousarray(tris[:, ::-1])
                uvs = np.ascontiguousarray(uvs[:, ::-1])
            ds = bool(proto.get("doubleSided", False)) \
                or self.config.force_double_sided
            mat = stage.bound_material(proto)
            if mat is not None and mat.path not in self.registry._materials:
                self._sync_material(mat)
            local = stage.local_transform(proto)
            proto_data.append((points, tris, tri_face,
                               uvs.astype(np.float32), extent,
                               mat.path if mat is not None else None, local,
                               ds))

        # each instance is (prototype key, transform, material): the packed
        # pools store one copy of each prototype's geometry (registry proto
        # layout) — 10k instances of a 1k-vert prototype pack ~1k verts,
        # not 10M (reference analog: per-draw-item metadata over shared
        # buffers, Include/ResourceRegistry.h:30-36)
        for i in range(len(positions)):
            k = int(proto_idx[i]) if len(proto_idx) else 0
            k = min(k, len(proto_data) - 1)
            (pts, tris, tri_face, uvs, extent, mat_path, local,
             ds) = proto_data[k]
            trs = math3d.compose_trs(
                positions[i],
                None if orientations is None else orientations[i],
                None if scales is None else scales[i])
            self.registry.push_mesh(MeshRecord(
                path=f"{prim.path}.inst{i:05d}", points=pts, tris=tris,
                tri_face=tri_face, uvs=uvs,
                transform=(pi_world @ trs @ local).astype(np.float32),
                material_path=mat_path, extent=extent,
                proto=f"{prim.path}.proto{k}", double_sided=ds))

    def _sync_material(self, prim: Prim) -> None:
        desc = material_mod.sync_material(
            self.stage, prim, self.config.limits.texture_res)
        self.registry.push_material(desc)

    def _sync_light(self, prim: Prim) -> None:
        m = self.stage.world_transform(prim)
        if prim.type_name == "DistantLight":
            # USD convention: a distant light emits along its local -Z;
            # store the unit direction TO the light
            d = -(m[:3, :3] @ np.asarray([0.0, 0.0, -1.0], np.float32))
            d = d / max(np.linalg.norm(d), 1e-12)
            # optional override for stages authored without orientation
            d_attr = prim.get("vri:direction")
            if d_attr is not None:
                d = -np.asarray(d_attr, np.float32)
                d = d / max(np.linalg.norm(d), 1e-12)
            self.registry.push_light(LightRecord(
                path=prim.path, position=d,
                color=np.asarray(prim.get("inputs:color", (1, 1, 1)),
                                 np.float32),
                intensity=float(prim.get("inputs:intensity", 1.0)), kind=1))
            return
        if prim.type_name == "DomeLight":
            # UsdLux dome -> the ambient sky term (no HDRI texture yet)
            self.registry.push_light(LightRecord(
                path=prim.path, position=np.zeros(3, np.float32),
                color=np.asarray(prim.get("inputs:color", (1, 1, 1)),
                                 np.float32),
                intensity=float(prim.get("inputs:intensity", 1.0)), kind=2))
            return
        # standard UsdLux placement: the light sits at its xform origin;
        # `vri:position` is only an explicit (local-space) override
        local = prim.get("vri:position")
        pos = (m[:3, 3] if local is None
               else (m[:3, :3] @ np.asarray(local, np.float32)) + m[:3, 3])
        self.registry.push_light(LightRecord(
            path=prim.path, position=pos,
            color=np.asarray(prim.get("inputs:color", (1, 1, 1)), np.float32),
            intensity=float(prim.get("inputs:intensity", 1.0))))

    def _animated_prims(self):
        """(mesh path, 'transform'|'geometry') pairs affected by authored
        timeSamples, cached after the first timed sync.  An animated
        xformOp on an ancestor Xform dirties every Mesh underneath it."""
        cached = getattr(self, "_animated_cache", None)
        if cached is not None:
            return cached
        out = []
        for prim in self.stage.traverse():
            kinds = set()
            for a in prim.attributes.values():
                if not a.metadata.get("timeSamples"):
                    continue
                if a.name.startswith("xformOp"):
                    kinds.add("transform")
                elif a.name in ("points", "faceVertexIndices",
                                "faceVertexCounts"):
                    kinds.add("geometry")
            if not kinds:
                continue
            kind = "geometry" if "geometry" in kinds else "transform"
            if prim.type_name == "Mesh":
                out.append((prim.path, kind))
            else:
                for sub in prim.traverse():
                    if sub.type_name == "Mesh":
                        out.append((sub.path, kind))
        self._animated_cache = out
        return out

    # -- edits ---------------------------------------------------------------

    def apply_animation(self, changed_paths) -> None:
        for p in changed_paths:
            self.tracker.mark_transform(p)
