"""Resource registry: synced prims -> packed device tensors.

PyTorch counterpart of ``vri_tpu/registry.py``.  The host-side numpy
packing is the same code (every synced mesh packed into one
structure-of-arrays pool per attribute, pools padded to static
capacities); only the boundary differs: the packed numpy arrays become
``torch`` tensors on an explicit ``device`` through
:func:`scene_from_numpy`, which is also how a scene packed by the JAX
package is carried across.

Geometry stays in object space with per-instance transforms; world-space
vertex positions come from :func:`bake_world`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from vri_tpu_torch.config import RenderConfig, SceneLimits
from vri_tpu_torch.hydra.material import MaterialDesc, default_material
from vri_tpu_torch.ops import texture as texture_mod

log = logging.getLogger("vri_tpu_torch")


@dataclasses.dataclass
class SceneBuffers:
    """Packed scene, device-resident.  Shapes are padded capacities; live
    element counts are 0-d int32 tensors used for masking.  Field meanings
    and the flat / shared-prototype layouts are those of
    ``vri_tpu.registry.SceneBuffers``."""

    positions: torch.Tensor          # (V|Vp, 3) f32
    vertex_instance: torch.Tensor    # (V,)  i32
    tri_vertices: torch.Tensor       # (F, 3) i32 — global EXPANDED vert ids
    tri_uv: torch.Tensor             # (F|Fp, 3, 2) f32 per-corner st
    tri_instance: torch.Tensor       # (F,)  i32
    tri_face: torch.Tensor           # (F|Fp,) i32 authored-face id
    instance_transform: torch.Tensor  # (I, 4, 4) f32 object->world
    instance_material: torch.Tensor  # (I,) i32
    instance_face_offset: torch.Tensor  # (I,) i32
    instance_face_count: torch.Tensor   # (I,) i32
    instance_aabb_lo: torch.Tensor   # (I, 3) f32 world-space AABB
    instance_aabb_hi: torch.Tensor   # (I, 3) f32
    mat_base_color: torch.Tensor     # (M, 3) f32
    mat_emissive: torch.Tensor       # (M, 3) f32
    mat_roughness: torch.Tensor      # (M,) f32
    mat_metallic: torch.Tensor       # (M,) f32
    mat_texture: torch.Tensor        # (M,) i32 texture slot or -1
    textures: torch.Tensor           # (S, T, T, 4) f32 RGBA
    light_position: torch.Tensor     # (L, 3) f32 (direction TO a distant light)
    light_color: torch.Tensor        # (L, 3) f32
    light_intensity: torch.Tensor    # (L,) f32
    light_type: torch.Tensor         # (L,) i32 — 0 point, 1 distant
    sky_color: torch.Tensor          # (3,) f32 — DomeLight ambient term
    num_vertices: torch.Tensor       # () i32
    num_faces: torch.Tensor          # () i32
    num_instances: torch.Tensor      # () i32
    num_lights: torch.Tensor         # () i32
    mat_cutoff: Optional[torch.Tensor] = None        # (M,) f32
    mip_atlas: Optional[texture_mod.MipAtlas] = None
    vertex_proto: Optional[torch.Tensor] = None      # (V,) i32
    tri_proto: Optional[torch.Tensor] = None         # (F,) i32
    instance_double_sided: Optional[torch.Tensor] = None  # (I,) bool
    tri_lod: Optional[torch.Tensor] = None           # (F,) i32
    instance_lod_error: Optional[torch.Tensor] = None  # (I, L+1) f32
    num_faces_total: Optional[torch.Tensor] = None   # () i32
    #: static length of the base-face prefix ([base | LOD tail | pad])
    base_pool_len: Optional[int] = None

    def replace(self, **kw) -> "SceneBuffers":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def base_view(self) -> "SceneBuffers":
        """Chains-free view: the expanded face pools sliced to the
        base-geometry prefix (the SDF builder, BVH and brute paths consume
        this; the raster keeps the full pool)."""
        if self.tri_lod is None or self.base_pool_len is None:
            return self
        n = self.base_pool_len
        return self.replace(
            tri_vertices=self.tri_vertices[:n],
            tri_instance=self.tri_instance[:n],
            tri_uv=(self.tri_uv[:n] if self.tri_proto is None
                    else self.tri_uv),
            tri_face=(self.tri_face[:n] if self.tri_proto is None
                      else self.tri_face),
            tri_proto=(None if self.tri_proto is None
                       else self.tri_proto[:n]),
            tri_lod=None, instance_lod_error=None, num_faces_total=None,
            base_pool_len=None)


#: SceneBuffers fields that hold tensors carried across by scene_from_numpy
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(SceneBuffers)
                      if f.name not in ("mip_atlas", "base_pool_len"))


def scene_from_numpy(arrays: Dict[str, np.ndarray],
                     device) -> SceneBuffers:
    """Numpy arrays keyed by field name -> a SceneBuffers on ``device``.

    The carry-across function: a ``vri_tpu`` SceneBuffers read out with
    ``np.asarray`` field by field (optional fields absent or None) becomes
    the port's scene; ``ResourceRegistry.commit`` builds its own scene
    through the same function.  ``base_pool_len`` may ride along as an int;
    the mip atlas is rebuilt from ``textures``."""
    kw = {}
    for name in TENSOR_FIELDS:
        a = arrays.get(name)
        if a is not None:
            kw[name] = torch.as_tensor(np.array(a), device=device)
    bpl = arrays.get("base_pool_len")
    kw["base_pool_len"] = None if bpl is None else int(bpl)
    kw["mip_atlas"] = texture_mod.build_mip_atlas(kw["textures"])
    return SceneBuffers(**kw)


def bake_world(scene: SceneBuffers) -> torch.Tensor:
    """World-space vertex positions (V, 3): each vertex's instance matrix
    applied to its object-space position (through ``vertex_proto`` under
    shared-prototype instancing).  Written as explicit products and sums
    in the operand order of the reference contraction, so no reduced
    precision matrix path can enter."""
    m = scene.instance_transform[scene.vertex_instance.long()]   # (V, 4, 4)
    pos = (scene.positions if scene.vertex_proto is None
           else scene.positions[scene.vertex_proto.long()])
    p = (m[:, :3, 0] * pos[:, 0:1] + m[:, :3, 1] * pos[:, 1:2]
         + m[:, :3, 2] * pos[:, 2:3])
    return p + m[:, :3, 3]


@dataclasses.dataclass
class MeshRecord:
    """Host-side synced mesh (see ``vri_tpu.registry.MeshRecord``)."""

    path: str
    points: np.ndarray          # (P, 3) f32 object space
    tris: np.ndarray            # (T, 3) i32 local vertex ids
    tri_face: np.ndarray        # (T,)  i32
    uvs: np.ndarray             # (T, 3, 2) f32
    transform: np.ndarray       # (4, 4) f32
    material_path: Optional[str]
    extent: np.ndarray          # (2, 3) f32 object-space AABB
    proto: Optional[str] = None
    double_sided: bool = True


@dataclasses.dataclass
class LightRecord:
    path: str
    position: np.ndarray    # position (point) or unit direction TO the light
    color: np.ndarray
    intensity: float
    kind: int = 0           # 0 point, 1 distant (directional), 2 dome


class ResourceRegistry:
    """Accumulates synced prims and commits them to device tensors."""

    def __init__(self, config: RenderConfig, *, device):
        self.config = config
        self.device = torch.device(device)
        self.limits: SceneLimits = config.limits
        self._meshes: Dict[str, MeshRecord] = {}
        self._materials: Dict[str, MaterialDesc] = {}
        self._lights: Dict[str, LightRecord] = {}
        self._order: List[str] = []          # stable instance ordering
        self._geometry_dirty = True
        self._transforms_dirty = True
        self._materials_dirty = True
        self._lights_dirty = True
        self._scene: Optional[SceneBuffers] = None
        self._dirty_paths: set = set()
        self.last_update: Dict = {"kind": "none"}
        self._lod_cache: Dict[bytes, list] = {}

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- push API -------------------------------------------------------------

    def push_mesh(self, rec: MeshRecord) -> None:
        if rec.path not in self._meshes:
            self._order.append(rec.path)
            self._geometry_dirty = True
        else:
            old = self._meshes[rec.path]

            def _same(a, b):
                return a is b or (a.shape == b.shape and np.array_equal(a, b))
            if not (_same(old.points, rec.points)
                    and _same(old.tris, rec.tris)
                    and _same(old.uvs, rec.uvs)
                    and _same(old.tri_face, rec.tri_face)
                    and old.proto == rec.proto):
                self._geometry_dirty = True
            if old.material_path != rec.material_path:
                self._geometry_dirty = True
            if not np.array_equal(old.transform, rec.transform):
                self._dirty_paths.add(rec.path)
        self._transforms_dirty = True
        self._meshes[rec.path] = rec

    def update_transform(self, path: str, transform: np.ndarray) -> None:
        rec = self._meshes.get(path)
        if rec is not None:
            if not np.array_equal(rec.transform, transform):
                self._dirty_paths.add(path)
            rec.transform = np.asarray(transform, np.float32)
            self._transforms_dirty = True

    def remove_mesh(self, path: str) -> None:
        if path in self._meshes:
            del self._meshes[path]
            self._order.remove(path)
            self._geometry_dirty = True

    def push_material(self, desc: MaterialDesc) -> None:
        old = self._materials.get(desc.path)
        if old is None or old.content_hash() != desc.content_hash():
            self._materials_dirty = True
        self._materials[desc.path] = desc

    def push_light(self, rec: LightRecord) -> None:
        self._lights[rec.path] = rec
        self._lights_dirty = True

    # -- commit ---------------------------------------------------------------

    def commit(self) -> SceneBuffers:
        """Pack host records into padded pools and upload what changed: a
        full repack only when geometry or materials changed; transform or
        light edits replace just those tensors."""
        if self._scene is None or self._geometry_dirty or self._materials_dirty:
            self._scene = scene_from_numpy(self.pack_numpy(), self.device)
            self.last_update = {"kind": "full"}
        else:
            kind = "none"
            if self._transforms_dirty:
                ids = sorted(self._order.index(p) for p in self._dirty_paths
                             if p in self._meshes)
                old_lo = self._scene.instance_aabb_lo.cpu().numpy()[ids]
                old_hi = self._scene.instance_aabb_hi.cpu().numpy()[ids]
                tr, lo, hi = self._pack_transforms()
                self._scene = self._scene.replace(
                    instance_transform=self._dev(tr),
                    instance_aabb_lo=self._dev(lo),
                    instance_aabb_hi=self._dev(hi))
                kind = "transforms"
                self.last_update = {
                    "kind": kind, "dirty_instances": ids,
                    "old_lo": old_lo, "old_hi": old_hi,
                    "new_lo": lo[ids], "new_hi": hi[ids]}
            if self._lights_dirty:
                lp, lc, li, lt, nl, sky = self._pack_lights()
                self._scene = self._scene.replace(
                    light_position=self._dev(lp), light_color=self._dev(lc),
                    light_intensity=self._dev(li),
                    light_type=self._dev(lt),
                    num_lights=self._dev(np.int32(nl)),
                    sky_color=self._dev(sky))
                if kind == "none":
                    self.last_update = {"kind": "lights"}
            if kind == "none" and not self._lights_dirty:
                self.last_update = {"kind": "none"}
        self._geometry_dirty = self._transforms_dirty = False
        self._materials_dirty = self._lights_dirty = False
        self._dirty_paths.clear()
        return self._scene

    # -- packing internals (host numpy, as vri_tpu.registry) -----------------

    def _material_slots(self) -> Dict[Optional[str], int]:
        """Assign material slots, dedup by content hash."""
        slots: Dict[Optional[str], int] = {None: 0}
        packed: List[MaterialDesc] = [default_material()]
        hash_to_slot: Dict[int, int] = {packed[0].content_hash(): 0}
        for path in sorted(self._materials):
            desc = self._materials[path]
            h = desc.content_hash()
            if h in hash_to_slot:
                slots[path] = hash_to_slot[h]
            else:
                if len(packed) >= self.limits.max_materials:
                    log.warning("material table full (%d); %s -> default",
                                self.limits.max_materials, path)
                    slots[path] = 0
                    continue
                hash_to_slot[h] = len(packed)
                slots[path] = len(packed)
                packed.append(desc)
        self._packed_materials = packed
        return slots

    def _pack_transforms(self):
        n = len(self._order)
        cap = max(_round_up(n, 8), 8)
        tr = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        lo = np.zeros((cap, 3), np.float32)
        hi = np.zeros((cap, 3), np.float32)
        for i, path in enumerate(self._order):
            rec = self._meshes[path]
            tr[i] = rec.transform
            corners = _aabb_corners(rec.extent)
            wc = corners @ rec.transform[:3, :3].T + rec.transform[:3, 3]
            lo[i], hi[i] = wc.min(0), wc.max(0)
        return tr, lo, hi

    def _pack_lights(self):
        # exact capacity: every padded light slot costs a full shadow march
        # per pixel; DomeLights become the ambient sky term
        direct = {p: r for p, r in self._lights.items() if r.kind != 2}
        sky = np.asarray((0.02, 0.025, 0.035), np.float32)  # default sky
        domes = [r for r in self._lights.values() if r.kind == 2]
        if domes:
            sky = np.sum([r.color * r.intensity for r in domes], axis=0) \
                .astype(np.float32)
        n = len(direct)
        cap = max(n, 1)
        lp = np.zeros((cap, 3), np.float32)
        lc = np.ones((cap, 3), np.float32)
        li = np.zeros((cap,), np.float32)
        lt = np.zeros((cap,), np.int32)
        for i, path in enumerate(sorted(direct)):
            rec = direct[path]
            lp[i], lc[i], li[i] = rec.position, rec.color, rec.intensity
            lt[i] = rec.kind
        return lp, lc, li, lt, n, sky

    def _lod_chain(self, rec: MeshRecord) -> list:
        """Discrete LOD chain for one mesh: [(src_tri_ids, vmap, err), ...]
        (the native QEM simplifier; cached by geometry content hash)."""
        import hashlib

        from vri_tpu_torch import _native as native_rt

        cfg = self.config
        nt = len(rec.tris)
        key = hashlib.blake2b(
            rec.points.tobytes() + rec.tris.tobytes()
            + bytes([cfg.lod_levels]) + str(cfg.lod_ratio).encode(),
            digest_size=16).digest()
        hit = self._lod_cache.get(key)
        if hit is not None:
            return hit
        chain = []
        tris_cur = np.ascontiguousarray(rec.tris, np.int32)
        ids_cur = np.arange(nt, dtype=np.int32)
        vmap_c = np.arange(len(rec.points), dtype=np.int32)
        for lvl in range(1, cfg.lod_levels + 1):
            target = max(int(round(nt * cfg.lod_ratio ** lvl)), 16)
            if len(ids_cur) <= max(target, 24):
                break
            ids_rel, vmap_l, _ = native_rt.simplify_qem(
                rec.points, tris_cur, target)
            if len(ids_rel) >= 0.9 * len(ids_cur):
                break                      # lock-bound: no real progress
            ids_cur = ids_cur[ids_rel]
            vmap_c = vmap_l[vmap_c]
            tris_cur = vmap_l[tris_cur][ids_rel]
            err = native_rt._deviation(
                np.ascontiguousarray(rec.points, np.float32),
                np.ascontiguousarray(rec.tris, np.int32), vmap_c)
            chain.append((ids_cur.copy(), vmap_c.copy(), float(err)))
        self._lod_cache[key] = chain
        return chain

    def pack_numpy(self) -> Dict[str, np.ndarray]:
        """Full repack of every record into padded numpy pools, keyed by
        SceneBuffers field name (the input of :func:`scene_from_numpy`)."""
        lim = self.limits
        slots = self._material_slots()

        total_v = sum(len(self._meshes[p].points) for p in self._order)
        total_f = sum(len(self._meshes[p].tris) for p in self._order)

        n_levels = self.config.lod_levels
        lod_chains: Dict[str, list] = {}
        lod_f_expanded = 0
        if n_levels > 0:
            proto_of0 = {p: (self._meshes[p].proto or p) for p in self._order}
            for p in self._order:
                k = proto_of0[p]
                if k not in lod_chains:
                    rec = self._meshes[p]
                    lod_chains[k] = (
                        self._lod_chain(rec)
                        if len(rec.tris) >= self.config.lod_min_faces else [])
                lod_f_expanded += sum(len(ids) for ids, _, _ in lod_chains[k])
            if total_f + lod_f_expanded > lim.max_faces:
                log.warning(
                    "LOD chains (%d faces) would exceed the face cap %d; "
                    "packing without LOD", total_f + lod_f_expanded,
                    lim.max_faces)
                lod_chains = {}
                lod_f_expanded = 0
                n_levels = 0
            elif lod_f_expanded == 0:     # every mesh below lod_min_faces
                lod_chains = {}
                n_levels = 0

        V = lim.padded_vertices(total_v)
        F = lim.padded_faces(total_f + lod_f_expanded)
        if total_v > V or total_f + lod_f_expanded > F:
            raise ValueError(
                f"scene exceeds limits: {total_v} verts (cap {V}), "
                f"{total_f} faces (cap {F})")

        n_inst = len(self._order)
        icap = max(_round_up(max(n_inst, 1), 8), 8)
        if n_inst > lim.max_instances:
            raise ValueError(f"{n_inst} instances exceed cap {lim.max_instances}")
        inst_material = np.zeros((icap,), np.int32)
        inst_face_offset = np.zeros((icap,), np.int32)
        inst_face_count = np.zeros((icap,), np.int32)
        inst_double_sided = np.ones((icap,), np.bool_)

        proto_of = {p: (self._meshes[p].proto or p) for p in self._order}
        proto_keys = list(dict.fromkeys(proto_of.values()))
        shared = len(proto_keys) < n_inst

        tri_lod = np.zeros((F,), np.int32) if n_levels else None
        lod_err = (np.full((icap, n_levels + 1), np.inf, np.float32)
                   if n_levels else None)
        if lod_err is not None:
            lod_err[:, 0] = 0.0

        if not shared:
            positions = np.zeros((V, 3), np.float32)
            vertex_instance = np.zeros((V,), np.int32)
            tri_vertices = np.zeros((F, 3), np.int32)
            tri_uv = np.zeros((F, 3, 2), np.float32)
            tri_instance = np.zeros((F,), np.int32)
            tri_face = np.zeros((F,), np.int32)
            vertex_proto = tri_proto = None

            voff = foff = 0
            inst_voff = np.zeros((icap,), np.int64)
            for i, path in enumerate(self._order):
                rec = self._meshes[path]
                nv, nf = len(rec.points), len(rec.tris)
                positions[voff:voff + nv] = rec.points
                vertex_instance[voff:voff + nv] = i
                tri_vertices[foff:foff + nf] = rec.tris + voff
                tri_uv[foff:foff + nf] = rec.uvs
                tri_instance[foff:foff + nf] = i
                tri_face[foff:foff + nf] = rec.tri_face
                inst_material[i] = slots.get(rec.material_path, 0)
                inst_double_sided[i] = rec.double_sided
                inst_face_offset[i] = foff
                inst_face_count[i] = nf
                inst_voff[i] = voff
                voff += nv
                foff += nf
            # LOD tail after every base face (LOD faces reference base verts)
            for i, path in enumerate(self._order):
                rec = self._meshes[path]
                for lvl, (ids, vmap, err) in enumerate(
                        lod_chains.get(proto_of[path], []), start=1):
                    nfl = len(ids)
                    tri_vertices[foff:foff + nfl] = \
                        vmap[rec.tris[ids]] + inst_voff[i]
                    tri_uv[foff:foff + nfl] = rec.uvs[ids]
                    tri_face[foff:foff + nfl] = rec.tri_face[ids]
                    tri_instance[foff:foff + nfl] = i
                    tri_lod[foff:foff + nfl] = lvl
                    lod_err[i, lvl] = err
                    foff += nfl
        else:
            # prototype pools packed once per unique proto
            first = {}
            for p in self._order:
                first.setdefault(proto_of[p], self._meshes[p])
            pv_off, pf_off, pf_lod_off = {}, {}, {}
            vp = fp_ = 0
            for k in proto_keys:
                rec = first[k]
                pv_off[k] = vp
                pf_off[k] = fp_
                vp += len(rec.points)
                fp_ += len(rec.tris)
            for k in proto_keys:           # LOD proto faces after all base
                offs = []
                for ids, _, _ in lod_chains.get(k, []):
                    offs.append(fp_)
                    fp_ += len(ids)
                pf_lod_off[k] = offs
            Vp = max(_round_up(vp, lim.pad), lim.pad)
            Fp = max(_round_up(fp_, lim.pad), lim.pad)
            positions = np.zeros((Vp, 3), np.float32)
            tri_uv = np.zeros((Fp, 3, 2), np.float32)
            tri_face = np.zeros((Fp,), np.int32)
            proto_tris = np.zeros((Fp, 3), np.int32)   # proto-local ids
            for k in proto_keys:
                rec = first[k]
                vo, fo = pv_off[k], pf_off[k]
                positions[vo:vo + len(rec.points)] = rec.points
                tri_uv[fo:fo + len(rec.tris)] = rec.uvs
                tri_face[fo:fo + len(rec.tris)] = rec.tri_face
                proto_tris[fo:fo + len(rec.tris)] = rec.tris
                for off, (ids, vmap, _err) in zip(
                        pf_lod_off[k], lod_chains.get(k, [])):
                    tri_uv[off:off + len(ids)] = rec.uvs[ids]
                    tri_face[off:off + len(ids)] = rec.tri_face[ids]
                    proto_tris[off:off + len(ids)] = vmap[rec.tris[ids]]

            vertex_instance = np.zeros((V,), np.int32)
            vertex_proto = np.zeros((V,), np.int32)
            tri_vertices = np.zeros((F, 3), np.int32)
            tri_instance = np.zeros((F,), np.int32)
            tri_proto = np.zeros((F,), np.int32)
            voff = foff = 0
            inst_voff = np.zeros((icap,), np.int64)
            for i, path in enumerate(self._order):
                rec = self._meshes[path]
                k = proto_of[path]
                nv, nf = len(rec.points), len(rec.tris)
                vertex_instance[voff:voff + nv] = i
                vertex_proto[voff:voff + nv] = np.arange(
                    pv_off[k], pv_off[k] + nv, dtype=np.int32)
                tri_vertices[foff:foff + nf] = \
                    proto_tris[pf_off[k]:pf_off[k] + nf] + voff
                tri_instance[foff:foff + nf] = i
                tri_proto[foff:foff + nf] = np.arange(
                    pf_off[k], pf_off[k] + nf, dtype=np.int32)
                inst_material[i] = slots.get(rec.material_path, 0)
                inst_double_sided[i] = rec.double_sided
                inst_face_offset[i] = foff
                inst_face_count[i] = nf
                inst_voff[i] = voff
                voff += nv
                foff += nf
            for i, path in enumerate(self._order):   # expanded LOD tail
                k = proto_of[path]
                for lvl, (off, (ids, vmap, err)) in enumerate(
                        zip(pf_lod_off[k], lod_chains.get(k, [])), start=1):
                    nfl = len(ids)
                    tri_vertices[foff:foff + nfl] = \
                        proto_tris[off:off + nfl] + inst_voff[i]
                    tri_instance[foff:foff + nfl] = i
                    tri_proto[foff:foff + nfl] = np.arange(
                        off, off + nfl, dtype=np.int32)
                    tri_lod[foff:foff + nfl] = lvl
                    lod_err[i, lvl] = err
                    foff += nfl
            log.info("proto pack: %d instances share %d prototypes "
                     "(%d proto verts for %d expanded)",
                     n_inst, len(proto_keys), vp, total_v)

        transforms, aabb_lo, aabb_hi = self._pack_transforms()
        if transforms.shape[0] != icap:
            raise AssertionError("transform pool does not match instances")

        mats = self._packed_materials
        mcap = max(_round_up(len(mats), 8), 8)
        base = np.zeros((mcap, 3), np.float32)
        emis = np.zeros((mcap, 3), np.float32)
        rough = np.full((mcap,), 0.8, np.float32)
        metal = np.zeros((mcap,), np.float32)
        cutoff = np.zeros((mcap,), np.float32)
        tex_slot = np.full((mcap,), -1, np.int32)
        tex_list: List[np.ndarray] = []
        for i, m in enumerate(mats):
            base[i], emis[i] = m.base_color, m.emissive
            rough[i], metal[i] = m.roughness, m.metallic
            cutoff[i] = getattr(m, "opacity_threshold", 0.0)
            if m.texture is not None:
                tex = m.texture.astype(np.float32)
                if tex.shape[-1] == 3:      # RGB source: alpha = 1
                    tex = np.concatenate(
                        [tex, np.ones(tex.shape[:-1] + (1,), np.float32)],
                        axis=-1)
                tex_slot[i] = len(tex_list)
                tex_list.append(tex)
        T = lim.texture_res
        if tex_list:
            textures = np.stack(tex_list)
        else:
            # zero-size slot dim: the resolve skips texture sampling
            textures = np.ones((0, T, T, 4), np.float32)

        lp, lc, li, lt, nl, sky = self._pack_lights()
        log.info("registry commit: %d instances, %d verts (cap %d), "
                 "%d tris (cap %d), %d materials, %d textures, %d lights",
                 n_inst, total_v, V, total_f, F, len(mats), len(tex_list), nl)
        return dict(
            positions=positions, vertex_instance=vertex_instance,
            tri_vertices=tri_vertices, tri_uv=tri_uv,
            tri_instance=tri_instance, tri_face=tri_face,
            instance_transform=transforms, instance_material=inst_material,
            instance_double_sided=inst_double_sided,
            instance_face_offset=inst_face_offset,
            instance_face_count=inst_face_count,
            instance_aabb_lo=aabb_lo, instance_aabb_hi=aabb_hi,
            mat_base_color=base, mat_emissive=emis, mat_roughness=rough,
            mat_metallic=metal, mat_texture=tex_slot, mat_cutoff=cutoff,
            textures=textures, light_position=lp, light_color=lc,
            light_intensity=li, light_type=lt,
            num_vertices=np.int32(total_v), num_faces=np.int32(total_f),
            num_instances=np.int32(n_inst), num_lights=np.int32(nl),
            sky_color=sky, vertex_proto=vertex_proto, tri_proto=tri_proto,
            tri_lod=tri_lod, instance_lod_error=lod_err,
            num_faces_total=(None if tri_lod is None
                             else np.int32(total_f + lod_f_expanded)),
            base_pool_len=(None if tri_lod is None
                           else min(F, _round_up(total_f, lim.pad))))

    # -- stats ----------------------------------------------------------------

    def device_bytes(self) -> int:
        if self._scene is None:
            return 0
        return sum(getattr(self._scene, n).numel()
                   * getattr(self._scene, n).element_size()
                   for n in TENSOR_FIELDS
                   if getattr(self._scene, n) is not None)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _aabb_corners(extent: np.ndarray) -> np.ndarray:
    lo, hi = extent
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                    np.float32)
