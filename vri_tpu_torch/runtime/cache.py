"""Scene cache (copy of ``vri_tpu/runtime/cache.py``): checkpoint and
resume of a synced scene.

The cache stores the post-sync registry content (triangulated meshes
with uint16-quantized positions, materials, lights) in one compressed
``.npz`` and restores it without touching the USD stage.  The format and
its version are the JAX package's, so a cache written by either package
loads in the other; both quantize through the same native library
(``native/src``).
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np

from vri_tpu_torch import _native
from vri_tpu_torch.hydra.material import MaterialDesc
from vri_tpu_torch.registry import LightRecord, MeshRecord, ResourceRegistry

log = logging.getLogger("vri_tpu_torch")

_FORMAT_VERSION = 3


def save_scene_cache(registry: ResourceRegistry, path: str) -> None:
    arrays = {}
    meta = {"version": _FORMAT_VERSION, "meshes": [], "materials": [],
            "lights": []}
    geom_of = {}          # proto key -> index whose arrays hold the geometry
    for i, mesh_path in enumerate(registry._order):
        rec = registry._meshes[mesh_path]
        key = rec.proto or mesh_path
        src = geom_of.setdefault(key, i)
        if src == i:      # first record of this prototype stores geometry
            q, aabb = _native.quantize_positions(rec.points)
            arrays[f"m{i}_pos_q"] = q
            arrays[f"m{i}_pos_aabb"] = aabb
            arrays[f"m{i}_tris"] = rec.tris
            arrays[f"m{i}_tri_face"] = rec.tri_face
            arrays[f"m{i}_uvs"] = rec.uvs.astype(np.float16)
        arrays[f"m{i}_transform"] = rec.transform
        arrays[f"m{i}_extent"] = rec.extent
        meta["meshes"].append({"path": mesh_path,
                               "material": rec.material_path,
                               "proto": rec.proto, "geom": src,
                               "double_sided": bool(rec.double_sided)})
    for j, mat_path in enumerate(sorted(registry._materials)):
        desc = registry._materials[mat_path]
        arrays[f"mat{j}_base"] = desc.base_color
        arrays[f"mat{j}_emissive"] = desc.emissive
        arrays[f"mat{j}_params"] = np.asarray(
            [desc.roughness, desc.metallic], np.float32)
        if desc.texture is not None:
            arrays[f"mat{j}_tex"] = (desc.texture * 255).astype(np.uint8)
        meta["materials"].append({"path": mat_path,
                                  "textured": desc.texture is not None})
    for k, light_path in enumerate(sorted(registry._lights)):
        rec = registry._lights[light_path]
        arrays[f"l{k}"] = np.concatenate(
            [rec.position, rec.color, [rec.intensity],
             [float(rec.kind)]]).astype(np.float32)
        meta["lights"].append({"path": light_path})
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8)
    np.savez_compressed(path, **arrays)
    log.info("scene cache saved: %s (%d meshes, %d materials)", path,
             len(meta["meshes"]), len(meta["materials"]))


def load_scene_cache(registry: ResourceRegistry, path: str) -> None:
    """Repopulate a registry from a cache file (bypasses USD entirely)."""
    t0 = time.perf_counter()
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"scene cache version {meta['version']} != "
                         f"{_FORMAT_VERSION}")
    for j, m in enumerate(meta["materials"]):
        tex = None
        if m["textured"]:
            tex = z[f"mat{j}_tex"].astype(np.float32) / 255.0
        params = z[f"mat{j}_params"]
        registry.push_material(MaterialDesc(
            path=m["path"], base_color=z[f"mat{j}_base"],
            emissive=z[f"mat{j}_emissive"], roughness=float(params[0]),
            metallic=float(params[1]), texture=tex))
    geom_cache = {}       # geometry source index -> decoded arrays (shared)
    for i, m in enumerate(meta["meshes"]):
        g = m.get("geom", i)
        if g not in geom_cache:
            geom_cache[g] = (
                _native.dequantize_positions(z[f"m{g}_pos_q"],
                                             z[f"m{g}_pos_aabb"]),
                z[f"m{g}_tris"], z[f"m{g}_tri_face"],
                z[f"m{g}_uvs"].astype(np.float32))
        points, tris, tri_face, uvs = geom_cache[g]
        registry.push_mesh(MeshRecord(
            path=m["path"], points=points, tris=tris,
            tri_face=tri_face, uvs=uvs,
            transform=z[f"m{i}_transform"], material_path=m["material"],
            extent=z[f"m{i}_extent"], proto=m.get("proto"),
            double_sided=m.get("double_sided", True)))
    for k, l in enumerate(meta["lights"]):
        v = z[f"l{k}"]
        kind = int(v[7]) if len(v) > 7 else 0
        registry.push_light(LightRecord(path=l["path"], position=v[:3],
                                        color=v[3:6], intensity=float(v[6]),
                                        kind=kind))
    log.info("scene cache loaded: %s in %.1f ms", path,
             1e3 * (time.perf_counter() - t0))
