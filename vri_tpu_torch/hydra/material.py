# Copy of vri_tpu/hydra/material.py for the port; only the imports differ.
"""Material prim sync.

TPU-native equivalent of ``Material::Sync`` (Source/Material.cpp:171-227):
walk the material network from the surface terminal, resolve the diffuse /
base color input — either a constant or a texture asset — and produce a
:class:`MaterialDesc` the registry packs into the material table.  Texture
decode mirrors the reference's stb/dds ``ImageLoader``
(Source/Material.cpp:105-169) but resamples every texture to a single fixed
resolution so the device-side material table is one static-shape array (the
TPU analog of the reference's 4096-entry bindless image table,
Source/ResourceRegistry.cpp:47-77).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np

from vri_tpu_torch.usd.stage import Stage
from vri_tpu_torch.usd.usda import AssetPath, Prim

log = logging.getLogger("vri_tpu")


@dataclasses.dataclass
class MaterialDesc:
    path: str
    base_color: np.ndarray                 # (3,) f32
    emissive: np.ndarray                   # (3,) f32
    roughness: float = 0.8
    metallic: float = 0.0
    texture: Optional[np.ndarray] = None   # (T, T, 4) f32 RGBA in [0,1]
    #: UsdPreviewSurface ``opacityThreshold`` — >0 enables alpha cutout
    #: (the reference interleaves an alpha channel at texture load,
    #: Source/Common.cpp:603-633)
    opacity_threshold: float = 0.0

    def content_hash(self) -> int:
        h = hash((tuple(np.round(self.base_color, 6)),
                  tuple(np.round(self.emissive, 6)),
                  round(self.roughness, 6), round(self.metallic, 6),
                  round(self.opacity_threshold, 6)))
        if self.texture is not None:
            h ^= hash(self.texture.tobytes())
        return h


def _find_surface_shader(stage: Stage, material: Prim) -> Optional[Prim]:
    """Follow the surface terminal to the shader prim (reference:
    surface-terminal search over the flattened network,
    Source/Material.cpp:191-199; the reference declares the ``mtlx``
    material render context, Include/RenderDelegate.h:53)."""
    for terminal in ("outputs:surface", "outputs:mtlx:surface"):
        out = material.attributes.get(terminal)
        if out is not None and out.connect:
            target = out.connect.split(".")[0]
            prim = stage.prim_at_path(target)
            if prim is not None:
                return prim
    # fallback: first Shader child with an info:id
    for c in material.children:
        if c.type_name == "Shader" and c.get("info:id"):
            return c
    return None


# MaterialX standard_surface vs UsdPreviewSurface input naming (reference
# tracks the standard-surface names at Include/Material.h:13-16)
_INPUT_ALIASES = {
    "diffuseColor": ("diffuseColor", "base_color", "color"),
    "emissiveColor": ("emissiveColor", "emission_color"),
    "roughness": ("roughness", "specular_roughness"),
    "metallic": ("metallic", "metalness"),
}

_TEXTURE_NODE_IDS = ("UsdUVTexture", "ND_image_color3", "ND_image_color4",
                     "ND_tiledimage_color3")


def _resolve_input(stage: Stage, shader: Prim, name: str, default,
                   _depth: int = 0):
    """Resolve a shader input, following ``.connect`` chains into texture
    nodes (reference: recursive single-parameter resolution,
    ``TryGetSingleParameterForInput``, Source/Material.cpp:46-70).  Accepts
    both UsdPreviewSurface and MaterialX standard_surface input names.

    Returns (value, texture_asset_path_or_None).
    """
    a = None
    for alias in _INPUT_ALIASES.get(name, (name,)):
        a = shader.attributes.get(f"inputs:{alias}")
        if a is not None:
            break
    if a is None:
        return default, None
    tex_path = None
    if a.connect and _depth < 4:
        target = stage.prim_at_path(a.connect.split(".")[0])
        if target is not None:
            node_id = str(target.get("info:id", ""))
            if node_id in _TEXTURE_NODE_IDS:
                f = target.get("inputs:file")
                if isinstance(f, AssetPath):
                    tex_path = stage.resolve_asset(f.path)
            else:
                # pass-through node (e.g. color correct): keep following
                v, tex_path = _resolve_input(stage, target, "in", None,
                                             _depth + 1)
                if v is not None:
                    return v, tex_path
    value = a.value if a.value is not None else default
    return value, tex_path


def load_texture(path: str, resolution: int) -> Optional[np.ndarray]:
    """Decode + resample a texture to (res, res, 4) RGBA float32 in [0,1].

    Sources without an alpha channel get alpha=1 (the reference
    interleaves alpha the same way, Source/Common.cpp:603-633)."""
    if not os.path.exists(path):
        log.warning("texture not found: %s", path)
        return None
    try:
        from PIL import Image

        if path.lower().endswith(".dds"):
            # self-contained BC1/BC2/BC3 + uncompressed decode — the
            # reference keeps DDS blocks GPU-native (Material.cpp:109-125,
            # Vulkan samples BC in hardware); the TPU samples a unified
            # float table, so blocks are decoded once at ingest
            from vri_tpu_torch.utils import dds

            img = Image.fromarray(dds.read_dds(path), "RGBA").resize(
                (resolution, resolution), Image.BILINEAR)
        else:
            img = Image.open(path).convert("RGBA").resize(
                (resolution, resolution), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0
    except Exception as e:  # noqa: BLE001 — any decode failure -> fallback
        log.warning("texture decode failed for %s: %s", path, e)
        return None


def sync_material(stage: Stage, material: Prim, texture_resolution: int
                  ) -> MaterialDesc:
    shader = _find_surface_shader(stage, material)
    base = np.asarray([0.5, 0.5, 0.5], np.float32)
    emissive = np.zeros(3, np.float32)
    rough, metal = 0.8, 0.0
    texture = None
    if shader is not None:
        v, tex_path = _resolve_input(stage, shader, "diffuseColor", base)
        base = np.asarray(v, np.float32).reshape(3)
        if tex_path:
            texture = load_texture(tex_path, texture_resolution)
        v, _ = _resolve_input(stage, shader, "emissiveColor", emissive)
        emissive = np.asarray(v, np.float32).reshape(3)
        v, _ = _resolve_input(stage, shader, "roughness", rough)
        rough = float(np.asarray(v).reshape(-1)[0])
        v, _ = _resolve_input(stage, shader, "metallic", metal)
        metal = float(np.asarray(v).reshape(-1)[0])
        v, _ = _resolve_input(stage, shader, "opacityThreshold", 0.0)
        cutoff = float(np.asarray(v).reshape(-1)[0])
    else:
        cutoff = 0.0
    return MaterialDesc(path=material.path, base_color=base, emissive=emissive,
                        roughness=rough, metallic=metal, texture=texture,
                        opacity_threshold=cutoff)


def default_material() -> MaterialDesc:
    """Fallback slot 0 — the analog of the reference's default 2x2 black
    image patched into unbound table entries (ResourceRegistry.cpp:92-121)."""
    return MaterialDesc(path="<default>",
                        base_color=np.asarray([0.7, 0.7, 0.7], np.float32),
                        emissive=np.zeros(3, np.float32))
