"""One static-stage GI frame (counterpart of ``render_frame_gi`` in
``vri_tpu/passes/frame.py``): bake world vertices -> camera rays ->
sorted-list raster -> G-buffer resolve -> SDF-shadowed direct light + one
SDF-marched GI bounce.

Ported: mode NONE at ``gi_scale=1`` with the sorted raster at every
frame size (the JAX package's binned/sorted dispatch thresholds were
tuned for the TPU).  Not ported yet, each raising
``NotImplementedError`` that names its ROADMAP.md item: the SDF debug
modes (item 1), reduced-rate GI and the temporal frame (item 2), the
binned and ranged raster tiers (item 4), LOD masks (item 6) and the
frustum compaction of very large face pools.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from vri_tpu.config import DebugMode
from vri_tpu_torch.ops import gi as gi_mod
from vri_tpu_torch.ops import intersect, raygen, shading
from vri_tpu_torch.ops import rasterize as raster_mod
from vri_tpu_torch.ops.geometry import norm3
from vri_tpu_torch.registry import SceneBuffers, bake_world

# face pools at or above this size take the JAX package's frustum
# compaction before setup (frame.py:124), which is not ported yet
_CULL_COMPACT_MIN_POOL = 1 << 19


@dataclasses.dataclass
class FrameParams:
    """Per-frame camera + settings as device tensors."""

    view_proj: torch.Tensor      # (4, 4)
    inv_view_proj: torch.Tensor  # (4, 4)
    eye: torch.Tensor            # (3,)
    near: torch.Tensor           # ()
    far: torch.Tensor            # ()
    #: ray-cone pixel spread (2*tan(fov_y/2)/height); 0 disables mip LOD
    pixel_spread: torch.Tensor | None = None

    @classmethod
    def from_camera(cls, cam, height: int | None = None, *,
                    device) -> "FrameParams":
        spread = (2.0 * math.tan(0.5 * cam.fov_y) / height) if height else 0.0

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)
        return cls(view_proj=f32(cam.view_proj),
                   inv_view_proj=f32(cam.inv_view_proj), eye=f32(cam.eye),
                   near=f32(cam.near), far=f32(cam.far),
                   pixel_spread=f32(spread))


def _raster_variant(backend: str) -> tuple:
    """Raster backend string -> (variant, caps_scale): ``raster2x`` /
    ``raster4x`` widen the list capacities, ``raster_ranged`` names the
    capacity-free kernel."""
    if backend == "raster_ranged":
        return "ranged", 1
    if backend in ("raster2x", "raster4x"):
        return "auto", int(backend[6])
    return "auto", 1


def _cull_sign_instance(scene: SceneBuffers):
    """Per-instance backface-cull signs from USD doubleSided: 0 =
    two-sided, +1 = keep CCW-front, -1 under a mirroring transform; None
    when every instance is two-sided."""
    ds = scene.instance_double_sided
    if ds is None:
        return None
    m = scene.instance_transform
    det = (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
           - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
           + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))
    return torch.where(ds, 0.0, torch.sign(det))


def _cull_sign(scene: SceneBuffers):
    """Per-face cull signs; None when every instance is two-sided."""
    inst = _cull_sign_instance(scene)
    return None if inst is None else inst[scene.tri_instance.long()]


def _visibility_raster(scene: SceneBuffers, world_verts, frame: FrameParams,
                       height: int, width: int, variant: str = "auto",
                       caps_scale: int = 1, lod_tau: float = 0.75):
    """The sorted-list raster at every frame size."""
    if scene.tri_lod is not None and lod_tau > 0:
        raise NotImplementedError(
            "LOD face masks are not ported; see ROADMAP.md 'What comes "
            "next', item 6")
    if scene.tri_vertices.shape[0] >= _CULL_COMPACT_MIN_POOL:
        raise NotImplementedError(
            "frustum compaction of face pools >= 2^19 slots is not ported; "
            "see ROADMAP.md 'What comes next', item 4")
    if variant == "ranged":
        raise NotImplementedError(
            "the ranged raster kernel (K6) is not ported; see ROADMAP.md "
            "'What comes next', item 4")
    hit, _ = raster_mod.rasterize_sorted(
        world_verts, scene.tri_vertices, scene.num_faces, frame.view_proj,
        height=height, width=width, caps_scale=caps_scale,
        cull_sign=_cull_sign(scene))
    return hit


def render_frame_gi(scene: SceneBuffers, frame: FrameParams,
                    cascades, *, height: int, width: int, config,
                    mode: int = DebugMode.NONE, backend: str = "raster",
                    samples: int = 1, use_cache: bool = False,
                    gi_scale: int = 1, lod_tau: float = 0.75,
                    generator: torch.Generator | None = None,
                    uniforms: torch.Tensor | None = None
                    ) -> Dict[str, torch.Tensor]:
    """Full frame with the SDF-driven lightloop: visibility -> G-buffer
    -> direct + 1-bounce GI (or a G-buffer debug view).  GI samples come
    from ``uniforms`` (samples, H*W, 2) or ``generator``."""
    if mode >= DebugMode.SDF_DISTANCE:
        raise NotImplementedError(
            "SDF debug views need the trilinear march; see ROADMAP.md "
            "'What comes next', item 1")
    if gi_scale != 1:
        raise NotImplementedError(
            "reduced-rate GI (gi_scale > 1) is not ported; see ROADMAP.md "
            "'What comes next', item 2")
    if not backend.startswith("raster"):
        raise NotImplementedError(
            f"backend {backend!r} is not ported; see ROADMAP.md 'What comes "
            "next', item 7")
    world_verts = bake_world(scene)
    origins, dirs = raygen.camera_rays(frame.inv_view_proj, frame.eye,
                                       height, width)
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    variant, caps_scale = _raster_variant(backend)
    hit = _visibility_raster(scene, world_verts, frame, height, width,
                             variant=variant, caps_scale=caps_scale,
                             lod_tau=lod_tau)
    gb = shading.resolve_gbuffer(scene, world_verts, hit, o, d,
                                 pixel_spread=frame.pixel_spread)
    # raster depth is NDC: report the world-space ray distance instead
    t = norm3(gb.position - frame.eye[None, :])
    gb = gb.replace(depth=torch.where(gb.valid, t, intersect.INF))

    if mode == DebugMode.NONE:
        color = gi_mod.lightloop(gb, scene, cascades, config=config,
                                 samples=samples, generator=generator,
                                 uniforms=uniforms, use_cache=use_cache)
    else:
        color = shading.debug_color(mode, gb)

    out = {
        "color": color.reshape(height, width, color.shape[-1]),
        "depth": gb.depth.reshape(height, width),
        "instance_id": gb.instance.reshape(height, width),
        "normal": gb.normal.reshape(height, width, 3),
        "albedo": gb.albedo.reshape(height, width, 3),
    }
    if hit.overflow is not None:
        out["raster_overflow_tiles"] = hit.overflow
    return out


def accumulate(prev_color: torch.Tensor, prev_count: torch.Tensor,
               new_color: torch.Tensor):
    """Progressive accumulation (running mean)."""
    count = prev_count + 1.0
    color = prev_color + (new_color - prev_color) / count
    return color, count
