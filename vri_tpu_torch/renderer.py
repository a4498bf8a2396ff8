"""High-level renderer facade (counterpart of ``vri_tpu/renderer.py``).

Owns the delegate, builds the SDF cascades when the scene or the focus
changes (full cell-binned build with demand-scaled list caps, then the
radiance bake), and renders GI frames on an explicit ``device``.  GI
samples come from a ``torch.Generator`` seeded with the frame index.

The raster overflow ladder is kept: an overflowed frame makes later
frames use 2x, then 4x list capacities.  Its last rung, the
capacity-free ranged kernel (K6), is not ported, so a frame that would
need it raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from vri_tpu.config import DebugMode, RenderConfig
from vri_tpu.hydra.camera import CameraState
from vri_tpu.usd.stage import Stage
from vri_tpu_torch.hydra.delegate import RenderDelegate
from vri_tpu_torch.ops import sdf as sdf_mod
from vri_tpu_torch.ops import sdf_build
from vri_tpu_torch.passes import frame as frame_mod
from vri_tpu_torch.registry import SceneBuffers, bake_world

log = logging.getLogger("vri_tpu_torch")


class Renderer:
    def __init__(self, config: Optional[RenderConfig] = None, *, device):
        self.config = config or RenderConfig()
        self.device = torch.device(device)
        self.delegate = RenderDelegate(self.config, device=self.device)
        self.scene: Optional[SceneBuffers] = None
        self.cascades = None
        self._build_state = None
        self._sdf_cfg_effective = None
        self._cascade_focus = None
        self._scene_version = -1
        self._sync_count = 0
        self.frame_index = 0
        #: wall milliseconds of the last cascade (re)build + bake
        self.last_build_ms: float | None = None
        # list-raster overflow escalation: 1 -> 2x -> 4x list capacities
        self._raster_caps_scale = 1

    # -- scene ----------------------------------------------------------------

    def load_stage(self, stage_or_path) -> None:
        stage = (stage_or_path if isinstance(stage_or_path, Stage)
                 else Stage.open(stage_or_path))
        self.delegate.populate(stage)
        self.sync()

    def sync(self) -> SceneBuffers:
        """Sync dirty prims (Hydra sync phase analog)."""
        dirty = self.delegate.tracker.any_dirty
        self.scene = self.delegate.sync()
        if dirty:
            self._sync_count += 1
        return self.scene

    @property
    def camera(self) -> Optional[CameraState]:
        return self.delegate.camera

    # -- SDF cascades -----------------------------------------------------------

    def ensure_cascades(self, eye=None, focus=None, force: bool = False):
        """(Re)build the cascades when geometry changed or the focus moved
        more than one coarse voxel: a full cell-binned build with list caps
        scaled to the measured demand, then the radiance bake."""
        if self.scene is None:
            raise RuntimeError("load_stage() first")
        cfg = self._sdf_cfg_effective or self.config.sdf
        if focus is None:
            # recenter on the view, clamped into the scene AABB
            if eye is None:
                eye = (self.camera.eye if self.camera is not None
                       else np.zeros(3, np.float32))
            ni = max(int(self.scene.num_instances), 1)
            lo = self.scene.instance_aabb_lo[:ni].cpu().numpy().min(0)
            hi = self.scene.instance_aabb_hi[:ni].cpu().numpy().max(0)
            focus = np.clip(np.asarray(eye, np.float32), lo, hi)
        focus = np.asarray(focus, np.float32)
        coarse = cfg.voxel_size(cfg.num_cascades - 1)
        moved = (self._cascade_focus is None
                 or np.abs(focus - self._cascade_focus).max() > coarse)
        stale = self._scene_version != self._sync_count
        if not (force or self.cascades is None or moved or stale):
            return self.cascades
        if not sdf_build.supports(cfg):
            raise NotImplementedError(
                "the dense SDF build (sdf.build_cascades) is not ported; see "
                "ROADMAP.md 'What comes next', item 3")

        t0 = time.perf_counter()
        scene_b = self.scene.base_view()
        world = bake_world(scene_b)
        centers = sdf_mod.default_centers(cfg, focus, device=self.device)
        # demand pre-pass: scale the list caps so the build drops no ref
        cfg2 = sdf_build.demand_caps(scene_b, world, centers, cfg)
        if cfg2 is not cfg:
            log.info("SDF list caps demand-scaled: cell %d -> %d, global "
                     "%d -> %d", cfg.cell_list_cap, cfg2.cell_list_cap,
                     cfg.global_list_cap, cfg2.global_list_cap)
            cfg = cfg2
            self._sdf_cfg_effective = cfg
        cascades, state = sdf_build.build_for_scene(scene_b, world, centers,
                                                    cfg)
        self.cascades = sdf_mod.bake_brick_lighting(
            cascades, self.scene, config=cfg, alive=state.alive)
        self._build_state = state
        self._cascade_focus = focus
        self._scene_version = self._sync_count
        list_ov = int(state.list_overflow)
        self.last_build_ms = 1e3 * (time.perf_counter() - t0)
        log.info("SDF cascades rebuilt in %.1f ms (%d bricks, %d brick "
                 "overflow, %d list-ref drops)", self.last_build_ms,
                 int(self.cascades.num_bricks), int(self.cascades.overflow),
                 list_ov)
        if list_ov:
            log.warning("SDF cell/glob list capacity dropped %d refs",
                        list_ov)
        return self.cascades

    @property
    def list_overflow(self) -> int:
        """References the last SDF build dropped at list capacity."""
        return (0 if self._build_state is None
                else int(self._build_state.list_overflow))

    # -- frames -----------------------------------------------------------------

    def render(self, camera: Optional[CameraState] = None,
               mode: int = DebugMode.NONE, gi: bool = True,
               samples: int = 1, backend: str = "raster",
               gi_scale: int = 1, to_numpy: bool = True,
               uniforms: torch.Tensor | None = None
               ) -> Dict[str, np.ndarray]:
        """One GI frame.  ``uniforms`` (samples, H*W, 2) replaces the
        generator draws (parity tests hand in the reference's samples)."""
        if self.scene is None:
            raise RuntimeError("load_stage() first")
        if not gi and mode < DebugMode.SDF_DISTANCE:
            raise NotImplementedError(
                "the direct-only frame (render_frame) is not ported; "
                "render with gi=True")
        cam = camera or self.camera
        if cam is None:
            raise RuntimeError("no camera")
        if backend == "raster" and self._raster_caps_scale > 1:
            if self._raster_caps_scale > 4:
                raise NotImplementedError(
                    "the raster overflowed at 4x list capacities and the "
                    "next rung, the ranged kernel (K6), is not ported; see "
                    "ROADMAP.md 'What comes next', item 4")
            backend = f"raster{self._raster_caps_scale}x"
        h, w = self.config.height, self.config.width
        fp = frame_mod.FrameParams.from_camera(cam, h, device=self.device)
        cascades = self.ensure_cascades(eye=cam.eye)
        gen = None
        if uniforms is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.frame_index)
        aovs = frame_mod.render_frame_gi(
            self.scene, fp, cascades, height=h, width=w,
            config=self.config.sdf, mode=mode,
            backend=backend, samples=samples, use_cache=True,
            gi_scale=gi_scale, lod_tau=self.config.lod_tau, generator=gen,
            uniforms=uniforms)
        self.frame_index += 1
        over = aovs.get("raster_overflow_tiles")
        if over is not None and to_numpy and int(over) > 0:
            self._raster_caps_scale *= 2
            log.warning("list raster overflowed (%d; geometry may be "
                        "missing there); subsequent frames escalate to %dx "
                        "list capacities", int(over), self._raster_caps_scale)
        if to_numpy:
            return {k: v.cpu().numpy() for k, v in aovs.items()}
        return aovs

    def render_progressive(self, n_frames: int,
                           camera: Optional[CameraState] = None,
                           samples: int = 1, gi_scale: int = 1,
                           backend: str = "raster") -> np.ndarray:
        """Accumulate n GI frames (fixed camera) into a running mean."""
        color = None
        count = torch.zeros((), device=self.device)
        for _ in range(n_frames):
            aovs = self.render(camera=camera, gi=True, samples=samples,
                               gi_scale=gi_scale, backend=backend,
                               to_numpy=False)
            if color is None:
                color = torch.zeros_like(aovs["color"])
            color, count = frame_mod.accumulate(color, count, aovs["color"])
        return color.cpu().numpy()
