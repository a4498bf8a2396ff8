"""High-level renderer facade (counterpart of ``vri_tpu/renderer.py``).

Owns the delegate, keeps the SDF cascades in step with the scene and the
focus (a full cell-binned build with demand-scaled list caps, the
bounded update of a transforms-only edit, or the clipmap scroll of a
moved focus; the dense build for the configurations the cell binning
cannot hold; then the radiance bake), saves and loads the synced scene
as a scene cache, and renders GI frames, direct-only frames with
``gi=False``, SDF debug views, frames at a stage time code and temporal
flythroughs on ``device`` (the CUDA card unless the caller asks for the
CPU).  GI samples come from a ``torch.Generator`` seeded with the frame
index.

The raster overflow ladder is the reference's: an overflowed frame makes
later frames use 2x, then 4x list capacities, and after an overflow at
4x the capacity-free ranged tier (``raster_ranged``), where the ladder
stops.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from vri_tpu_torch import _cuda
from vri_tpu_torch.config import DebugMode, RenderConfig
from vri_tpu_torch.hydra.camera import CameraState, FreeCamera
from vri_tpu_torch.usd.stage import Stage
from vri_tpu_torch.hydra.delegate import RenderDelegate
from vri_tpu_torch.ops import sdf as sdf_mod
from vri_tpu_torch.ops import sdf_build
from vri_tpu_torch.passes import frame as frame_mod
from vri_tpu_torch.registry import SceneBuffers, bake_world
from vri_tpu_torch.runtime import profiler

log = logging.getLogger("vri_tpu_torch")


class Renderer:
    def __init__(self, config: Optional[RenderConfig] = None, *,
                 device="cuda"):
        self.config = config or RenderConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer: no CUDA card is present (torch.cuda.is_available()"
                " is false); pass device='cpu' to render with the kernels' "
                "plain PyTorch versions")
        self.delegate = RenderDelegate(self.config, device=self.device)
        self.scene: Optional[SceneBuffers] = None
        self.cascades = None
        self._build_state = None
        self._sdf_cfg_effective = None
        self._cascade_focus = None
        self._scene_version = -1
        self._sync_count = 0
        self.frame_index = 0
        #: wall milliseconds of the last cascade build, update or scroll
        #: with its bake, and which of them it was ("rebuilt", "rebuilt
        #: (dense)", "updated (n dirty instances)", "scrolled n cascades",
        #: "unchanged center")
        self.last_build_ms: float | None = None
        self.last_build_label: str | None = None
        # list-raster overflow escalation: 1 -> 2x -> 4x list capacities
        # -> the ranged tier (any scale above 4)
        self._raster_caps_scale = 1

    # -- scene ----------------------------------------------------------------

    def load_stage(self, stage_or_path) -> None:
        stage = (stage_or_path if isinstance(stage_or_path, Stage)
                 else Stage.open(stage_or_path))
        self.delegate.populate(stage)
        self.sync()

    def save_cache(self, path: str) -> None:
        """Write the synced scene to a scene cache (``runtime/cache.py``)."""
        from vri_tpu_torch.runtime import cache

        cache.save_scene_cache(self.delegate.registry, path)

    def load_cache(self, path: str, camera=None) -> None:
        """Load a scene cache into the registry, without the USD stage,
        and commit it to the renderer's device; the cascades go stale.
        A cache holds no camera: pass ``camera`` or render with one."""
        from vri_tpu_torch.runtime import cache

        cache.load_scene_cache(self.delegate.registry, path)
        self.scene = self.delegate.registry.commit()
        self._sync_count += 1
        if camera is not None:
            self.delegate.camera = camera

    def sync(self, time_code: float | None = None) -> SceneBuffers:
        """Sync dirty prims (Hydra sync phase analog); ``time_code``
        first advances the stage's authored animation.  A sync that
        changed the scene makes the cascades stale."""
        dirty = self.delegate.tracker.any_dirty
        self.scene = self.delegate.sync(time_code=time_code)
        if dirty or self.delegate.registry.last_update["kind"] != "none":
            self._sync_count += 1
        return self.scene

    @property
    def camera(self) -> Optional[CameraState]:
        return self.delegate.camera

    # -- SDF cascades -----------------------------------------------------------

    def ensure_cascades(self, eye=None, focus=None, force: bool = False):
        """Bring the cascades up to date when geometry changed or the focus
        moved more than one coarse voxel, then bake the radiance.  A
        transforms-only edit of at most 32 instances runs the bounded
        ``sdf_build.update_cascades`` over the dirty cells; a moved focus
        on an unchanged scene runs ``sdf_build.scroll_cascades``, which
        keeps every surviving brick; anything else, or a capacity breach
        of either (``needs_full``), is a full build with list caps scaled
        to the measured demand.  A configuration the cell binning cannot
        hold (``sdf_build.supports``) takes the dense build, and without
        its build state every later change rebuilds."""
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

        t0 = time.perf_counter()
        # the SDF paths read the base geometry only (no LOD chains)
        scene_b = self.scene.base_view()
        world = bake_world(scene_b)
        done = None  # (cascades, state, label)
        if not force and self.cascades is not None \
                and self._build_state is not None:
            upd = self.delegate.registry.last_update
            if (stale and not moved and upd.get("kind") == "transforms"
                    and len(upd["dirty_instances"]) <= 32):
                done = self._try_incremental(scene_b, world, upd, cfg)
            elif moved and not stale:
                done = self._try_scroll(scene_b, world, focus, cfg)
        if done is None and not sdf_build.supports(cfg):
            done = (sdf_mod.build_for_scene(scene_b, world, focus=focus,
                                            config=cfg),
                    None, "rebuilt (dense)")
        if done is None:
            centers = sdf_mod.default_centers(cfg, focus, device=self.device)
            # demand pre-pass: scale the list caps so the build drops no
            # ref (sticky: the build state's list shapes derive from them)
            cfg2 = sdf_build.demand_caps(scene_b, world, centers, cfg)
            if cfg2 is not cfg:
                log.info("SDF list caps demand-scaled: cell %d -> %d, "
                         "global %d -> %d", cfg.cell_list_cap,
                         cfg2.cell_list_cap, cfg.global_list_cap,
                         cfg2.global_list_cap)
                cfg = cfg2
                self._sdf_cfg_effective = cfg
            done = (*sdf_build.build_for_scene(scene_b, world, centers, cfg),
                    "rebuilt")
        cascades, state, label = done
        if self.device.type == "cuda":
            # the card's kernels are built (or loaded) first, so that
            # ``sdf.bake`` times the bake alone
            with profiler.span("kernel_build"):
                _cuda.library()
        with profiler.span("sdf.bake"):
            self.cascades = sdf_mod.bake_brick_lighting(
                cascades, self.scene, config=cfg,
                alive=None if state is None else state.alive)
        self._build_state = state
        self._cascade_focus = focus
        self._scene_version = self._sync_count
        list_ov = 0 if state is None else int(state.list_overflow)
        self.last_build_ms = 1e3 * (time.perf_counter() - t0)
        self.last_build_label = label
        log.info("SDF cascades %s in %.1f ms (%d bricks, %d brick "
                 "overflow, %d list-ref drops)", label, self.last_build_ms,
                 int(self.cascades.num_bricks), int(self.cascades.overflow),
                 list_ov)
        if list_ov:
            log.warning("SDF cell/glob list capacity dropped %d refs",
                        list_ov)
        return self.cascades

    def _try_incremental(self, scene_b, world, upd, cfg):
        """Bounded update over the dirty instances' old and new boxes;
        None when a capacity overflowed."""
        ids = upd["dirty_instances"]
        dirty_inst = torch.zeros((scene_b.instance_transform.shape[0],),
                                 dtype=torch.bool, device=self.device)
        dirty_inst[ids] = True
        dirty_tri = dirty_inst[scene_b.tri_instance.long()]
        cap = 64
        dlo = np.full((cap, 3), 3.0e38, np.float32)
        dhi = np.full((cap, 3), -3.0e38, np.float32)
        n = len(ids)
        dlo[:n], dhi[:n] = upd["old_lo"], upd["old_hi"]
        dlo[n:2 * n], dhi[n:2 * n] = upd["new_lo"], upd["new_hi"]
        cascades, state, needs_full = sdf_build.update_for_scene(
            self.cascades, self._build_state, scene_b, world, dirty_tri,
            torch.as_tensor(dlo, device=self.device),
            torch.as_tensor(dhi, device=self.device), cfg)
        if int(needs_full):
            log.info("bounded SDF update overflowed; full rebuild")
            return None
        return cascades, state, f"updated ({n} dirty instances)"

    def _try_scroll(self, scene_b, world, focus, cfg):
        """Clipmap scroll to the focus's centers; None when a capacity
        overflowed."""
        new_centers = sdf_mod.default_centers(cfg, focus, device=self.device)
        delta = (new_centers - self.cascades.center).cpu().numpy()
        scrolled = tuple(bool(np.any(d != 0.0)) for d in delta)
        if not any(scrolled):
            return self.cascades, self._build_state, "unchanged center"
        cascades, state, needs_full = sdf_build.scroll_for_scene(
            self.cascades, self._build_state, scene_b, world, new_centers,
            scrolled, cfg)
        if int(needs_full):
            log.info("SDF scroll overflowed; full rebuild")
            return None
        return cascades, state, f"scrolled {sum(scrolled)} cascades"

    @property
    def list_overflow(self) -> int:
        """References the last SDF build dropped at list capacity."""
        return (0 if self._build_state is None
                else int(self._build_state.list_overflow))

    # -- frames -----------------------------------------------------------------

    @profiler.frame_root
    def render(self, camera: Optional[CameraState] = None,
               mode: int = DebugMode.NONE, gi: bool = True,
               samples: int = 1, backend: str = "raster",
               gi_scale: int = 1, to_numpy: bool = True,
               uniforms: torch.Tensor | None = None,
               time_code: float | None = None) -> Dict[str, np.ndarray]:
        """One frame: the GI frame, or with ``gi=False`` the direct-only
        frame (brute-force hard shadows, no SDF cascades); an SDF debug
        ``mode`` marches the cascades whatever ``gi`` says.  ``uniforms``
        (samples, GI pixels, 2) replaces the generator draws of the GI
        frame (parity tests hand in the reference's samples).
        ``time_code`` first syncs the stage's authored animation at that
        time; transform-only motion then takes the bounded SDF update.
        Each call is one ``frame`` root span (``runtime/profiler.py``)."""
        if self.scene is None:
            raise RuntimeError("load_stage() first")
        if time_code is not None:
            self.sync(time_code=time_code)
        cam = camera or self.camera
        if cam is None:
            raise RuntimeError("no camera")
        if backend == "raster" and self._raster_caps_scale > 1:
            backend = ("raster_ranged" if self._raster_caps_scale > 4
                       else f"raster{self._raster_caps_scale}x")
        h, w = self.config.height, self.config.width
        fp = frame_mod.FrameParams.from_camera(cam, h, device=self.device)
        if gi or mode >= DebugMode.SDF_DISTANCE:
            cascades = self.ensure_cascades(eye=cam.eye)
            gen = None
            if uniforms is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.frame_index)
            aovs = frame_mod.render_frame_gi(
                self.scene, fp, cascades, height=h, width=w,
                config=self.config.sdf, mode=mode,
                backend=backend, samples=samples, use_cache=True,
                gi_scale=gi_scale, lod_tau=self.config.lod_tau,
                generator=gen, uniforms=uniforms)
        else:
            aovs = frame_mod.render_frame(
                self.scene, fp, height=h, width=w, mode=mode, shadows=True,
                backend=backend, lod_tau=self.config.lod_tau)
        self.frame_index += 1
        over = aovs.get("raster_overflow_tiles")
        if over is not None and to_numpy and self._raster_caps_scale <= 4 \
                and int(over) > 0:
            self._raster_caps_scale *= 2
            nxt = ("the capacity-free ranged tier"
                   if self._raster_caps_scale > 4
                   else f"{self._raster_caps_scale}x list capacities")
            log.warning("list raster overflowed (%d; geometry may be "
                        "missing there); subsequent frames escalate to %s",
                        int(over), nxt)
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

    def render_flythrough(self, n_frames: int, free_cam: FreeCamera,
                          dt: float = 1.0 / 30.0, gi: bool = True,
                          backend: str = "raster", temporal: bool = False,
                          gi_scale: int = 1, samples: int = 1) -> list:
        """Frames along a scripted camera path (``free_cam.at_time(i *
        dt)``), as numpy AOV dicts.  ``temporal=True`` accumulates the GI
        through the reprojected history
        (``frame.render_frame_gi_temporal``), so reduced per-frame ray
        budgets (``gi_scale=2``, ``samples=1``) converge like a
        many-sample accumulation."""
        aspect = self.config.width / self.config.height
        h, w = self.config.height, self.config.width
        frames = []
        state = (frame_mod.init_temporal(h, w, gi_scale, device=self.device)
                 if temporal else None)
        for i in range(n_frames):
            cam = free_cam.at_time(i * dt, aspect)
            if not (temporal and gi):
                frames.append(self.render(camera=cam, gi=gi, backend=backend,
                                          gi_scale=gi_scale, samples=samples))
                continue
            cascades = self.ensure_cascades(eye=cam.eye)
            fp = frame_mod.FrameParams.from_camera(cam, h, device=self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.frame_index)
            self.frame_index += 1
            aovs, state = frame_mod.render_frame_gi_temporal(
                self.scene, fp, cascades, state, height=h, width=w,
                config=self.config.sdf, backend=backend, samples=samples,
                use_cache=True, gi_scale=gi_scale,
                lod_tau=self.config.lod_tau, generator=gen)
            frames.append({k: v.cpu().numpy() for k, v in aovs.items()})
        return frames
