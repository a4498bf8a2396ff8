"""Frames with the framebuffer sharded in row bands over a mesh
(counterpart of ``vri_tpu/parallel/tiling.py``).

Every rank renders its own rows, [rank * band_h, (rank + 1) * band_h), end
to end through the single-device band path: camera rays, visibility
(``frame._visibility_raster(y0=, proj_height=)``: the raster projects
with the whole frame's height), G-buffer, direct light and GI.  The
scene, cascades, build state and camera arrive the same on every rank
(``mesh.replicate`` broadcasts them from one).  The AOVs come back as the
JAX functions lay them out: ``color``, ``depth`` and ``instance_id``
gathered to the whole frame on every rank, ``stats`` (rays, hits) summed
over the mesh, the temporal state row-sharded (each rank keeps its
band's history, ``frame.init_temporal(height // n, width, gi_scale)``).

GI samples come from ``uniforms`` for the rank's own band, or from a
generator seeded from (``seed``, rank) (``mesh.band_generator``, the
counterpart of ``fold_in(key, dev)``).  A rank's band offset is a Python
int, so the raster's ``y_offset`` stays a host number.
"""

from __future__ import annotations

from typing import Dict

import torch

from vri_tpu_torch.ops import gi as gi_mod
from vri_tpu_torch.ops import intersect, raygen, shading
from vri_tpu_torch.ops.geometry import norm3
from vri_tpu_torch.parallel import halo as halo_mod
from vri_tpu_torch.parallel.mesh import (Mesh, MeshAxis, all_gather,
                                         band_generator, psum)
from vri_tpu_torch.passes import frame as frame_mod
from vri_tpu_torch.passes.frame import FrameParams, TemporalState
from vri_tpu_torch.registry import SceneBuffers, bake_world


def _band_rays(frame: FrameParams, height: int, width: int, band_h: int,
               y0: int):
    """Rays of rows [y0, y0 + band_h) of a ``height``-row frame.  As the
    JAX function's, every ray starts at the eye, also under an
    orthographic camera (``raygen.camera_rays`` starts those on the near
    plane)."""
    _, d = raygen.camera_rays(frame.inv_view_proj, frame.eye, band_h, width,
                              y0=y0, proj_height=height)
    o = frame.eye.expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _band(axis: MeshAxis, height: int, gi_scale: int = 1):
    """(band height, this rank's first row); ``ValueError`` where the
    JAX functions assert."""
    n = axis.size
    if height % n:
        raise ValueError(f"height {height} % devices {n} != 0")
    band_h = height // n
    if band_h % gi_scale:
        raise ValueError(f"band height {band_h} % gi_scale {gi_scale} != 0")
    return band_h, axis.index * band_h


def _sampler(axis: MeshAxis, seed: int, uniforms, device):
    """(generator, uniforms) of this rank's band."""
    if uniforms is not None:
        return None, uniforms
    return band_generator(seed, axis.index, device), None


def _stats(rays: int, valid, axis: MeshAxis):
    hits = valid.sum().to(torch.float32)
    return psum(torch.stack([torch.tensor(float(rays), device=hits.device),
                             hits]), axis)


def render_band_static(scene: SceneBuffers, frame: FrameParams, cascades,
                       axis: MeshAxis, *, height: int, width: int, config,
                       gi: bool, samples: int, backend: str,
                       use_cache: bool, seed: int, uniforms,
                       world_depth: bool) -> Dict[str, torch.Tensor]:
    """The static sharded frame's per-rank body, shared by the 1-D and the
    2-D mesh: the band's AOVs gathered over ``axis`` (the whole mesh).
    ``world_depth`` says whether raster depth becomes the world ray
    distance (the 1-D frame: every raster backend; the 2-D frame:
    ``backend == "raster"`` only, as ``vri_tpu/parallel/multihost.py:
    187``)."""
    band_h, y0 = _band(axis, height)
    o, d = _band_rays(frame, height, width, band_h, y0)
    world = bake_world(scene)
    if backend.startswith("raster"):
        variant, caps_scale = frame_mod._raster_variant(backend)
        hit = frame_mod._visibility_raster(
            scene, world, frame, band_h, width, variant=variant,
            caps_scale=caps_scale, y0=y0, proj_height=height)
    else:
        hit = frame_mod._visibility_brute(scene, world, o, d)
    gb = shading.resolve_gbuffer(scene, world, hit, o, d)
    if world_depth:
        t = norm3(gb.position - frame.eye[None, :])
        gb = gb.replace(depth=torch.where(gb.valid, t, intersect.INF))
    if gi:
        gen, uni = _sampler(axis, seed, uniforms, o.device)
        color = gi_mod.lightloop(gb, scene, cascades, config=config,
                                 samples=samples, generator=gen,
                                 uniforms=uni, use_cache=use_cache)
    else:
        color = shading.shade_direct(gb, scene)
    return {"color": all_gather(color.reshape(band_h, width, 3), axis),
            "depth": all_gather(gb.depth.reshape(band_h, width), axis),
            "instance_id": all_gather(gb.instance.reshape(band_h, width),
                                      axis),
            "stats": _stats(o.shape[0], gb.valid, axis)}


def render_frame_tiled(scene: SceneBuffers, frame: FrameParams, cascades, *,
                       mesh: Mesh, height: int, width: int, config,
                       gi: bool = True, samples: int = 1,
                       backend: str = "raster", use_cache: bool = True,
                       seed: int = 0, uniforms: torch.Tensor | None = None
                       ) -> Dict[str, torch.Tensor]:
    """One GI frame (``gi=False``: direct light only) with the rows sharded
    over the 1-D ``mesh``: the production raster tier on each band
    (``backend="brute"``: the exact tracer), the G-buffer, and the SDF
    lightloop.  ``uniforms`` (samples, band pixels, 2) are the rank's own.
    Returns ``color``, ``depth`` (world ray distance for raster backends),
    ``instance_id`` and ``stats``."""
    return render_band_static(
        scene, frame, cascades, mesh.axis(), height=height, width=width,
        config=config, gi=gi, samples=samples, backend=backend,
        use_cache=use_cache, seed=seed, uniforms=uniforms,
        world_depth=backend.startswith("raster"))


def _temporal_band(scene, frame, cascades, state: TemporalState,
                   axis: MeshAxis, *, height, width, config, samples,
                   backend, use_cache, gi_scale, history_cap, halo_rows,
                   seed, uniforms):
    """The temporal band body: ``frame.gi_band_inputs`` on the rank's
    band, the history band extended by ``halo_rows`` ghost rows from the
    ring neighbours (fill 0 beyond the frame: count 0, which the taps
    reject), then ``frame.temporal_history(halo=)``: the reprojection
    (taps in the band's coordinates, read through the ghost rows), the
    blend and the compose.  Returns (aovs, new state, the band's valid
    pixels)."""
    s = gi_scale
    band_h, y0 = _band(axis, height, s)
    if width % s:
        raise ValueError(f"width {width} % gi_scale {s} != 0")
    hs, ws, h = band_h // s, width // s, halo_rows
    gen, uni = _sampler(axis, seed, uniforms, frame.eye.device)
    _, gb, direct, sub, valid_s, ind = frame_mod.gi_band_inputs(
        scene, frame, cascades, height=band_h, width=width, config=config,
        backend=backend, samples=samples, use_cache=use_cache, gi_scale=s,
        y0=y0, proj_height=height, generator=gen, uniforms=uni)
    ext = halo_mod.exchange_halo_fill(state.data.reshape(hs, ws * 8), h,
                                      axis, 0.0).reshape((hs + 2 * h) * ws, 8)
    color, count_full, data = frame_mod.temporal_history(
        ext, state.view_proj, state.eye, sub.position, sub.normal, valid_s,
        ind, gb.depth, frame.eye, gb.emissive, gb.albedo, direct, gb.valid,
        height=band_h, width=width, gi_scale=s, history_cap=history_cap,
        y0=axis.index * hs, proj_height=height // s, halo=h)
    new_state = TemporalState(data=data, view_proj=frame.view_proj,
                              eye=frame.eye)
    aovs = {"color": all_gather(color.reshape(band_h, width, 3), axis),
            "depth": all_gather(gb.depth.reshape(band_h, width), axis),
            "instance_id": all_gather(gb.instance.reshape(band_h, width),
                                      axis),
            "gi_history": all_gather(count_full.reshape(band_h, width),
                                     axis)}
    return aovs, new_state, gb.valid


def render_frame_tiled_temporal(scene: SceneBuffers, frame: FrameParams,
                                cascades, state: TemporalState, *,
                                mesh: Mesh, height: int, width: int, config,
                                samples: int = 1, backend: str = "raster",
                                use_cache: bool = True, gi_scale: int = 1,
                                history_cap: float = 16.0,
                                halo_rows: int = 2, seed: int = 0,
                                uniforms: torch.Tensor | None = None):
    """The row-sharded production GI frame with its temporally reprojected
    history and a cross-band history halo: each rank's GI-resolution
    history band is extended by ``halo_rows`` ghost rows from its
    neighbours before the reprojection, so a reprojection that crosses a
    band border by up to ``halo_rows`` GI rows blends as the single-device
    frame does.  ``state`` is the rank's band of the history; returns
    (aovs, new state), the aovs ``color``, ``depth``, ``instance_id``,
    ``gi_history`` (each pixel's frame count) and ``stats``."""
    ax = mesh.axis()
    aovs, new_state, valid = _temporal_band(
        scene, frame, cascades, state, ax, height=height, width=width,
        config=config, samples=samples, backend=backend,
        use_cache=use_cache, gi_scale=gi_scale, history_cap=history_cap,
        halo_rows=halo_rows, seed=seed, uniforms=uniforms)
    aovs["stats"] = _stats(valid.shape[0], valid, ax)
    return aovs, new_state


def render_frame_tiled_dynamic(scene: SceneBuffers, frame: FrameParams,
                               cascades, build_state, state: TemporalState,
                               dirty_tri, dirty_lo, dirty_hi, *, mesh: Mesh,
                               height: int, width: int, config,
                               samples: int = 1, backend: str = "raster",
                               use_cache: bool = True, gi_scale: int = 1,
                               history_cap: float = 16.0, halo_rows: int = 2,
                               seed: int = 0,
                               uniforms: torch.Tensor | None = None):
    """One animated row-sharded frame: the bounded SDF update with its
    re-emit split over the mesh, the radiance re-bake split likewise (each
    merged with one all_gather, so the cascades come out the same on
    every rank and equal to the unsharded update's), then the temporal
    band frame.  Arguments as ``frame.render_frame_gi_dynamic``'s; returns
    (aovs, new temporal state, cascades, build state, needs_full)."""
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build

    ax = mesh.axis()
    shard = (ax, ax.size)
    world = bake_world(scene)
    mat = scene.instance_material[scene.tri_instance.long()].long()
    cascades, build_state, needs_full = sdf_build.update_cascades(
        cascades, build_state, world, scene.tri_vertices, scene.num_faces,
        dirty_tri, dirty_lo, dirty_hi, tri_albedo=scene.mat_base_color[mat],
        tri_emissive=scene.mat_emissive[mat], config=config,
        axis_name=shard)
    light_dirty = sdf_mod.lighting_dirty_bricks(
        cascades, scene, dirty_lo, dirty_hi, config=config)
    cascades, bake_drop = sdf_mod.bake_brick_lighting_partial(
        cascades, scene, build_state.emit_bricks | light_dirty,
        build_state.alive, config=config, cap=config.bake_brick_cap,
        axis_name=shard)
    needs_full = needs_full + bake_drop
    aovs, new_state, _ = _temporal_band(
        scene, frame, cascades, state, ax, height=height, width=width,
        config=config, samples=samples, backend=backend,
        use_cache=use_cache, gi_scale=gi_scale, history_cap=history_cap,
        halo_rows=halo_rows, seed=seed, uniforms=uniforms)
    return aovs, new_state, cascades, build_state, needs_full
