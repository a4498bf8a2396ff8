"""The moving camera on the production path: ``Renderer.render_temporal(
state, camera=...)`` along an orbit of a small kitchen, the clipmap
scroll recentering each cascade on the camera a cell at a time, and the
radiance baked again after the scroll.

The stage is ``kitchen_stress(8, tess=1)`` under the room preset cut to
three cascades of 32^3 voxels from 0.1 m (cells of 0.2, 0.4 and 0.6 m);
the camera is the benchmark orbit's (``FreeCamera`` around (0, 0.6, 0),
radius 3.2 m, the eye at 2.4 m), stepping 0.1 m a frame, so the frames
scroll cascade 0 and cascade 1 and some scroll one cascade only.  Held,
frame by frame:

* each cascade's center equals ``sdf.default_centers`` of the frame's
  focus after every frame, no frame after the first is "rebuilt", no
  scroll falls back to a build (``sdf_scroll.rebuilds``), and a camera
  alone never bumps the scene version;
* after a scroll the lighting equals a full bake of the scrolled
  cascades, ``torch.equal`` in ``brick_irradiance``, ``brick_light_vis``
  and ``voxel_shade``, and the frame's ``sdf.bake`` span follows its
  ``sdf_scroll`` span (no brick keeps the radiance of the slot it was
  emitted into);
* a frame whose camera moved no cascade's snapped center does no SDF
  work.

At the end the cascades are voxel-equal to a fresh build at the last
centers with ``tests/test_torch_sdf_update.py::
test_scroll_matches_port_fresh_build``'s tolerances: occupancy and
empty-space distance equal, the atlas within one u8 step (surviving
bricks keep content emitted at an older origin), and each cell list
nesting in the fresh build's or holding it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes at once
torch.set_num_threads(2)

from vri_tpu_torch import RenderConfig, SDFConfig, scenes  # noqa: E402
from vri_tpu_torch.hydra.camera import FreeCamera  # noqa: E402
from vri_tpu_torch.ops import sdf as sdf_mod  # noqa: E402
from vri_tpu_torch.ops import sdf_build  # noqa: E402
from vri_tpu_torch.passes import frame as frame_mod  # noqa: E402
from vri_tpu_torch.registry import bake_world  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402
from vri_tpu_torch.runtime import profiler  # noqa: E402

H, W, GI = 48, 64, 2
FRAMES = 7
SDF = dict(num_cascades=3, cascade_resolution=32, base_voxel_size=0.1,
           truncation_voxels=2.0, max_bricks=32768)
#: the benchmark orbit (perfbench/traffic/gi_orbit.py) with 200 frames a
#: turn: 0.1 m a frame
ORBIT = dict(center=(0.0, 0.6, 0.0), radius=3.2, height=1.8, fov_y_deg=55.0,
             far=200.0)
PER_TURN = 200
LIGHTING = ("brick_irradiance", "brick_light_vis", "voxel_shade")


def _camera(n):
    # FreeCamera's azimuth is 2 pi t / 8: t = 1 starts at pi / 4, the
    # authored camera's
    return FreeCamera(**ORBIT).at_time(1.0 + 8.0 * n / PER_TURN, W / H)


def _renderer():
    sdf = dataclasses.replace(SDFConfig.preset("room"), **SDF)
    r = Renderer(RenderConfig(width=W, height=H, sdf=sdf), device="cpu")
    r.load_stage(scenes.kitchen_stress(num_objects=8, seed=7, tess=1))
    return r


def _uniforms(seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((1, (H // GI) * (W // GI), 2), generator=gen)


@pytest.fixture(scope="module")
def orbit():
    """The orbit's frames: per frame the label, the renderer's centers
    and those of its focus, the scene versions around it, its counts and
    spans in order, and whether the lighting equals a full bake of the
    frame's cascades; then the renderer."""
    r = _renderer()
    state = frame_mod.init_temporal(H, W, GI, device="cpu")
    frames = []
    for n in range(FRAMES):
        version = r._sync_count
        profiler.start_recording()
        try:
            aovs, state = r.render_temporal(state, camera=_camera(n),
                                            uniforms=_uniforms(n),
                                            samples=1, gi_scale=GI)
        finally:
            spans = profiler.stop_recording()
        counts = {}
        for c in profiler.recorded_counts():
            counts[c.name] = counts.get(c.name, 0) + c.value
        cfg = r._sdf_cfg_effective or r.config.sdf
        full = sdf_mod.bake_brick_lighting(r.cascades, r.scene, config=cfg,
                                           alive=r._build_state.alive)
        frames.append(dict(
            label=r.last_build_label, counts=counts,
            spans=[sp.name for sp in spans],
            versions=(version, r._sync_count),
            center=r.cascades.center.clone(),
            want=sdf_mod.default_centers(cfg, r._focus(_camera(n).eye),
                                         device="cpu"),
            equal={f: bool(torch.equal(getattr(r.cascades, f),
                                       getattr(full, f)))
                   for f in LIGHTING},
            faults=int(aovs["frame_faults"]),
            finite=bool(torch.isfinite(aovs["color"]).all())))
    return frames, r


def test_centers_follow_the_camera_a_cell_at_a_time(orbit):
    frames, _ = orbit
    for n, f in enumerate(frames):
        assert torch.equal(f["center"], f["want"]), n
    # cascade 0 and cascade 1 each scrolled along the way
    moved = torch.stack([(b["center"] != a["center"]).any(-1)
                         for a, b in zip(frames, frames[1:])])
    print(f"cascades scrolled a frame: {moved.int().tolist()}")
    assert bool(moved[:, 0].any()) and bool(moved[:, 1].any())


def test_no_frame_after_the_first_rebuilds(orbit):
    frames, r = orbit
    assert frames[0]["label"] == "rebuilt"
    for n, f in enumerate(frames[1:], 1):
        assert not f["label"].startswith("rebuilt"), (n, f["label"])
        assert f["counts"].get("sdf_scroll.rebuilds", 0) == 0, n
        assert f["faults"] == 0 and f["finite"], n
    assert r.list_overflow == 0


def test_a_camera_never_bumps_the_scene_version(orbit):
    frames, r = orbit
    assert all(a == b for a, b in (f["versions"] for f in frames[1:]))
    assert r._scene_version == r._sync_count


@pytest.mark.parametrize("field", LIGHTING)
def test_scroll_rebake_equals_a_full_bake(orbit, field):
    frames, _ = orbit
    scrolled = [f for f in frames[1:] if "sdf_scroll.cells" in f["counts"]]
    assert scrolled
    for f in scrolled:
        assert f["equal"][field], f["counts"]
        names = f["spans"]
        assert "sdf.bake" in names[names.index("sdf_scroll"):], names


def test_a_still_camera_does_no_sdf_work(orbit):
    _, r = orbit
    cascades = r.cascades
    state = frame_mod.init_temporal(H, W, GI, device="cpu")
    profiler.start_recording()
    try:
        r.render_temporal(state, camera=_camera(FRAMES - 1),
                          uniforms=_uniforms(0), samples=1, gi_scale=GI)
    finally:
        spans = profiler.stop_recording()
    assert r.cascades is cascades
    names = {s.name for s in spans}
    assert not names & {"sdf_scroll", "scroll_bake", "sdf.bake"}, names
    assert not [c for c in profiler.recorded_counts()
                if c.name.startswith("sdf_scroll")]


def test_scrolled_cascades_equal_a_fresh_build(orbit):
    _, r = orbit
    cfg = r._sdf_cfg_effective or r.config.sdf
    scene = r.scene.base_view()
    ref, ref_st = sdf_build.build_for_scene(scene, bake_world(scene),
                                            r.cascades.center, cfg)
    assert int(ref_st.list_overflow) == 0
    a, b = r.cascades, ref
    ma, mb = a.brick_map.reshape(-1), b.brick_map.reshape(-1)
    occ = ma >= 0
    assert torch.equal(occ, mb >= 0)
    assert torch.equal(torch.where(occ, 0, ma), torch.where(occ, 0, mb))
    ia, ib = ma[occ].long(), mb[occ].long()
    step = (a.atlas[ia].float() - b.atlas[ib].float()).abs().max()
    assert a.atlas.dtype == torch.uint8 and float(step) <= 1.0
    at, bt = r._build_state.cell_tris, ref_st.cell_tris
    differ = 0
    for n, cell in (at != bt).any(-1).nonzero().tolist():
        sa = set(at[n, cell][at[n, cell] >= 0].tolist())
        sb = set(bt[n, cell][bt[n, cell] >= 0].tolist())
        differ += 1
        assert sa <= sb or sb <= sa, (n, cell)
    print(f"{differ} cell lists differ from the fresh build's, each "
          "nesting")
