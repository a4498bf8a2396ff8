"""The port's production animated frame, ``Renderer.render_temporal``, on
a small animated kitchen (``scenes.kitchen_anim``), and ``profiler.count``.

* Three time codes through the renderer against the plain reference of
  ``perfbench/reference/`` (no ``vri_tpu_torch`` there; the stage read at
  each code by ``reference/timesamples.py``): visibility, the cascades the
  frame read against the reference's from-scratch build at that code
  (whole, and over the voxels near the moved prop that the update owns),
  the colour and the history, within the limits of the animated cell's
  tiny copy (``perfbench/tests/test_gi_anim.py``), the prop on the
  cell's own 0.03 m circle.
* The renderer's animated frame bit-equal to
  ``frame.render_frame_gi_dynamic`` driven by hand with the moved
  instance's triangles and its old and new boxes, and its frame with
  nothing changed bit-equal to ``frame.render_frame_gi_temporal``.
* A capacity breach of the update (``update_cell_cap`` 8) rebuilds the
  cascades and reads non-zero in the frame's ``frame_faults``.
* ``kitchen_anim`` authors the same motion in two processes with
  different ``PYTHONHASHSEED``, on the circle it names.
* ``profiler.count`` reads nothing while no recording runs, and under a
  recording resolves device scalars with their frame id.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vri_tpu_torch import RenderConfig, SDFConfig, scenes  # noqa: E402
from vri_tpu_torch.passes import frame as frame_mod  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402
from vri_tpu_torch.runtime import profiler  # noqa: E402

H, W, GI = 48, 64, 2
STAGE = dict(num_objects=4, seed=7, tess=2, radius=0.03, period=9)
SDF = dict(num_cascades=2, cascade_resolution=16, base_voxel_size=0.3,
           truncation_voxels=1.0, max_bricks=8192)
FRAME = dict(samples=1, gi_scale=GI, history_cap=16.0, backend="raster")
#: the animated cell's tiny limits (perfbench/tests/test_gi_anim.py)
LIMITS = {"vis_off": 0.01, "gbuf_off": 0.01, "sdf_occ_off": 0.01,
          "sdf_surf_off": 0.01, "sdf_shade_off": 0.01,
          "sdf_near_occ_off": 0.01, "sdf_near_surf_off": 0.01,
          "sdf_near_shade_off": 0.01, "color": 0.012, "history": 0.004}


def _renderer(**sdf_over):
    sdf = dataclasses.replace(SDFConfig.preset("room"), **{**SDF,
                                                          **sdf_over})
    r = Renderer(RenderConfig(width=W, height=H, sdf=sdf), device="cpu")
    r.load_stage(scenes.kitchen_anim(**STAGE))
    r.ensure_cascades()
    return r


def _uniforms(seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((1, (H // GI) * (W // GI), 2), generator=gen)


def _equal(a, b):
    return a.shape == b.shape and bool(torch.equal(a, b))


def test_renderer_frames_match_the_reference():
    from perfbench import roofline_emit
    from perfbench.reference import compare, lightloop, sdf as ref_sdf
    from perfbench.reference.timesamples import at_time
    from perfbench.reference.visibility import visibility
    from perfbench.stage_arrays import stage_arrays

    r = _renderer()
    with open(os.path.join(os.path.dirname(__file__), "..", "perfbench",
                           "configs", "kitchen49k-anim-room-1080p.json")) as f:
        cfg = json.load(f)
    cfg.update(width=W, height=H)
    cfg["sdf"].update(SDF)
    stage = r.delegate.stage
    state = frame_mod.init_temporal(H, W, GI, device="cpu")
    for code in (1.0, 2.0, 3.0):
        u = _uniforms(int(code))
        prev = state
        profiler.start_recording()
        try:
            aovs, state = r.render_temporal(state, time_code=code,
                                            uniforms=u, **FRAME)
        finally:
            profiler.stop_recording()
            counts = {c.name: c.value for c in profiler.recorded_counts()}
        # the moved prop lies in the cascades: bricks were re-emitted and
        # re-baked
        assert counts["sdf_update.bricks"] > 0, counts
        assert counts["rebake.bricks"] > 0, counts
        assert counts["sdf_update.needs_full"] == 0, counts
        assert r.last_build_label == "updated (1 dirty instances)"
        assert int(aovs["frame_faults"]) == 0
        arrays = stage_arrays(at_time(stage, code))
        vis = visibility(arrays, W, H, "cpu")
        cas = ref_sdf.build(arrays, cfg["sdf"], vis["eye"], "cpu")
        ref = lightloop.temporal_frame(
            vis, cas, arrays, cfg, u,
            (prev.data, prev.view_proj, prev.eye))
        got = {}
        got["vis_off"], agree = compare.visibility_off(
            aovs["instance_id"], aovs["depth"], vis)
        got["gbuf_off"] = compare.attributes_off(
            aovs, vis, agree, (("albedo", "albedo"), ("normal", "normal")))
        c = r.cascades
        mine = {"occ": c.brick_map >= 0,
                "surf": ref_sdf.unpack_surface(
                    c.march_fine0, c.march_fine1, SDF["num_cascades"],
                    SDF["cascade_resolution"]),
                "voxel_shade": c.voxel_shade}
        got.update(ref_sdf.compare_cascades(mine, cas))
        # again over the voxels the update owns, near the prop's bounds at
        # this code and the one before
        near = roofline_emit.near_voxels(cas, roofline_emit.moved_boxes(
            stage_arrays(at_time(stage, code - 1)), arrays), cfg["sdf"])
        assert int((cas["occ"] & near).sum()) > 0

        def owned(x):
            return {**x, "occ": x["occ"] & near, "surf": x["surf"] & near}

        got.update({k.replace("sdf_", "sdf_near_"): v for k, v in
                    ref_sdf.compare_cascades(owned(mine), owned(cas)).items()})
        got["color"] = compare.relative_l1(aovs["color"].reshape(-1, 3),
                                           ref["color"], vis["valid"])
        got["history"] = compare.relative_l1(state.data, ref["state"])
        assert all(got[k] <= LIMITS[k] for k in LIMITS), (code, got)


def test_renderer_frame_is_the_dynamic_frame_by_hand():
    r = _renderer()
    cascades, build = r.cascades, r._build_state
    state = frame_mod.init_temporal(H, W, GI, device="cpu")
    u = _uniforms(5)
    aovs, new_state = r.render_temporal(state, time_code=1.0, uniforms=u,
                                        **FRAME)
    upd = r.delegate.registry.last_update
    ids = upd["dirty_instances"]
    assert upd["kind"] == "transforms" and len(ids) == 1
    scene = r.scene
    dirty_tri = torch.isin(scene.tri_instance.long(), torch.tensor(ids))
    lo = torch.as_tensor(np.concatenate([upd["old_lo"], upd["new_lo"]]))
    hi = torch.as_tensor(np.concatenate([upd["old_hi"], upd["new_hi"]]))
    fp = frame_mod.FrameParams.from_camera(r.camera, H, device="cpu")
    cfg = r._sdf_cfg_effective or r.config.sdf
    want, want_state, want_cas, want_build, needs_full = \
        frame_mod.render_frame_gi_dynamic(
            scene, fp, cascades, build, state, dirty_tri, lo, hi,
            height=H, width=W, config=cfg, use_cache=True,
            lod_tau=r.config.lod_tau, uniforms=u, rebake=True, **FRAME)
    assert int(needs_full) == 0
    for k, v in want.items():
        assert _equal(aovs[k], v), k
    assert _equal(new_state.data, want_state.data)
    for f in dataclasses.fields(want_cas):
        a, b = getattr(r.cascades, f.name), getattr(want_cas, f.name)
        if torch.is_tensor(b):
            assert _equal(a, b), f.name
    assert _equal(r._build_state.alive, want_build.alive)
    assert _equal(r._build_state.cell_tris, want_build.cell_tris)

    # nothing changed: the temporal frame on the cascades as they are
    u2 = _uniforms(6)
    aovs2, state2 = r.render_temporal(new_state, uniforms=u2, **FRAME)
    want2, want_state2 = frame_mod.render_frame_gi_temporal(
        r.scene, fp, r.cascades, new_state, height=H, width=W,
        config=r.config.sdf, use_cache=True, lod_tau=r.config.lod_tau,
        uniforms=u2, **FRAME)
    for k, v in want2.items():
        assert _equal(aovs2[k], v), k
    assert _equal(state2.data, want_state2.data)
    assert int(aovs2["frame_faults"]) == 0


def test_a_cap_breach_rebuilds_and_reads_as_a_fault():
    r = _renderer(update_cell_cap=8)
    state = frame_mod.init_temporal(H, W, GI, device="cpu")
    aovs, state = r.render_temporal(state, time_code=1.0,
                                    uniforms=_uniforms(1), **FRAME)
    assert int(aovs["frame_faults"]) > 0
    assert r.last_build_label == "rebuilt"
    assert r._scene_version == r._sync_count
    # the rebuilt cascades are the full build's at the same time code
    full = _renderer()
    full.sync(time_code=1.0)
    full.ensure_cascades(force=True)
    assert _equal(r.cascades.brick_map >= 0, full.cascades.brick_map >= 0)


_MOTION = ("import json; from vri_tpu_torch.usd import scenes\n"
           "st = scenes.kitchen_anim(num_objects=12, tess=1)\n"
           "out = {}\n"
           "for p in st.traverse():\n"
           "    a = p.attributes.get('xformOp:translate')\n"
           "    if a is not None and a.metadata.get('timeSamples'):\n"
           "        out[p.path] = [a.value.tolist()] + [\n"
           "            a.metadata['timeSamples'][k].tolist()\n"
           "            for k in sorted(a.metadata['timeSamples'])]\n"
           "print(json.dumps(out))\n")


def test_the_motion_is_the_same_in_every_process_and_on_its_circle():
    root = os.path.join(os.path.dirname(__file__), "..")
    runs = []
    for hs in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hs, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", _MOTION], env=env,
                             cwd=root, capture_output=True, text=True,
                             check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert runs[0] == runs[1]
    (path, values), = runs[0].items()
    base, samples = np.asarray(values[0]), np.asarray(values[1:])
    assert len(samples) == 10
    np.testing.assert_array_equal(samples[0], samples[9])
    for k, t in enumerate(samples):
        ang = 2.0 * np.pi * (k % 9) / 9
        np.testing.assert_allclose(
            t, base + 0.03 * np.array([np.cos(ang), 0.0, np.sin(ang)]),
            atol=1e-6)
    # the smallest prop by the largest side of its world AABB
    st = scenes.kitchen_anim(num_objects=12, tess=1)

    def side(p):
        pts = np.asarray(p.get("points"), np.float64)
        m = st.world_transform(p).astype(np.float64)
        w = pts @ m[:3, :3].T + m[:3, 3]
        return float((w.max(0) - w.min(0)).max())

    props = [p for p in st.prims_of_type("Mesh") if "/Props/" in p.path]
    assert path == min(props, key=lambda p: (side(p), p.path)).path


class _Untouchable:
    """A stand-in for a device scalar that fails on any read."""

    def __getattr__(self, name):
        raise AssertionError(f"read {name} while nothing records")


def test_count_is_free_when_off_and_resolved_with_its_frame():
    assert profiler._rec is None
    profiler.count("x", _Untouchable())         # nothing reads it

    @profiler.frame_root
    def frame(i):
        profiler.count("dev", torch.tensor(i + 0.5))
        profiler.count("host", 2 * i)
        with profiler.span("inner"):
            profiler.count("dev", torch.tensor(i, dtype=torch.int64))

    profiler.start_recording()
    try:
        profiler.count("outside", torch.tensor(7))
        for i in range(3):
            frame(i)
    finally:
        recs = profiler.stop_recording()
    got = [(c.name, c.frame, c.value) for c in profiler.recorded_counts()]
    assert got[0] == ("outside", -1, 7.0)
    assert got[1:] == [x for i in range(3) for x in (
        ("dev", i, i + 0.5), ("host", i, 2.0 * i), ("dev", i, float(i)))]
    assert [r.frame for r in recs if r.name == "frame"] == [0, 1, 2]
    profiler.count("x", _Untouchable())         # off again
