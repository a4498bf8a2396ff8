"""The plain reference and the check at tiny sizes on the CPU: the
program agrees with the reference within the cells' limits, the control
(the reference in bfloat16) does not, and a run whose timed path is
broken underneath comes out not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import run as harness
from perfbench.reference import compare, visibility as vis_mod
from perfbench.stage_arrays import stage_arrays

CELLS = ["kitchen49k.gi_static", "kitchen49k.vis_resolve"]


def _limits(name):
    from perfbench.tests.conftest import TINY_LIMITS

    return TINY_LIMITS[name]


def test_stage_arrays_match_the_synced_scene():
    from vri_tpu_torch import RenderConfig, scenes
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.registry import bake_world

    for stage in (scenes.kitchen_stress(num_objects=5, tess=2),
                  scenes.city_stress(num_buildings=9, tess=2, num_protos=3)):
        a = stage_arrays(stage)
        d = RenderDelegate(RenderConfig(width=32, height=32), device="cpu")
        d.populate(stage)
        scene = d.sync()
        world = bake_world(scene)[scene.tri_vertices[:scene.num_faces]
                                  .long()].numpy()
        assert a["corners"].shape == world.shape
        np.testing.assert_allclose(np.sort(a["corners"].reshape(-1, 3), 0),
                                   np.sort(world.reshape(-1, 3), 0),
                                   atol=2e-5)
        assert np.isclose(a["eye"], d.camera.eye, atol=1e-6).all()


def test_ray_casting_of_one_triangle():
    arrays = {
        "corners": np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], float),
        "tri_instance": np.zeros(1, np.int32),
        "albedo": np.full((1, 3), 0.5, np.float32),
        "emissive": np.zeros((1, 3), np.float32),
        "double_sided": np.array([False]),
        "eye": np.array([0.0, 0.0, 3.0]), "target": np.zeros(3),
        "fov_deg": 60.0, "near": 0.05, "far": 100.0}
    out = vis_mod.visibility(arrays, 16, 16, "cpu")
    valid = out["valid"].reshape(16, 16)
    assert valid[8, 8] and not valid[0, 0]
    assert torch.allclose(out["depth"][valid.reshape(-1)].min(),
                          torch.tensor(3.0, dtype=torch.float64), atol=0.02)
    assert (out["normal"][valid.reshape(-1)][:, 2] == 1.0).all()
    # seen from behind, the single-sided triangle is culled
    arrays["eye"] = np.array([0.0, 0.0, -3.0])
    assert not vis_mod.visibility(arrays, 16, 16, "cpu")["valid"].any()
    arrays["double_sided"] = np.array([True])
    assert vis_mod.visibility(arrays, 16, 16, "cpu")["valid"].any()


def test_id_map_is_one_to_one():
    prog = torch.tensor([5, 5, 5, 2, 2, -1, 7])
    ref = torch.tensor([0, 0, 1, 1, 1, -1, 1])
    m = compare.id_map(prog, ref)
    assert m[5] == 0 and m[2] == 1 and m[7] == -2


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_its_check(tiny_bench, cell):
    result, check = harness.run(cell, 2 ** 31 + 11, 0.2, False,
                                device="cpu")
    assert result["correct"], check
    assert set(check) == set(_limits(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(tiny_bench, cell):
    from perfbench import control

    rows = control.readings(cell, [7], 1, 2, device="cpu")
    lim = _limits(cell)
    ctl = rows[0]["control"]
    assert any(v > lim[k] for k, v in ctl.items()), ctl
    assert all(v <= lim[k] for k, v in rows[0]["program"].items())


def _break(cell_name, fault, monkeypatch):
    """A cell hook that breaks the timed path underneath the harness."""
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch import renderer as renderer_mod

    if fault == "state_unchanged":
        real = frame_mod.render_frame_gi_temporal

        def stuck(scene, fp, cascades, state, **kw):
            aovs, _ = real(scene, fp, cascades, state, **kw)
            return aovs, state
        return lambda cell: monkeypatch.setattr(
            frame_mod, "render_frame_gi_temporal", stuck)

    def alter(aovs):
        aovs = dict(aovs)
        if fault == "half_left_out":
            h = aovs["instance_id"].shape[0]
            for k in ("instance_id", "depth", "color", "normal", "albedo"):
                v = aovs[k].clone()
                v[h // 2:] = -1 if k == "instance_id" else 0
                aovs[k] = v
        else:                                    # an answer altered
            aovs["color"] = aovs["color"] * 1.05
        return aovs

    if cell_name.endswith(".gi_static"):
        real_t = frame_mod.render_frame_gi_temporal

        def broken_t(*a, **kw):
            aovs, state = real_t(*a, **kw)
            return alter(aovs), state
        return lambda cell: monkeypatch.setattr(
            frame_mod, "render_frame_gi_temporal", broken_t)
    real_r = renderer_mod.Renderer.render

    def broken_r(self, *a, **kw):
        return alter(real_r(self, *a, **kw))
    return lambda cell: monkeypatch.setattr(renderer_mod.Renderer,
                                            "render", broken_r)


@pytest.mark.parametrize("cell,fault", [
    ("kitchen49k.gi_static", "state_unchanged"),
    ("kitchen49k.gi_static", "half_left_out"),
    ("kitchen49k.gi_static", "answer_altered"),
    ("kitchen49k.vis_resolve", "half_left_out"),
    ("kitchen49k.vis_resolve", "answer_altered"),
])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, cell,
                                            fault):
    result, check = harness.run(cell, 2 ** 31 + 13, 0.2, False,
                                device="cpu",
                                cell_hook=_break(cell, fault, monkeypatch))
    assert not result["correct"], check
