"""The cell ``kitchen49k.gi_anim`` at a tiny size on the CPU: the program
within its tiny limits, the control (the reference in bfloat16) past
them, a run whose SDF update or re-bake is skipped not correct, and the
cell's per-layer metrics in a ``--trace 1`` run.

The tiny copy is this file's own (``conftest.py``'s ``TINY`` holds the
static cell's): four props at 64x48 (the smallest then lies inside the
cascades), the SDF at two 16^3 cascades of 0.3 m voxels, and the moving
prop on the cell's own circle, 0.03 m.  The limits are the static cell's
tiny ones, and 0.01 on the three numbers of the region the update owns
(``sdf_near_*``).  Sound runs read 0 on all six cascade numbers; a stale
update reads about 0.04 on ``sdf_near_occ_off`` and a skipped re-bake
about 0.04 on ``sdf_near_shade_off``, where the whole cascades' numbers
stay inside their limits.
"""

from __future__ import annotations

import json

import pytest

from perfbench import run as harness

CELL = "kitchen49k.gi_anim"
CONFIG = "kitchen49k-anim-room-1080p"
TINY_CONFIG = {
    "stage": {"generator": "kitchen_anim",
              "args": {"num_objects": 4, "seed": 7, "tess": 2,
                       "radius": 0.03, "period": 9}},
    "width": 64, "height": 48,
    "sdf": {"num_cascades": 2, "cascade_resolution": 16,
            "base_voxel_size": 0.3, "truncation_voxels": 1.0,
            "max_bricks": 8192},
}
TINY_PARAMS = {"warmup_frames": 5, "uniform_sets": 2}
TINY_LIMITS = {
    "vis_off": 0.01, "gbuf_off": 0.01, "sdf_occ_off": 0.01,
    "sdf_surf_off": 0.01, "sdf_shade_off": 0.01, "sdf_near_occ_off": 0.01,
    "sdf_near_surf_off": 0.01, "sdf_near_shade_off": 0.01,
    "color_first": 0.012, "history_first": 0.004, "color": 0.006,
    "history": 0.001}
METRICS = ("scene_sync_ms", "sdf_update_ms", "rebake_ms", "update_bricks",
           "rebake_bricks")


@pytest.fixture
def tiny_anim(tiny_bench):
    bench = tiny_bench / "perfbench"
    path = bench / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    for key, value in TINY_CONFIG.items():
        if key == "sdf":
            cfg["sdf"].update(value)
        else:
            cfg[key] = value
    path.write_text(json.dumps(cfg))
    path = bench / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl["params"].update(TINY_PARAMS)
    wl["limits"] = TINY_LIMITS
    path.write_text(json.dumps(wl))
    return tiny_bench


def test_the_program_passes_its_check(tiny_anim):
    result, check = harness.run(CELL, 2 ** 31 + 11, 0.2, False,
                                device="cpu")
    assert result["correct"], check
    assert result["failed"] == 0
    assert set(check) == set(TINY_LIMITS)


def test_the_control_fails_the_check(tiny_anim):
    from perfbench import control

    row = control.readings(CELL, [7], 1, 2, device="cpu")[0]
    assert any(v > TINY_LIMITS[k] for k, v in row["control"].items()), row
    assert all(v <= TINY_LIMITS[k] for k, v in row["program"].items()), row


def _skip(fault, monkeypatch):
    """A cell hook that skips the SDF update (the frame renders the
    cascades of the frame before) or the re-bake of the animated frame
    underneath the renderer."""
    import torch

    from vri_tpu_torch.passes import frame as frame_mod

    real = frame_mod.render_frame_gi_dynamic

    def stale(scene, fp, cascades, build_state, state, dirty_tri,
              dirty_lo, dirty_hi, *, rebake, **kw):
        aovs, new_state = frame_mod.render_frame_gi_temporal(
            scene, fp, cascades, state, **kw)
        return (aovs, new_state, cascades, build_state,
                torch.zeros((), dtype=torch.int64))

    def no_rebake(*args, **kw):
        return real(*args, **{**kw, "rebake": False})

    fn = stale if fault == "update_skipped" else no_rebake
    return lambda cell: monkeypatch.setattr(
        frame_mod, "render_frame_gi_dynamic", fn)


@pytest.mark.parametrize("fault", ["update_skipped", "rebake_skipped"])
def test_a_skipped_update_is_not_correct(tiny_anim, monkeypatch, fault):
    result, check = harness.run(CELL, 2 ** 31 + 13, 0.2, False,
                                device="cpu",
                                cell_hook=_skip(fault, monkeypatch))
    assert not result["correct"], check
    # the whole cascades' numbers alone would not see it
    assert all(check[k][0] <= check[k][1] for k in check
               if k.startswith("sdf_") and "_near_" not in k), check


def test_the_layer_metrics_are_read_in_a_traced_run(tiny_anim):
    result, check = harness.run(CELL, 2 ** 31 + 17, 0.2, True,
                                device="cpu")
    got = result["metrics"]
    assert set(METRICS) <= set(got), got
    assert "sync_s" in got
    assert all(got[m]["value"] > 0 for m in METRICS), got
    assert got["update_bricks"]["unit"] == "bricks/frame"
    assert result["correct"], check
