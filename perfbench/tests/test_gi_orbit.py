"""The cell ``kitchen49k.gi_orbit`` at a tiny size on the CPU: the program
within its tiny limits, the control (the reference in bfloat16) past
them, a run whose scroll is skipped (the cascades left behind the camera)
or whose bake after the scroll is skipped not correct, and the cell's
per-layer metrics in a ``--trace 1`` run.

The tiny copy is this file's own (``conftest.py``'s ``TINY`` holds the
static cell's): six props at 64x48, the SDF at two 16^3 cascades of
0.3 m voxels, the cell's own orbit, and 16 warm-up frames of which the
last 8 are recorded, so the window's frames have scrolled both cascades.
The limits are the static cell's tiny ones, and 0.01 on the three numbers
of the region the scrolls own (``sdf_enter_*``).
"""

from __future__ import annotations

import json

import pytest

from perfbench import run as harness

CELL = "kitchen49k.gi_orbit"
CONFIG = "kitchen49k-orbit-room-1080p"
TINY_CONFIG = {
    "stage": {"generator": "kitchen_stress",
              "args": {"num_objects": 6, "seed": 7, "tess": 2}},
    "width": 64, "height": 48,
    "sdf": {"num_cascades": 2, "cascade_resolution": 16,
            "base_voxel_size": 0.3, "truncation_voxels": 1.0,
            "max_bricks": 8192},
}
TINY_PARAMS = {"warmup_frames": 16, "recorded_frames": 8,
               "uniform_sets": 2}
TINY_LIMITS = {
    "vis_off": 0.01, "gbuf_off": 0.01, "sdf_occ_off": 0.01,
    "sdf_surf_off": 0.01, "sdf_shade_off": 0.01, "sdf_enter_occ_off": 0.01,
    "sdf_enter_surf_off": 0.01, "sdf_enter_shade_off": 0.01,
    "color_first": 0.012, "history_first": 0.004, "color": 0.006,
    "history": 0.001}
METRICS = ("scroll_ms", "scroll_bake_ms", "scroll_cells", "scroll_bricks")


@pytest.fixture
def tiny_orbit(tiny_bench):
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


def test_the_program_passes_its_check(tiny_orbit):
    result, check = harness.run(CELL, 2 ** 31 + 11, 0.2, False,
                                device="cpu")
    assert result["correct"], check
    assert result["failed"] == 0
    assert set(check) == set(TINY_LIMITS)


def test_the_control_fails_the_check(tiny_orbit):
    from perfbench import control

    row = control.readings(CELL, [7], 1, 2, device="cpu")[0]
    assert any(v > TINY_LIMITS[k] for k, v in row["control"].items()), row
    assert all(v <= TINY_LIMITS[k] for k, v in row["program"].items()), row


def _skip(fault, monkeypatch):
    """A cell hook, run after the set-up, that leaves the cascades where
    they are (no scroll follows the camera) or skips the radiance bake
    after each scroll (the bricks it emitted keep what their slots held,
    the shading table stays where the window was), then warms the cell up
    again under the fault."""
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.renderer import Renderer

    def never_moved(self, focus, cfg):
        return self._centers is None

    def no_bake(cascades, scene, **kw):
        return cascades

    target, name, fn = ((Renderer, "_moved", never_moved)
                        if fault == "scroll_skipped"
                        else (sdf_mod, "bake_brick_lighting", no_bake))

    def hook(cell):
        monkeypatch.setattr(target, name, fn)
        cell.reseed(cell.seed)
    return hook


@pytest.mark.parametrize("fault", ["scroll_skipped", "rebake_skipped"])
def test_a_skipped_scroll_is_not_correct(tiny_orbit, monkeypatch, fault):
    result, check = harness.run(CELL, 2 ** 31 + 13, 0.2, False,
                                device="cpu",
                                cell_hook=_skip(fault, monkeypatch))
    assert not result["correct"], check


def test_the_layer_metrics_are_read_in_a_traced_run(tiny_orbit):
    result, check = harness.run(CELL, 2 ** 31 + 17, 0.2, True,
                                device="cpu")
    got = result["metrics"]
    assert set(METRICS) <= set(got), got
    assert "sync_s" in got
    assert all(got[m]["value"] > 0 for m in METRICS), got
    assert got["scroll_cells"]["unit"] == "cells/frame"
    assert result["correct"], check
