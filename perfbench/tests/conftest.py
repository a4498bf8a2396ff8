"""Tiny copies of the benchmark's cells for CPU tests.

``tiny_bench`` writes a copy of the benchmark's data (BENCHMARK.json, the
configurations, cells, traffic modules and metric readers) into a
temporary directory, with each configuration cut to a few props at a few
dozen pixels and the SDF to two 16^3 cascades, adds a cell of the
``vis_resolve`` traffic on the kitchen, and points the harness at it.  The tiny cells have limits of their own, set as the
cells' are, from readings at this size (sound runs on the CPU read at
most a third of each; the control reads more than three times it, but
for the occupancy and surface voxels, which the tiny cascades' 0.3 m
voxels hide from a bfloat16 rounding).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import run as harness

# a few threads a test process, so that parallel workers do not
# oversubscribe the host's cores
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "kitchen49k-room-1080p": {
        "stage": {"generator": "kitchen_stress",
                  "args": {"num_objects": 6, "seed": 7, "tess": 2}},
        "width": 64, "height": 48,
        "sdf": {"num_cascades": 2, "cascade_resolution": 16,
                "base_voxel_size": 0.3, "truncation_voxels": 1.0,
                "max_bricks": 8192},
    },
}
TINY_LIMITS = {
    "kitchen49k.gi_static": {
        "vis_off": 0.01, "gbuf_off": 0.01, "sdf_occ_off": 0.01,
        "sdf_surf_off": 0.01, "sdf_shade_off": 0.01, "color_first": 0.012,
        "history_first": 0.004, "color": 0.006, "history": 0.001},
    "kitchen49k.vis_resolve": {"vis_off": 0.01, "gbuf_off": 0.01},
}
TINY_PARAMS = {"kitchen49k.gi_static": {"warmup_frames": 3,
                                         "uniform_sets": 2},
               "kitchen49k.vis_resolve": {"warmup_frames": 2,
                                           "jitters": 3}}
#: a cell of the ``vis_resolve`` traffic on the kitchen, which no cell of
#: BENCHMARK.json uses yet: written as a later PR would add it, as data
VIS_RESOLVE = {"name": "kitchen49k.vis_resolve",
               "config": "kitchen49k-room-1080p", "traffic": "vis_resolve",
               "chips": 1, "why": "visibility and its resolve, GI bypassed",
               "params": {}, "limits": {}}


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    root = tmp_path / "bench"
    bench = root / "perfbench"
    for kind in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(REPO / "perfbench" / kind, bench / kind)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, over in TINY.items():
        path = bench / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for key, value in over.items():
            if key == "sdf":
                cfg["sdf"].update(value)
            else:
                cfg[key] = value
        path.write_text(json.dumps(cfg))
    (bench / "workloads" / "kitchen49k.vis_resolve.json").write_text(
        json.dumps(VIS_RESOLVE))
    for name, params in TINY_PARAMS.items():
        path = bench / "workloads" / f"{name}.json"
        wl = json.loads(path.read_text())
        wl["params"].update(params)
        wl["limits"] = TINY_LIMITS[name]
        path.write_text(json.dumps(wl))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", bench)
    return root
