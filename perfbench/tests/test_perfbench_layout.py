"""The benchmark's layout: the import guard, BENCHMARK.json against the
files it names, and a new cell and a new metric picked up from their
files alone."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

from perfbench import guard
from perfbench import run as harness

REPO = Path(__file__).resolve().parents[2]
MODULES = ["perfbench.run", "perfbench.control", "perfbench.guard",
           "perfbench.trace", "perfbench.roofline", "perfbench.program",
           "perfbench.stage_arrays", "perfbench.reference.visibility",
           "perfbench.reference.sdf", "perfbench.reference.lightloop",
           "perfbench.reference.compare"]


def _loaded_after(imports: list[str], extra: str = "") -> set[str]:
    code = ("import sys, json\n"
            + "".join(f"import {m}\n" for m in imports) + extra
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_compare_whole():
    assert guard.loaded_forbidden(["vri_tpu_torch.renderer", "torch"]) == []
    assert guard.loaded_forbidden(["vri_tpu.ops", "jaxlib.xla"]) == [
        "jaxlib", "vri_tpu"]


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    extra = ("import importlib.util, pathlib\n"
             "for kind in ('traffic', 'metrics'):\n"
             "    for p in sorted(pathlib.Path('perfbench', kind)"
             ".glob('*.py')):\n"
             "        s = importlib.util.spec_from_file_location("
             "'m_' + p.stem.replace('.', '_'), p)\n"
             "        s.loader.exec_module(importlib.util.module_from_spec(s))"
             "\n")
    names = _loaded_after(MODULES, extra)
    assert "vri_tpu_torch" in names          # the program is loaded
    assert not names & guard.FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded_after([m for m in MODULES if ".reference." in m])
    assert not names & guard.FORBIDDEN_IN_REFERENCE
    assert guard.reference_imports() == {}


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["command"] == ["python3", "perfbench/run.py"]
    for cfg in spec["configs"]:
        data = json.loads((REPO / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"]
    names = {c["name"] for c in spec["configs"]}
    for wl in spec["workloads"]:
        data = harness.load_json("workloads", wl["name"])
        assert data["config"] == wl["config"] in names
        assert data["traffic"] == wl["traffic"]
        assert data["chips"] == wl["chips"] == 1
        assert (REPO / "perfbench" / "traffic" / f"{wl['traffic']}.py"
                ).is_file()
    for m in spec["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    limits = {k for wl in spec["workloads"]
              for k in harness.load_json("workloads", wl["name"])["limits"]}
    assert limits


def test_the_kitchen_settings_are_the_room_preset():
    from vri_tpu_torch import SDFConfig

    cfg = harness.load_json("configs", "kitchen49k-room-1080p")
    assert cfg["sdf"] == dataclasses.asdict(SDFConfig.preset("room"))


def test_a_new_cell_and_a_new_metric_are_picked_up(tiny_bench):
    bench = tiny_bench / "perfbench"
    wl = json.loads((bench / "workloads" / "kitchen49k.vis_resolve.json")
                    .read_text())
    wl["name"] = "kitchen49k.extra"
    wl["params"]["jitters"] = 2
    (bench / "workloads" / "kitchen49k.extra.json").write_text(
        json.dumps(wl))
    (bench / "metrics" / "frames_profiled.py").write_text(
        "def read(ctx):\n    return float(ctx.frames)\n")
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "kitchen49k.extra",
                              "config": wl["config"],
                              "traffic": wl["traffic"], "chips": 1,
                              "why": "a later cell"})
    spec["per_layer"].append({"name": "frames_profiled", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "frame_ms",
                              "workloads": ["kitchen49k.extra"]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = harness.run("kitchen49k.extra", 3, 0.2, True, device="cpu")
    assert result["metrics"]["frames_profiled"]["value"] == \
        harness.PROFILE_FRAMES
    result, _ = harness.run("kitchen49k.extra", 3, 0.2, False,
                            device="cpu")
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "kitchen49k.gi_static", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
