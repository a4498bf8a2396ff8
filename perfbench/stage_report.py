"""Per-stage report of one cell on the card, through the program's spans.

    python3 perfbench/stage_report.py --workload <cell> --seed <n> \
        [--seconds 10] [--pairs 96] [--out FILE]

Runs the cell as ``perfbench/run.py --trace 1`` does (``run.run``), with
three additions through its cell hook: the span recording over the
set-up (``sdf_emit_s``, ``sdf_bake_s`` beside the run's ``sdf_build_s``);
before the window, ``--pairs`` pairs of frames, one with the recording
off and one with it on, then a stretch H (the recording's cost and the
host's times before any profiler has run in the process); after the
run's profiled stretches and its sync count, ``stages.measure``
(stretches H and D and the sync pass) and the sync count once more.
Prints each per-stage metric, the checks that tie them to the run's
whole-frame numbers (``launches_per_frame``, the device's busy time,
``device_idle_pct``, ``host_syncs_per_frame``), and the idle time and
syncs by stage as ``perfbench:`` notes on standard error; the last line
of standard output (and ``--out``) is one JSON object of all of it.
Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import guard, stages  # noqa: E402
from perfbench import run as harness  # noqa: E402


def _pairs(cell, sync, pairs):
    """Frame ms of ``pairs`` pairs of frames, one with the recording off
    and one with it on, in the order off, on, on, off: (off, on) lists."""
    from vri_tpu_torch.runtime import profiler

    off, on = [], []
    for i in range(2 * pairs):
        rec = i % 4 in (1, 2)
        if rec:
            profiler.start_recording()
        t0 = time.perf_counter()
        cell.frame()
        sync()
        (on if rec else off).append(1e3 * (time.perf_counter() - t0))
        if rec:
            profiler.stop_recording()
    return off, on


def report(workload: str, seed: int, seconds: float, pairs: int,
           device: str = "cuda") -> dict:
    import torch

    from vri_tpu_torch.runtime import profiler

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}

    def hook(cell):
        setup_recs = profiler.stop_recording()
        out["setup_spans"] = len(setup_recs)
        out["setup"] = stages.setup_numbers(setup_recs)
        host_s = {}
        for r in setup_recs:
            host_s[r.name] = (host_s.get(r.name, 0.0)
                              + 1e-9 * (r.host_end_ns - r.host_start_ns))
        out["setup_host_s"] = host_s
        out["pairs_off_ms"], out["pairs_on_ms"] = _pairs(cell, sync, pairs)
        early = stages.measure(cell, sync, cuda=False)
        out["stretch_h_early_frame_ms"] = early["stretch_h_frame_ms"]
        out["host_ms_early"] = early["host_ms"]
        release = cell.release

        def measure_then_release():
            out["stages"] = stages.measure(cell, sync, cuda)
            if cuda:
                # a sync the card reports once a process shows as the
                # difference from the run's own count
                out["host_syncs_per_frame_again"] = harness.count_syncs(
                    lambda: [cell.frame()
                             for _ in range(harness.SYNC_FRAMES)]
                ) / harness.SYNC_FRAMES
                sync()
            release()

        cell.release = measure_then_release

    profiler.start_recording()
    try:
        result, _ = harness.run(workload, seed, seconds, True, device=device,
                                t_start=_T0, cell_hook=hook)
    finally:
        if "setup" not in out:
            profiler.stop_recording()
    out["run"] = result
    out["metrics"] = stages.metrics(out["stages"], out["setup"])
    out["checks"] = checks(out)
    return out


def checks(out) -> dict:
    """What ties the stage numbers to the run's whole-frame ones."""
    m, st = out["metrics"], out["stages"] or {}
    dev = st.get("device") or {}
    run = {k: v["value"] for k, v in out["run"]["metrics"].items()}
    on, off = out["pairs_on_ms"], out["pairs_off_ms"]
    c = {"correct": out["run"]["correct"]}
    if on:
        c["recording_cost_pct_in_pairs_median"] = 100.0 * (
            statistics.median(on) / statistics.median(off) - 1.0)
        c["recording_cost_pct_in_pairs_mean"] = 100.0 * (
            statistics.fmean(on) / statistics.fmean(off) - 1.0)
        c["stretch_h_early_pct_of_pairs_off"] = 100.0 * (
            out["stretch_h_early_frame_ms"] / statistics.fmean(off) - 1.0)
    host = st.get("host_ms", {})
    c["host_ms_sum"] = sum(host.values()) if host else None
    c["root_self_host_ms"] = host.get(stages.ROOT)
    if "launches" in dev:
        busy_ms = (1e3 * out["run"]["device"]["busy_s"]
                   / harness.PROFILE_FRAMES)
        lsum = sum(m[f"{s}_launches"] or 0.0 for s in stages.STAGES)
        dsum = sum(m[f"{s}_device_ms"] or 0.0 for s in stages.STAGES)
        placed_ms = 1e3 * dev["busy_s"] / dev["frames"]
        c.update(
            frames_lost=dev["frames_lost"],
            clock_residual_us=1e6 * dev["clock_residual_s"],
            placement_residual_us=1e6 * dev["placement_residual_s"],
            device_drift_us=1e6 * dev["device_drift_s"],
            in_frame_share=dev["in_frame_share"],
            stage_launches_sum=lsum,
            launches_per_frame=run.get("launches_per_frame"),
            launches_off_pct=100.0 * (lsum / run["launches_per_frame"] - 1),
            root_self_launches=dev["launches"].get(stages.ROOT, 0.0),
            stage_device_ms_sum=dsum,
            busy_ms_per_frame=busy_ms,
            device_ms_off_pct=100.0 * (dsum / busy_ms - 1),
            stretch_d_placed_busy_ms_per_frame=placed_ms,
            placed_busy_off_pct=100.0 * (placed_ms / busy_ms - 1),
            stretch_d_idle_pct=100.0 * (1 - dev["busy_s"] / dev["window_s"]),
            device_idle_pct=run.get("device_idle_pct"))
    if "syncs" in st:
        c["syncs_by_stage_sum"] = sum(st["syncs"].values())
        c["host_syncs_per_frame"] = run.get("host_syncs_per_frame")
        c["host_syncs_per_frame_again"] = out.get(
            "host_syncs_per_frame_again")
    build = run.get("sdf_build_s")
    if m.get("sdf_emit_s") is not None and build:
        c["emit_bake_share_of_build"] = (
            (m["sdf_emit_s"] + (m["sdf_bake_s"] or 0.0)) / build)
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=96)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"perfbench: refused: loaded {bad}", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card", file=sys.stderr)
        return 2
    out = report(args.workload, args.seed, args.seconds, args.pairs)
    st = out["stages"] or {}
    dev = st.get("device") or {}
    for key, val in (("idle_s_by_stage", dev.get("idle_s")),
                     ("syncs_per_frame_by_stage", st.get("syncs")),
                     ("syncs_by_stage_and_message", st.get("sync_messages")),
                     ("launches_per_frame_by_span", dev.get("launches")),
                     ("device_ms_per_frame_by_span", dev.get("device_ms")),
                     ("host_ms_per_frame_by_span", out["host_ms_early"]),
                     ("checks", out["checks"])):
        print(f"perfbench: {key}: {json.dumps(val)}", file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
