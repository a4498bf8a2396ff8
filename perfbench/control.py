"""Readings that set the limits of a cell's check.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--frames 40] [--out FILE]

In one process (the set-up is paid once): for each seed the cell draws
that seed's inputs and warms up again (``Cell.reseed``), renders
``--frames`` frames and compares its last frame with the reference
(the lower readings); for the first ``--control`` seeds the control, the
reference computed with every stored tensor in bfloat16, is compared
with the reference the same way (the upper readings).  One JSON line per
seed on standard output; ``--out`` also writes them all to a file.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as harness  # noqa: E402


def readings(workload: str, seeds, n_control: int, frames: int,
             device: str = "cuda"):
    import torch

    wl = harness.load_json("workloads", workload)
    cfg = harness.load_json("configs", wl["config"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = harness.load_module("traffic", wl["traffic"]).Cell(
        cfg, wl, seeds[0], torch.device(device), harness.Spans(sync))
    cell.setup()
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if i:
            cell.reseed(seed)
        for _ in range(frames):
            cell.frame()
        sync()
        cell.keep()
        cell.snapshot()
        row = {"workload": workload, "seed": seed}
        if i < n_control:
            row["program"], row["control"] = cell.control()
        else:
            row["program"] = cell.check()
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.control, args.frames)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
