"""Benchmark of ``vri_tpu_torch`` on NVIDIA GPUs: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``perfbench/workloads/<cell>.json``) names its configuration
(``perfbench/configs/<config>.json``) and its traffic kind, whose module
(``perfbench/traffic/<kind>.py``) sets the renderer up from the seed,
warms up every shape the frames use and renders one frame a call.  The
run then measures a closed loop for ``--seconds``: a viewer presents a
frame and asks for the next, so each frame is one call ended by
``torch.cuda.synchronize()``.  With ``--trace 1`` it then profiles a
steady stretch of frames and counts the host syncs of a few more, and
reports the per-layer metrics of ``BENCHMARK.json`` instead of the
end-to-end ones: each is read by ``perfbench/metrics/<name>.py``.  After
the window the program's state is freed and the last frame is compared
with the plain reference of ``perfbench/reference/``; each number
compared is printed beside its limit.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
with ``--trace 1``), then ``check``, the numbers compared.  Without a
CUDA card, with fewer cards than the cell asks for, or with JAX or the
JAX package ``vri_tpu`` loaded, the run exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import guard  # noqa: E402
from perfbench import trace as trace_mod  # noqa: E402

BENCH = ROOT / "perfbench"
#: frames the --trace 1 run profiles, and frames whose host syncs it counts
PROFILE_FRAMES = 24
SYNC_FRAMES = 4
KEEP_AMONG = 64


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"perfbench: no {kind[:-1]} named {name!r} "
                         f"({path.relative_to(ROOT)})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: no {kind} module {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_of(spec: dict, group: str, workload: str) -> list[dict]:
    """The metrics of ``group`` that ``workload`` reports."""
    return [m for m in spec[group]
            if workload in m.get("workloads", [workload])]


class Spans:
    """Host-clock spans the harness records around calls into a layer,
    each ended by a synchronize when the run has a card."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds: dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


class Context:
    """What a per-layer metric reader may read: the harness's spans, the
    trace of the profiled stretch, the frames profiled, the host syncs
    counted and the least time of each kernel a frame (from the frame's
    inputs, ``perfbench/roofline.py``)."""

    def __init__(self, spans, trace, frames, syncs, sync_frames, least):
        self.spans = spans
        self.trace = trace
        self.frames = frames
        self.syncs = syncs
        self.sync_frames = sync_frames
        self.least = least


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile (numpy's default rule)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def count_syncs(fn):
    """Run ``fn`` with CUDA sync debugging at "warn" and count the
    synchronizing operations it reports."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(c.message) for c in caught)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        cell_hook=None):
    """One run of one cell.  Returns (result, check) where ``check`` maps
    each number compared to (value, limit).  ``device="cpu"`` drives the
    plain versions of the kernels (tests); ``cell_hook(cell)``, when
    given, may replace parts of the cell after its set-up (tests that
    break the timed path)."""
    import torch

    t_start = _T0 if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    wl = load_json("workloads", workload)
    cfg = load_json("configs", wl["config"])
    spec = benchmark_spec()
    e2e = metrics_of(spec, "end_to_end", workload)
    per_layer = metrics_of(spec, "per_layer", workload)

    spans = Spans(sync)
    cell = load_module("traffic", wl["traffic"]).Cell(
        cfg, wl, seed, torch.device(device), spans)
    cell.setup()
    if cell_hook is not None:
        cell_hook(cell)
    sync()
    setup_s = time.perf_counter() - t_start

    # -- the measured window ------------------------------------------------
    # the frame the check compares, drawn from the seed among the first
    # KEEP_AMONG of the window (the last, in a window that short)
    keep_at = random.Random(seed).randrange(KEEP_AMONG)
    # each frame returns its overflow count, a device scalar the frame
    # already made (or None), so the harness adds no work to the frame
    times, overs = [], []
    w0 = time.perf_counter()
    while True:
        f0 = time.perf_counter()
        overs.append(cell.frame())
        sync()
        f1 = time.perf_counter()
        times.append(f1 - f0)
        if len(times) == keep_at + 1:
            cell.keep()
        if f1 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if len(times) <= keep_at:
        cell.keep()
    attempted = len(times)
    bad = [False] * attempted
    at = [i for i, o in enumerate(overs) if o is not None]
    if at:
        hit = torch.stack([overs[i] for i in at]).reshape(-1).ne(0)
        for i, h in zip(at, hit.tolist()):
            bad[i] = h
    bad[-1] = bad[-1] or not cell.colour_finite()
    failed = sum(bad)
    del overs

    result_metrics, breakdown, extra_device = {}, None, {}
    prof_trace = syncs = None
    if trace and cuda:
        with tempfile.TemporaryDirectory() as tmp:
            # the device alone first, so the profiler adds little host
            # work to the stretch whose busy share is read
            path = os.path.join(tmp, "device.json")
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILE_FRAMES):
                    cell.frame()
                    sync()
                stretch_s = time.perf_counter() - t0
            prof.export_chrome_trace(path)
            prof_trace = trace_mod.read_trace(path, stretch_s)
            # then host and device, to name what the host did in the gaps
            path = os.path.join(tmp, "host.json")
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(trace_mod.STRETCH):
                    for _ in range(PROFILE_FRAMES):
                        cell.frame()
                        sync()
            prof.export_chrome_trace(path)
            host_trace = trace_mod.read_trace(path)
        syncs = count_syncs(
            lambda: [cell.frame() for _ in range(SYNC_FRAMES)])
        sync()
        extra_device = {"busy_s": prof_trace.busy_s,
                        "window_s": prof_trace.window_s}
        breakdown = {"device_ops": prof_trace.top_device_ops(),
                     "idle_gaps": host_trace.idle_gaps()}
    # the peak is read before any reference work runs on the device
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        ctx = Context(spans.seconds, prof_trace, PROFILE_FRAMES, syncs,
                      SYNC_FRAMES, cell.least_seconds())
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value,
                                             "unit": m["unit"]}
    else:
        measured = {
            "frame_ms": 1e3 * window_s / attempted,
            "frame_p95_ms": 1e3 * percentile(times, 95.0),
            "setup_s": setup_s,
        }
        if cuda:
            measured["peak_mem_gib"] = peak / 2 ** 30
        for m in e2e:
            if m["name"] in measured:
                result_metrics[m["name"]] = {"value": measured[m["name"]],
                                             "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": wl["chips"] if cuda else 1,
        "memory_peak_bytes": peak,
        **extra_device,
    }
    # the program's state goes before the reference runs, so the
    # reference neither sets the peak nor runs short of memory
    cell.release()
    sync()
    if cuda:
        torch.cuda.empty_cache()
    values = cell.check()
    limits = wl["limits"]
    check = {k: (float(v), limits.get(k)) for k, v in values.items()}
    correct = (set(values) == set(limits)
               and all(math.isfinite(v) and v <= lim
                       for v, lim in check.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in check.items()}
    for key, text in cell.notes().items():
        print(f"perfbench: {key}: {text}", file=sys.stderr)
    return result, check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = guard.loaded_forbidden()
    if bad:
        print(f"perfbench: refused: loaded {bad}", file=sys.stderr)
        return 3
    bad_ref = guard.reference_imports()
    if bad_ref:
        print(f"perfbench: refused: the reference imports {bad_ref}",
              file=sys.stderr)
        return 3
    import torch

    wl = load_json("workloads", args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, check = run(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    bad = guard.loaded_forbidden()
    if bad:
        print(f"perfbench: refused: loaded {bad} by the end of the run",
              file=sys.stderr)
        return 3
    for name, (value, limit) in check.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
