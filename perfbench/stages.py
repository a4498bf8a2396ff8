"""The frame's stages, read through the program's own spans.

The program marks each frame with a ``frame`` root span whose children
are its stages, and the SDF build with ``sdf.emit`` and ``sdf.bake``
(``vri_tpu_torch/runtime/profiler.py``); ``profiler.start_recording()``
keeps them in memory with their host interval and, on a card, a device
interval between two CUDA events.  :func:`measure` runs three more
stretches of frames on a cell that is set up and warm, after the
harness's own profiled stretches, so that those read what they read
without the recording:

* stretch H, ``FRAMES`` frames with the recording on and no profiler:
  each stage's host self time a frame (its span's duration less its
  children's), ``<stage>_host_ms``;
* stretch D, ``FRAMES`` frames with the recording on under
  ``torch.profiler`` with the CUDA activity alone.  The host clock is fit
  to the trace's host-side clock from the time each frame's
  ``synchronize()`` returned against the end of that call's
  ``cudaDeviceSynchronize`` in the trace, and each kernel, copy and set
  is given to the span open on the host when its launch (the
  ``cuda_runtime`` event of the same ``correlation``) was made.  The
  card's timestamps reach the trace through a conversion whose rate can
  run off the host's clock by up to a few percent, from any frame on, so
  each frame's device work is placed on the host's clock by the line
  under its own launch-to-start lags (:func:`place`), its durations
  taken over the line's rate.  Then each stage's kernels a frame and
  their device time a frame, ``<stage>_launches`` and
  ``<stage>_device_ms``, and each idle stretch of the device by the span
  open when it began.  A frame with a kernel launch whose kernel the
  trace lacks (the profiler loses device records at times, a few or a
  frame's worth) is left out, and so is a frame whose lags leave its
  line, or whose placed work ends after its return, by over
  ``MAX_RESIDUAL_S``;
* a pass of ``SYNC_FRAMES`` frames with the recording on under
  ``torch.cuda.set_sync_debug_mode("warn")``: each synchronizing
  operation goes to the span open when it was reported.

Stretch D gives no numbers when under half its frames are left; the
launches and device ms read None when the fitted host clocks miss a
frame's return by over ``MAX_RESIDUAL_S`` or when under ``MIN_IN_FRAME``
of the stretch's kernels were launched inside a ``frame`` root.  A
program without the recording (``profiler.start_recording``) gives no
numbers.  :func:`setup_numbers` reads ``sdf_emit_s`` and ``sdf_bake_s``
from a recording of the set-up: the device intervals of those spans,
summed.

A per-layer metric reader reads its number with :func:`read` from the
``stages`` attribute of the harness's context.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

from perfbench import trace as trace_mod

STAGES = ("visibility", "gbuffer", "direct", "indirect", "history")
ROOT = "frame"
FRAMES = 24
SYNC_FRAMES = 4
MAX_RESIDUAL_S = 50e-6
MIN_IN_FRAME = 0.99
PLACE_BINS = 8
OUTSIDE = "(outside frames)"
HOST_SYNC = "cudaDeviceSynchronize"


# -- spans --------------------------------------------------------------------

def _host_s(rec):
    return rec.host_start_ns * 1e-9, rec.host_end_ns * 1e-9


def self_seconds(records) -> dict:
    """Host self time of each span name inside a frame, summed: each
    span's duration less its children's."""
    own = [(r.host_end_ns - r.host_start_ns) * 1e-9 for r in records]
    for r in records:
        if r.parent >= 0:
            own[r.parent] -= (r.host_end_ns - r.host_start_ns) * 1e-9
    out = defaultdict(float)
    for r, s in zip(records, own):
        if r.frame >= 0:
            out[r.name] += s
    return dict(out)


def roots(records) -> list:
    return [i for i, r in enumerate(records)
            if r.parent == -1 and r.name == ROOT]


class SpanIndex:
    """Which recorded span was open at a host time: the innermost span of
    the ``frame`` root around it, ``OUTSIDE`` between frames."""

    def __init__(self, records):
        self.records = records
        self.roots = roots(records)
        self.starts = [records[i].host_start_ns * 1e-9 for i in self.roots]
        below = defaultdict(list)
        for i, r in enumerate(records):
            top = i
            while records[top].parent >= 0:
                top = records[top].parent
            if top != i:
                below[top].append(i)
        self.below = below

    def open_at(self, t: float) -> str:
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return OUTSIDE
        root = self.roots[k]
        s, e = _host_s(self.records[root])
        if t > e:
            return OUTSIDE
        best, best_s = root, s
        for i in self.below[root]:
            si, ei = _host_s(self.records[i])
            if si <= t <= ei and si >= best_s:
                best, best_s = i, si
        return self.records[best].name


# -- the device trace ---------------------------------------------------------

def fit_clock(host_s, device_s):
    """(offset, residual): the host clock less the trace's, as the mean of
    the pairs' differences, and the largest distance of a pair from it."""
    d = [h - t for h, t in zip(host_s, device_s)]
    offset = sum(d) / len(d)
    return offset, max(abs(x - offset) for x in d)


def envelope(points):
    """The line under ``points`` ((x, y), sorted by x): the edge of their
    lower convex hull over their mean x, as (x0, y0, slope)."""
    hull = []
    for p in points:
        while len(hull) >= 2 and (
                (hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                - (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])) <= 0:
            hull.pop()
        hull.append(p)
    if len(hull) == 1:
        return (*hull[0], 0.0)
    mean = sum(x for x, _ in points) / len(points)
    j = min(max(bisect.bisect_right([x for x, _ in hull], mean) - 1, 0),
            len(hull) - 2)
    (x0, y0), (x1, y1) = hull[j], hull[j + 1]
    return x0, y0, (y1 - y0) / (x1 - x0)


def place(points, bins: int):
    """The line under a frame's (launch, start less launch) points and the
    largest distance of a stretch's least point above it, the frame's
    launches cut into ``bins`` stretches of time: near 0 where the lag
    from launch to start on an idle card follows one line, as it does
    when the card's timestamps run at a steady rate against the host's;
    large where they jump, and where every launch of a stretch waited
    behind earlier work (a miss it cannot tell from a jump)."""
    x0, y0, slope = line = envelope(points)
    lo, hi = points[0][0], points[-1][0]
    least = {}
    for x, y in points:
        b = min(int(bins * (x - lo) / max(hi - lo, 1e-12)), bins - 1)
        least[b] = min(least.get(b, float("inf")),
                       y - y0 - slope * (x - x0))
    return line, max(least.values())


def device_stages(events, records, sync_ns) -> dict:
    """Stretch D's numbers from its Chrome trace ``events``, the spans
    recorded over it and the host time (``perf_counter_ns``) each frame's
    ``synchronize()`` returned: the numbers cover the frames the trace
    holds whole and that its card timestamps let place."""
    launch = {}                     # correlation -> launch time (trace, s)
    kernel_calls = []               # (time, correlation) of kernel launches
    syncs = []
    dev = []                        # (start, end, cat, correlation)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s = e["ts"] * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                launch.setdefault(corr, s)
                if "LaunchKernel" in e.get("name", ""):
                    kernel_calls.append((s, corr))
            if e.get("name") == HOST_SYNC:
                syncs.append((s, s + e["dur"] * 1e-6))
        elif cat in trace_mod.DEVICE_CATS:
            dev.append((s, s + e["dur"] * 1e-6, cat, corr))
    n = len(sync_ns)
    rs = roots(records)
    # the frames' synchronizes: those after a kernel launch since the last
    # one (the profiler's own, around the stretch, follow none)
    calls = sorted(t for t, _ in kernel_calls)
    sync_starts, sync_ends, last = [], [], float("-inf")
    for s, t in sorted(syncs):
        if bisect.bisect_left(calls, s) > bisect.bisect_right(calls, last):
            sync_starts.append(s)
            sync_ends.append(t)
            last = t
    if len(sync_starts) != n or len(rs) != n or not dev:
        return {"fault": f"{len(sync_starts)} {HOST_SYNC} calls after "
                         f"launches and {len(rs)} frame spans for {n} "
                         f"frames, {len(dev)} device intervals"}

    def frame_of(corr):
        """The frame that launched it; n without a launch record, n + 1
        when launched after the last frame."""
        at = launch.get(corr)
        if at is None:
            return n
        k = bisect.bisect_left(sync_starts, at)
        return k if k < n else n + 1

    host = [t * 1e-9 for t in sync_ns]
    # the host clock less the trace's host-side clock: each return against
    # the trace's end of the same synchronize call (launch attribution)
    offset, residual = fit_clock(host, sync_ends)
    # the card's timestamps reach the trace through a conversion whose
    # rate can run off the host's by up to a few percent, from any frame
    # on; each frame's device work is placed on the host's clock by the
    # line under its own launch-to-start lags (on an idle card, the launch
    # latency), the line inverted.  A frame
    # whose lags leave the line, or whose work would end after its return,
    # by over MAX_RESIDUAL_S is left out
    per = defaultdict(list)
    for d in dev:
        per[frame_of(d[3])].append(d)
    lost = [0] * (n + 2)
    held = {d[3] for d in dev}
    for _, c in kernel_calls:
        lost[frame_of(c)] += c not in held
    placed, place_res, rates, at_first = {}, {}, {}, {}
    for k in range(n):
        if lost[k] or not per[k]:
            continue
        (x0, y0, rate), res = place(sorted(
            (launch[c], s - launch[c]) for s, _, _, c in per[k]), PLACE_BINS)
        # the line's trace time of host time u is u + y0 + rate (u - x0)
        ivs = [(x0 + (s - x0 - y0) / (1.0 + rate) + offset,
                x0 + (t - x0 - y0) / (1.0 + rate) + offset, cat, c)
               for s, t, cat, c in per[k]]
        res = max(res, max(iv[1] for iv in ivs) - host[k])
        if res <= MAX_RESIDUAL_S:
            placed[k], place_res[k], rates[k] = ivs, res, rate
            first = min(launch[c] for _, _, _, c in per[k])
            at_first[k] = y0 + rate * (first - x0)
    whole = sorted(placed)
    lost_frames = sum(1 for k in range(n) if lost[k] or not per[k])
    out = {"frames": len(whole), "frames_lost": lost_frames,
           "frames_unplaced": n - lost_frames - len(whole)}
    if 2 * len(whole) < n:
        out["fault"] = (f"the trace lost kernels of {lost_frames} frames "
                        f"and placed {len(whole)} of the rest")
        return out
    out["clock_offset_s"], out["clock_residual_s"] = offset, residual
    out["placement_residual_s"] = max(place_res.values())
    # how far one offset, and one rate, for the card's timestamps would
    # miss: the spread of the frames' lines at their first launches, and
    # the largest rate off the host's
    out["device_drift_s"] = max(at_first.values()) - min(at_first.values())
    out["device_rate_off"] = max(abs(r) for r in rates.values())

    # the placed frames' device work, and work without a launch record
    # (outside every frame), given to the span open at its launch
    index = SpanIndex(records)
    launches = defaultdict(int)
    busy = defaultdict(float)
    in_frame = kernels = 0
    for s, t, cat, corr in [iv for k in whole for iv in placed[k]] + per[n]:
        at = launch.get(corr)
        name = OUTSIDE if at is None else index.open_at(at + offset)
        busy[name] += t - s
        if cat == "kernel":
            kernels += 1
            launches[name] += 1
            in_frame += name != OUTSIDE
    f = len(whole)
    out["kernels"] = kernels
    out["in_frame_share"] = in_frame / max(kernels, 1)
    out["launches"] = {k: v / f for k, v in launches.items()}
    out["device_ms"] = {k: 1e3 * v / f for k, v in busy.items()}

    # idle device time in each placed frame, from its span's start to its
    # return, by the span open as it began
    idle = defaultdict(float)
    out["busy_s"] = out["window_s"] = 0.0
    for k in whole:
        w0, w1 = records[rs[k]].host_start_ns * 1e-9, host[k]
        us = [{"ph": "X", "cat": "user_annotation", "name": trace_mod.STRETCH,
               "ts": w0 * 1e6, "dur": (w1 - w0) * 1e6}]
        us += [{"ph": "X", "cat": cat, "ts": s * 1e6, "dur": (t - s) * 1e6}
               for s, t, cat, _ in placed[k]]
        tr = trace_mod.Trace(us)
        merged = tr.busy_intervals()
        edges = [tr.t0] + [x for iv in merged for x in iv] + [tr.t1]
        for i in range(0, len(edges), 2):
            if edges[i + 1] > edges[i]:
                idle[index.open_at(edges[i])] += edges[i + 1] - edges[i]
        out["busy_s"] += sum(t - s for s, t in merged)
        out["window_s"] += tr.window_s
    out["idle_s"] = dict(idle)
    return out


# -- the stretches ------------------------------------------------------------

def _sync_times(fn):
    """Run ``fn`` under CUDA sync debugging at "warn"; the host time
    (``perf_counter_ns``) and the message of each synchronizing operation
    it reports."""
    import torch

    times = []

    def hook(message, *args, **kwargs):
        if "synchroniz" in str(message):
            times.append((time.perf_counter_ns(), str(message)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return times


def _frames(cell, sync, n, sync_ns=None):
    for _ in range(n):
        cell.frame()
        sync()
        if sync_ns is not None:
            sync_ns.append(time.perf_counter_ns())


def measure(cell, sync, cuda: bool, frames: int = FRAMES,
            sync_frames: int = SYNC_FRAMES):
    """Stretches H and D and the sync pass on a cell that is set up; None
    for a program without the recording."""
    from vri_tpu_torch.runtime import profiler

    if not hasattr(profiler, "start_recording"):
        return None
    out = {}
    profiler.start_recording()
    try:
        t0 = time.perf_counter()
        _frames(cell, sync, frames)
        out["stretch_h_frame_ms"] = 1e3 * (time.perf_counter() - t0) / frames
    finally:
        recs = profiler.stop_recording()
    n = max(len(roots(recs)), 1)
    own = self_seconds(recs)
    out["host_ms"] = {k: 1e3 * v / n for k, v in own.items()}
    if not cuda:
        return out

    import torch

    sync_ns = []
    profiler.start_recording()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _frames(cell, sync, frames, sync_ns)
    finally:
        recs = profiler.stop_recording()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stages.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out["device"] = device_stages(events, recs, sync_ns)

    profiler.start_recording()
    try:
        times = _sync_times(lambda: _frames(cell, lambda: None,
                                            sync_frames))
        sync()
    finally:
        recs = profiler.stop_recording()
    index = SpanIndex(recs)
    by, why = defaultdict(int), defaultdict(int)
    for t, msg in times:
        name = index.open_at(t * 1e-9)
        by[name] += 1
        why[f"{name}: {msg.splitlines()[0][:100]}"] += 1
    out["syncs"] = {k: v / sync_frames for k, v in by.items()}
    out["sync_messages"] = dict(why)
    return out


def setup_numbers(records) -> dict:
    """``sdf_emit_s`` and ``sdf_bake_s``: the device intervals of the
    set-up's ``sdf.emit`` and ``sdf.bake`` spans, summed (None without a
    card or without such a span)."""
    out = {}
    for name, key in (("sdf.emit", "sdf_emit_s"), ("sdf.bake", "sdf_bake_s")):
        ivs = [(r.device_start_s, r.device_end_s) for r in records
               if r.name == name and r.device_start_s is not None]
        out[key] = sum(e - s for s, e in ivs) if ivs else None
    return out


# -- the metrics --------------------------------------------------------------

def metrics(stages, setup=None) -> dict:
    """Every per-stage metric by name (None where it was not read)."""
    out = {}
    host = (stages or {}).get("host_ms", {})
    dev = (stages or {}).get("device") or {}
    sound = (dev.get("clock_residual_s", 1.0) <= MAX_RESIDUAL_S
             and dev.get("in_frame_share", 0.0) >= MIN_IN_FRAME)
    for s in STAGES:
        out[f"{s}_host_ms"] = host.get(s)
        for kind in ("launches", "device_ms"):
            out[f"{s}_{kind}"] = (dev[kind].get(s, 0.0) if sound else None)
    out.update(setup or {"sdf_emit_s": None, "sdf_bake_s": None})
    return out


def read(ctx, name: str):
    """The metric ``name`` from ``ctx.stages`` ({"stages": measure(...),
    "setup": setup_numbers(...)}); None where the harness recorded no
    spans."""
    got = getattr(ctx, "stages", None)
    if not got:
        return None
    return metrics(got.get("stages"), got.get("setup")).get(name)
