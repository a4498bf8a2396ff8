"""Reading a ``torch.profiler`` trace of a stretch of frames.

The profiler writes a Chrome trace (``export_chrome_trace``) into a
temporary directory; :func:`read_trace` reduces it to what the per-layer
metric readers and the result line need: the device intervals (kernels,
copies and sets), the kernel time and launch count by name, the host
operations, and the traced window (the ``perfbench.stretch`` range the
harness records around the frames).
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "perfbench.stretch"


class Trace:
    """Device and host intervals of one traced stretch, in seconds.  The
    stretch is the ``perfbench.stretch`` range when the trace holds host
    operations; a trace of the device alone gives its length
    (``window_s``, from the host clock) and starts at its first device
    interval."""

    def __init__(self, events, window_s: float | None = None):
        win = [e for e in events if e.get("name") == STRETCH
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if win:
            w = max(win, key=lambda e: e["dur"])
            self.t0 = w["ts"] * 1e-6
            self.t1 = (w["ts"] + w["dur"]) * 1e-6
        elif window_s is not None:
            starts = [e["ts"] for e in events if e.get("ph") == "X"
                      and e.get("cat") in DEVICE_CATS]
            if not starts:
                raise ValueError("the trace holds no device interval")
            self.t0 = min(starts) * 1e-6
            self.t1 = self.t0 + window_s
        else:
            raise ValueError("the trace holds no perfbench.stretch range")
        self.device = []       # (start, end, name, cat)
        self.host = []         # (start, end, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = e["ts"] * 1e-6
            t = s + e["dur"] * 1e-6
            if t < self.t0 or s > self.t1:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((max(s, self.t0), min(t, self.t1),
                                    e.get("name", "?"), cat))
            elif cat in HOST_CATS and e.get("name") != STRETCH:
                self.host.append((s, t, e.get("name", "?")))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        """The union of the device intervals, merged, in time order."""
        out = []
        for s, t, _, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def kernels(self, pattern: str | None = None):
        """(total seconds, launches) of the kernels whose name holds
        ``pattern`` (every kernel without one)."""
        ks = [(s, t) for s, t, n, c in self.device
              if c == "kernel" and (pattern is None or pattern in n)]
        return sum(t - s for s, t in ks), len(ks)

    def top_device_ops(self, n: int = 10):
        by = defaultdict(float)
        for s, t, name, _ in self.device:
            by[name] += t - s
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle device time by the innermost host operation running when
        each gap began, summed by name, largest first."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted(self.host)
        by = defaultdict(float)
        for i in range(0, len(edges), 2):
            s, t = edges[i], edges[i + 1]
            if t - s <= 0:
                continue
            inner = [h for h in host if h[0] <= s < h[1]]
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "(host, between operators)")
            by[name] += t - s
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def read_trace(path: str, window_s: float | None = None) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events, window_s)
