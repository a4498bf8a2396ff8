"""Profiling spans, traces, in-memory span records and frame statistics
(counterpart of ``vri_tpu/runtime/profiler.py`` on PyTorch).

``span`` marks a region of the program.  With nothing recording it costs
one flag test: it hands back a shared null context, with no NVTX range,
no ``record_function`` and no clock read (``log_ms`` still logs its wall
time).  While ``start_trace`` runs, a span is a ``record_function`` range
in the trace and, with a CUDA card, an NVTX range; ``stop_trace`` writes
the ``torch.profiler`` trace of the CPU and, on the card, of the CUDA
kernels (the ctypes kernels included: CUPTI sees every launch) as a
Chrome trace into the given directory.  Between ``start_recording`` and
``stop_recording`` each span is kept in memory as a :class:`SpanRecord`:
its parent, its frame, its host interval and, on a card, the interval
between two CUDA events recorded as it opened and closed, on the stream
current when the recording started.  Nothing is written while
recording; ``stop_recording`` synchronizes once, resolves the events and
keeps them for the next recording.  ``count`` keeps a named value (a
host number or a device scalar, held by reference with no sync) with
its frame while a recording runs, and costs one test otherwise;
``stop_recording`` resolves the device ones after its synchronize, and
``recorded_counts`` hands them out.

``frame_root`` makes each call of a frame function the root span
``frame`` of its spans (a frame called inside another frame opens no
second root).  :class:`FrameStats` keeps the rolling FPS and frame time
of the app's display; ``device_memory_stats`` reports the allocated bytes
of each card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import os
import time
from typing import Dict, List, Optional

import torch

log = logging.getLogger("vri_tpu_torch")

#: True while a trace or a recording runs: the one test an idle span makes
_on = False
_trace: Optional[tuple] = None      # (profiler, directory) while tracing
_rec: Optional["_Recording"] = None
_in_frame = False                   # a ``frame`` root span is open
_NULL = contextlib.nullcontext()
_events: list = []                  # timing events resolved, for reuse
_counts: list = []                  # the last recording's CountRecords


@dataclasses.dataclass
class SpanRecord:
    """One span of a recording.  ``parent`` is the index of the span open
    around it (-1 for none); every span of one frame shares ``frame``
    (-1 outside a frame).  Host times are ``time.perf_counter_ns()``;
    device times are seconds from the recording's start on the device's
    own clock (CUDA events), None without a card."""

    name: str
    parent: int
    frame: int
    host_start_ns: int
    host_end_ns: int = 0
    device_start_s: Optional[float] = None
    device_end_s: Optional[float] = None


@dataclasses.dataclass
class CountRecord:
    """One ``count`` of a recording: its name, the frame it was counted
    in (-1 outside a frame) and its value."""

    name: str
    frame: int
    value: float


class _Recording:
    def __init__(self):
        self.records: List[SpanRecord] = []
        #: (name, frame, host number or device scalar), resolved at the end
        self.counts: list = []
        self.open: List[int] = []
        self.frame = -1              # id of the open frame root
        self.root = -1               # index of the open frame root
        self.frames = 0
        self.events = [] if torch.cuda.is_available() else None
        if self.events is not None:
            self.stream = torch.cuda.current_stream()
            self.origin = self._event()

    def _event(self):
        ev = _events.pop() if _events else torch.cuda.Event(
            enable_timing=True)
        ev.record(self.stream)
        return ev

    def begin(self, name: str, root: bool) -> int:
        i = len(self.records)
        if root:
            self.frame, self.frames, self.root = self.frames, \
                self.frames + 1, i
        self.records.append(SpanRecord(
            name, self.open[-1] if self.open else -1, self.frame,
            time.perf_counter_ns()))
        if self.events is not None:
            self.events.append([self._event(), None])
        self.open.append(i)
        return i

    def end(self, i: int) -> None:
        if self.events is not None:
            self.events[i][1] = self._event()
        self.records[i].host_end_ns = time.perf_counter_ns()
        self.open.pop()
        if i == self.root:
            self.frame = self.root = -1


class _Span:
    __slots__ = ("name", "log_ms", "root", "t0", "rf", "rec", "i")

    def __init__(self, name: str, log_ms: bool = False, root: bool = False):
        self.name, self.log_ms, self.root = name, log_ms, root

    def __enter__(self):
        global _in_frame
        if self.root:
            _in_frame = True
        self.rf = None
        if _trace is not None:
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _rec
        if _rec is not None:
            self.i = _rec.begin(self.name, self.root)
        if self.log_ms:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _in_frame
        if self.rec is not None and self.rec is _rec:
            self.rec.end(self.i)
        if self.rf is not None:
            self.rf.__exit__(*exc)
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()
        if self.root:
            _in_frame = False
        if self.log_ms:
            log.info("[span] %s: %.2f ms", self.name,
                     1e3 * (time.perf_counter() - self.t0))
        return False


def span(name: str, log_ms: bool = False):
    """Profiling span ``name``: free unless a trace or a recording runs,
    then a ``record_function`` and NVTX range (trace) and a
    :class:`SpanRecord` (recording); with ``log_ms`` a log line of its
    wall time in any case."""
    if _on or log_ms:
        return _Span(name, log_ms)
    return _NULL


def frame_root(fn):
    """Decorator: each call of the frame function ``fn`` is one root span
    ``frame`` while a trace or a recording runs; a call inside an open
    frame (a frame function called by another) opens no second root."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _on or _in_frame:
            return fn(*args, **kwargs)
        with _Span("frame", root=True):
            return fn(*args, **kwargs)
    return wrapped


def count(name: str, value) -> None:
    """Keep ``value`` (a host number or a device scalar) under ``name``
    with the open frame while a recording runs; free otherwise.  A
    device scalar is held by reference and read at
    :func:`stop_recording`, so counting adds no sync to a frame."""
    if _rec is not None:
        _rec.counts.append((name, _rec.frame, value))


def _set_on() -> None:
    global _on
    _on = _trace is not None or _rec is not None


def start_trace(log_dir: str) -> None:
    """Start recording a trace of the CPU and, with a card, of its CUDA
    kernels; :func:`stop_trace` writes it into ``log_dir``."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already being recorded")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace = (prof, log_dir)
    _set_on()


def stop_trace() -> str:
    """Stop the trace and write it as a Chrome trace; returns its path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is being recorded")
    prof, log_dir = _trace
    _trace = None
    _set_on()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}"
                                 ".json")
    prof.export_chrome_trace(path)
    log.info("trace written: %s", path)
    return path


def start_recording() -> None:
    """Keep every span from now on in memory (:func:`stop_recording`)."""
    global _rec
    if _rec is not None:
        raise RuntimeError("spans are already being recorded")
    _rec = _Recording()
    _set_on()


def stop_recording() -> List[SpanRecord]:
    """Stop recording and return the spans in the order they opened, a
    span still open ended now; on a card, after one synchronize, with
    their device intervals.  The recording's counts, device scalars read
    after that synchronize, are then :func:`recorded_counts`."""
    global _rec, _counts
    rec = _rec
    if rec is None:
        raise RuntimeError("no spans are being recorded")
    while rec.open:
        rec.end(rec.open[-1])
    _rec = None
    _set_on()
    if rec.events is not None:
        torch.cuda.synchronize()
        for r, (b, e) in zip(rec.records, rec.events):
            r.device_start_s = 1e-3 * rec.origin.elapsed_time(b)
            r.device_end_s = 1e-3 * rec.origin.elapsed_time(e)
            _events.extend((b, e))
        _events.append(rec.origin)
    dev = [v for _, _, v in rec.counts if torch.is_tensor(v)]
    read = iter(torch.stack([v.reshape(()).double() for v in dev]).tolist()
                if dev else ())
    _counts = [CountRecord(name, frame, float(next(read))
                           if torch.is_tensor(v) else float(v))
               for name, frame, v in rec.counts]
    return rec.records


def recorded_counts() -> List[CountRecord]:
    """The counts of the recording :func:`stop_recording` last ended, in
    the order they were made."""
    return list(_counts)


class FrameStats:
    """Rolling frame-time stats (the FPS / frame-ms display)."""

    def __init__(self, window: int = 64):
        self.times = collections.deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def frame_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1e3 * sum(self.times) / len(self.times)

    @property
    def fps(self) -> float:
        ms = self.frame_ms
        return 1000.0 / ms if ms > 0 else 0.0

    def summary(self) -> str:
        return f"{self.fps:.1f} fps ({self.frame_ms:.2f} ms)"


def device_memory_stats() -> Dict[str, int]:
    """Allocated bytes of each visible card, keyed ``cuda:<i>``; empty
    without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current", 0))
            for i in range(torch.cuda.device_count())}
