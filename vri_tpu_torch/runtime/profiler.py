"""Profiling spans, traces and frame statistics (counterpart of
``vri_tpu/runtime/profiler.py`` on PyTorch).

``span`` marks a region in ``torch.profiler`` traces (and, with a CUDA
card, as an NVTX range) and optionally logs its wall time;
``start_trace`` / ``stop_trace`` record a ``torch.profiler`` trace of the
CPU and, on the card, of the CUDA kernels (the ctypes kernels included:
CUPTI sees every launch), written as a Chrome trace into the given
directory; :class:`FrameStats` keeps the rolling FPS and frame time;
``device_memory_stats`` reports the allocated bytes of each card.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

log = logging.getLogger("vri_tpu_torch")

_trace: Optional[tuple] = None      # (profiler, directory) while recording


@contextlib.contextmanager
def span(name: str, log_ms: bool = False):
    """Profiling span: a ``record_function`` range in ``torch.profiler``
    traces, an NVTX range when a CUDA card is present, and with
    ``log_ms`` a log line of its wall time."""
    t0 = time.perf_counter()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    if log_ms:
        log.info("[span] %s: %.2f ms", name, 1e3 * (time.perf_counter() - t0))


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


def stop_trace() -> str:
    """Stop the trace and write it as a Chrome trace; returns its path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is being recorded")
    prof, log_dir = _trace
    _trace = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}"
                                 ".json")
    prof.export_chrome_trace(path)
    log.info("trace written: %s", path)
    return path


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
