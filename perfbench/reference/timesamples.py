"""A stage read at a time code, for the plain reference.

USD resolves an attribute with authored ``timeSamples`` at a numeric time
code by its samples: held at the first sample before it and at the last
after it, and in between interpolated linearly for floating-point values
(held for others); the default value answers only the Default time code.
:func:`at_time` wraps a stage so that every attribute read answers at
one time code by that rule, read here from the samples themselves; the
wrapped stage reads like the stage (``traverse``, ``prims_of_type``,
``prim_at_path``, a prim's ``get``, ``parent``, ``children``), so
``perfbench.stage_arrays.stage_arrays`` reads it unchanged.
"""

from __future__ import annotations

import bisect

import numpy as np


def value_at(samples: dict, time: float):
    """The value of ``samples`` ({time code: value}) at ``time``."""
    keys = sorted(samples)
    if time <= keys[0]:
        return samples[keys[0]]
    if time >= keys[-1]:
        return samples[keys[-1]]
    hi = bisect.bisect_right(keys, time)
    t0, t1 = keys[hi - 1], keys[hi]
    v0, v1 = np.asarray(samples[t0]), np.asarray(samples[t1])
    if v0.dtype.kind != "f" or v1.dtype.kind != "f" or v0.shape != v1.shape:
        return samples[t0]
    w = (time - t0) / (t1 - t0)
    return (v0.astype(np.float64) * (1.0 - w)
            + v1.astype(np.float64) * w).astype(v0.dtype)


class _PrimAt:
    def __init__(self, prim, time, cache):
        self._prim, self._time, self._cache = prim, time, cache

    def __getattr__(self, name):
        return getattr(self._prim, name)

    def get(self, name, default=None):
        a = self._prim.attributes.get(name)
        if a is None:
            return default
        samples = a.metadata.get("timeSamples")
        v = value_at(samples, self._time) if samples else a.value
        return default if v is None else v

    @property
    def parent(self):
        p = self._prim.parent
        return None if p is None else _wrap(p, self._time, self._cache)

    @property
    def children(self):
        return [_wrap(c, self._time, self._cache)
                for c in self._prim.children]


def _wrap(prim, time, cache):
    key = id(prim)
    if key not in cache:
        cache[key] = _PrimAt(prim, time, cache)
    return cache[key]


class _StageAt:
    def __init__(self, stage, time):
        self._stage, self._time, self._cache = stage, float(time), {}

    def traverse(self):
        return [_wrap(p, self._time, self._cache)
                for p in self._stage.traverse()]

    def prims_of_type(self, type_name: str):
        return [p for p in self.traverse() if p.type_name == type_name]

    def prim_at_path(self, path: str):
        p = self._stage.prim_at_path(path)
        return None if p is None else _wrap(p, self._time, self._cache)


def at_time(stage, time: float):
    """``stage`` with every attribute read at the time code ``time``."""
    return _StageAt(stage, time)
