# Copy of vri_tpu/runtime/native.py for the port; the build, the loader's
# names and the morton3d fallback differ.
"""ctypes bindings for the native host runtime (``libvri_native.so``).

The native library covers the host-side ingest hot loops: triangulation,
vertex dedup / quantization, Morton ordering, QEM simplification and the
``.usdc`` crate reader.  Every entry point has a numpy fallback.

The port builds its own copy of the library with ``g++`` from the
repository's ``native/src/*.cpp`` into ``vri_tpu_torch/_build/``, under a
name that carries a digest of the sources and flags.  The build and the
load hold an exclusive ``flock`` on a lock file in that directory, and the
library is written to a temporary file that is renamed into place, so
processes that start together never load a half-written file.  The port
never reads or writes ``native/libvri_native.so``.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("vri_tpu_torch")

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(os.path.dirname(_PKG), "native", "src")
BUILD_DIR = os.path.join(_PKG, "_build")
LOCK_NAME = ".libvri_native.lock"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-fno-exceptions", "-Wall",
             "-shared")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _sources() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))


def lib_path() -> str:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libvri_native_{h.hexdigest()[:16]}.so")


class _Locked:
    """Exclusive ``flock`` on the build directory's lock file."""

    def __enter__(self):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._f = open(os.path.join(BUILD_DIR, LOCK_NAME), "a")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()


def _build(path: str) -> bool:
    srcs = _sources()
    if not srcs:
        log.warning("native sources missing under %s; using numpy "
                    "fallbacks", SRC_DIR)
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        *srcs], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, path)
        return True
    except Exception as e:  # noqa: BLE001
        log.warning("native build failed (%s); using numpy fallbacks", e)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first if missing, both under the lock; None
    (for the life of the process) when it cannot be built or loaded.  Its
    name carries the digest of its sources, so a library of older sources
    is never found under it."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = lib_path()
    with _Locked():
        if not os.path.exists(path) and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.warning("native load failed (%s); using numpy fallbacks", e)
            _load_failed = True
            return None
    i64, i32p, f32p = ctypes.c_int64, \
        np.ctypeslib.ndpointer(np.int32, flags="C"), \
        np.ctypeslib.ndpointer(np.float32, flags="C")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    lib.vri_abi_version.restype = ctypes.c_int32
    lib.vri_triangulate_count.restype = i64
    lib.vri_triangulate_count.argtypes = [i32p, i64]
    lib.vri_triangulate.restype = i64
    lib.vri_triangulate.argtypes = [i32p, i64, i32p, i64, i32p, i32p, i32p]
    lib.vri_dedup_vertices.restype = i64
    lib.vri_dedup_vertices.argtypes = [f32p, i64, ctypes.c_float, i32p, f32p]
    lib.vri_quantize_positions.argtypes = [f32p, i64, u16p, f32p]
    lib.vri_dequantize_positions.argtypes = [u16p, i64, f32p, f32p]
    lib.vri_morton3d.argtypes = [f32p, i64, u32p]
    lib.vri_simplify_qem.restype = i64
    lib.vri_simplify_qem.argtypes = [
        f32p, i64, i32p, i64, i64, ctypes.c_void_p, i32p, i32p, f32p]
    if lib.vri_abi_version() != 3:
        log.warning("native ABI mismatch; using numpy fallbacks")
        _load_failed = True
        return None
    _lib = lib
    return _lib


def ensure_native() -> bool:
    """Build the library if it is missing and load it, under the lock;
    returns whether it is available."""
    return _load() is not None


# ---------------------------------------------------------------------------
# API (native with numpy fallback)
# ---------------------------------------------------------------------------

def triangulate(counts: np.ndarray, indices: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fan triangulation; same contract as hydra.meshutil.triangulate."""
    lib = _load()
    counts = np.ascontiguousarray(counts, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    if lib is None:
        from vri_tpu_torch.hydra import meshutil

        return meshutil.triangulate(counts, indices)
    t = lib.vri_triangulate_count(counts, len(counts))
    tris = np.empty((t, 3), np.int32)
    face = np.empty((t,), np.int32)
    corners = np.empty((t, 3), np.int32)
    n = lib.vri_triangulate(counts, len(counts), indices, len(indices),
                            tris, face, corners)
    if n < 0:
        # malformed counts (negative / overrunning the index buffer): the
        # checked numpy path raises a proper error for the same input
        from vri_tpu_torch.hydra import meshutil

        return meshutil.triangulate(counts, indices)
    return tris, face, corners


def dedup_vertices(positions: np.ndarray, tolerance: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Weld duplicate vertices. Returns (remap (n,), positions (m,3))."""
    positions = np.ascontiguousarray(positions, np.float32)
    n = len(positions)
    lib = _load()
    if lib is None:
        if tolerance > 0:
            key = np.round(positions / tolerance).astype(np.int64)
        else:
            key = positions.view(np.int32).astype(np.int64)
        _, first, remap = np.unique(key, axis=0, return_index=True,
                                    return_inverse=True)
        # renumber in order of first appearance (match native semantics)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        remap = rank[remap].astype(np.int32)
        out = positions[np.sort(first)]
        return remap, out
    remap = np.empty((n,), np.int32)
    out = np.empty((n, 3), np.float32)
    m = lib.vri_dedup_vertices(positions, n, ctypes.c_float(tolerance),
                               remap, out)
    return remap, out[:m].copy()


def quantize_positions(positions: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """uint16-quantize positions over their AABB -> (q (n,3) u16, aabb (2,3))."""
    positions = np.ascontiguousarray(positions, np.float32)
    n = len(positions)
    lib = _load()
    if lib is None:
        lo = positions.min(0) if n else np.zeros(3, np.float32)
        hi = positions.max(0) if n else np.zeros(3, np.float32)
        ext = np.where(hi - lo > 0, hi - lo, 1.0)
        q = np.clip(np.round((positions - lo) / ext * 65535.0), 0, 65535)
        return q.astype(np.uint16), np.stack([lo, hi]).astype(np.float32)
    q = np.empty((n, 3), np.uint16)
    aabb = np.empty((6,), np.float32)
    lib.vri_quantize_positions(positions, n, q, aabb)
    return q, aabb.reshape(2, 3).copy()


def dequantize_positions(q: np.ndarray, aabb: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(q, np.uint16)
    aabb = np.ascontiguousarray(aabb, np.float32).reshape(2, 3)
    lib = _load()
    if lib is None:
        lo, hi = aabb[0], aabb[1]
        return (lo + (q.astype(np.float32) / 65535.0) * (hi - lo)).astype(
            np.float32)
    out = np.empty((len(q), 3), np.float32)
    lib.vri_dequantize_positions(q, len(q), aabb.reshape(-1), out)
    return out


def simplify_qem(positions: np.ndarray, tris: np.ndarray, target: int,
                 lock: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """QEM edge-collapse simplification (subset placement).

    Returns (surviving source-triangle ids (m,), vertex_map (n,) mapping
    every original vertex to its surviving representative, and a
    conservative object-space max-displacement bound).  Surviving
    triangles keep their original corner ORDER with vertices remapped
    through vertex_map — per-corner primvars carry over by source
    triangle id.  The numpy fallback is grid vertex clustering (coarser
    quality, same contract; error bound = cell diagonal).
    """
    positions = np.ascontiguousarray(positions, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    nv, nt = len(positions), len(tris)
    lib = _load()
    if lib is not None and nv > 0 and nt > 0:
        out_tris = np.empty((nt,), np.int32)
        vmap = np.empty((nv,), np.int32)
        err = np.zeros((1,), np.float32)
        lock_p = None
        if lock is not None:
            lock = np.ascontiguousarray(lock, np.uint8)
            lock_p = lock.ctypes.data_as(ctypes.c_void_p)
        m = lib.vri_simplify_qem(positions, nv, tris, nt, int(target),
                                 lock_p, out_tris, vmap, err)
        if m >= 0:
            return out_tris[:m].copy(), vmap, \
                _deviation(positions, tris, vmap)
    # numpy fallback: uniform-grid vertex clustering.  Cell size is chosen
    # so the expected cluster count matches the target triangle budget.
    if nt == 0 or nv == 0:
        return (np.zeros((0,), np.int32),
                np.arange(nv, dtype=np.int32), 0.0)
    lo, hi = positions.min(0), positions.max(0)
    ext = float(np.max(hi - lo))
    if ext <= 0:
        return np.arange(nt, dtype=np.int32), \
            np.arange(nv, dtype=np.int32), 0.0
    # halve the cell until the live triangle count reaches the target
    cell = ext / 2.0
    for _ in range(20):
        key = np.floor((positions - lo) / cell).astype(np.int64)
        cid = (key[:, 0] * 73856093) ^ (key[:, 1] * 19349663) \
            ^ (key[:, 2] * 83492791)
        _, first, inv = np.unique(cid, return_index=True,
                                  return_inverse=True)
        if lock is not None and lock.any():
            # locked vertices form singleton clusters (they must survive)
            inv = inv.copy()
            locked_ids = np.nonzero(lock)[0]
            inv[locked_ids] = inv.max() + 1 + np.arange(len(locked_ids))
            first = None
        rep = np.full(inv.max() + 1, -1, np.int64)
        rep[inv[::-1]] = np.arange(nv)[::-1]       # first occurrence wins
        vmap = rep[inv].astype(np.int32)
        t = vmap[tris]
        alive = ((t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2])
                 & (t[:, 0] != t[:, 2]))
        if alive.sum() <= target or cell >= ext:
            break
        cell *= 1.6
    return (np.nonzero(alive)[0].astype(np.int32), vmap,
            _deviation(positions, tris, vmap))


def _deviation(positions: np.ndarray, tris: np.ndarray,
               vmap: np.ndarray) -> float:
    """Geometric deviation estimate of a collapse map: max NORMAL-projected
    vertex displacement.  Tangential slide along the surface (a vertex
    collapsing onto its neighbor on a flat or smoothly-curved patch) is
    visually free and must not count, or LOD selection over-penalizes
    ~10x (measured on a unit sphere: displacement bound 0.15 where true
    surface deviation is 0.012).  Not a strict Hausdorff bound — the
    selection threshold (tau ~ a pixel) absorbs the estimate's slack."""
    if len(positions) == 0 or len(tris) == 0:
        return 0.0
    a, b, c = positions[tris[:, 0]], positions[tris[:, 1]], positions[tris[:, 2]]
    fn = np.cross(b - a, c - a)                      # area-weighted normals
    vn = np.zeros_like(positions)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = vn / np.where(n > 1e-20, n, 1.0)
    d = positions - positions[vmap]
    return float(np.abs((d * vn).sum(-1)).max())


def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zeros between each bit
    (uint32 arithmetic, as ``ops/bvh.py``)."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(points01: np.ndarray) -> np.ndarray:
    """(N, 3) points in [0, 1] -> (N,) uint32 30-bit Morton codes."""
    points01 = np.ascontiguousarray(points01, np.float32)
    lib = _load()
    if lib is None:
        q = np.clip(points01 * np.float32(1024.0), 0.0,
                    1023.0).astype(np.uint32)
        return (_expand_bits_10(q[:, 0]) << 2 | _expand_bits_10(q[:, 1]) << 1
                | _expand_bits_10(q[:, 2]))
    out = np.empty((len(points01),), np.uint32)
    lib.vri_morton3d(points01, len(points01), out)
    return out
