"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each source in :data:`SOURCES` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface,
loaded with ``ctypes``; the ``nvcc`` processes run in parallel.  Every
entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  The libraries land in ``vri_tpu_torch/_build/`` under names
that carry a digest of the flags and of every file under ``csrc/``
(shared headers included), so an edited source or header is never served
by a stale build; each library's compiler output is kept beside it
(:func:`compiler_log`).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import types

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("raster_tiles.cu", "raster_ranged.cu", "raster_prep.cu",
           "march_rays.cu", "bvh_traverse.cu", "worklist.cu",
           "worklist_grouped.cu", "sdf_emit.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
#: C entry point -> (source, argument types); every entry returns an int
_ENTRIES = {
    "vri_raster_tiles": ("raster_tiles.cu",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P]),
    "vri_raster_ranged": ("raster_ranged.cu",
                          [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P]),
    "vri_raster_prep": ("raster_prep.cu",
                        [_P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _I,
                         _F, _F, _F, _I, _I, _I, _I, _L, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P]),
    "vri_raster_prep_scratch": ("raster_prep.cu", [_I, _I, _L, _I]),
    "vri_march_rays": ("march_rays.cu",
                       [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I,
                        _P, _P, _P, _P, _P, _P]),
    "vri_march_lanes": ("march_rays.cu", [_I, _I]),
    "vri_bvh_traverse": ("bvh_traverse.cu",
                         [_P, _P, _P, _I, _P, _P, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P]),
    "vri_bvh_lanes": ("bvh_traverse.cu", [_I]),
    "vri_worklist_walk": ("worklist.cu",
                          [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                           _P, _P, _P]),
    "vri_worklist_setup": ("worklist.cu",
                           [_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P]),
    "vri_worklist_grouped": ("worklist_grouped.cu",
                             [_P, _I, _P, _I, _I, _I, _P, _P, _P]),
    "vri_sdf_emit": ("sdf_emit.cu",
                     [_P, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P,
                      _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P,
                      _P]),
}

_lib = None


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_paths() -> dict:
    """Source -> path of its built library."""
    d = _digest()
    return {s: os.path.join(BUILD_DIR, f"libvri_{s[:-3]}_{d}.so")
            for s in SOURCES}


def build() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns :func:`library_paths`."""
    paths = library_paths()
    todo = {s: p for s, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n"
                          f"{text}")
        else:
            with open(out[:-3] + ".log", "w") as f:
                f.write(text)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def compiler_log(source: str) -> str:
    """``nvcc``'s output (ptxas's registers and spills) from the build of
    ``source``'s current library, kept beside it; "" before the build."""
    path = library_paths()[source][:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library() -> types.SimpleNamespace:
    """The kernels' C entry points, by name (built on first call)."""
    global _lib
    if _lib is None:
        paths = build()
        libs = {s: ctypes.CDLL(p) for s, p in paths.items()}
        fns = {}
        for name, (src, argtypes) in _ENTRIES.items():
            fn = getattr(libs[src], name)
            fn.restype = _I
            fn.argtypes = argtypes
            fns[name] = fn
        _lib = types.SimpleNamespace(libraries=libs, **fns)
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
