"""Build and bind the hand-written CUDA kernels under ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``.
Every entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  The library lands in ``vri_tpu_torch/_build/`` under a name
that carries a digest of the sources and flags, so an edited source is
never served by a stale build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("raster_tiles.cu", "march_rays.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
#: compiler output of the build this process made (None when the library
#: was already built)
build_log: str | None = None


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvri_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source digest has no library yet;
    returns the library path."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed (%d):\n%s%s" % (
            proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, out)
    build_log = proc.stdout + proc.stderr
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vri_raster_tiles.restype = i
        lib.vri_raster_tiles.argtypes = [p, p, p, p, i, i, i, i, i,
                                         p, p, p, p, p]
        lib.vri_march_rays.restype = i
        lib.vri_march_rays.argtypes = [p, i, p, i, i, i, p, p, p, i,
                                       p, p, p, p, p]
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
