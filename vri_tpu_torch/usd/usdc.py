# Copy of vri_tpu/usd/usdc.py for the port; the imports differ, and the
# library is not rebuilt when it lacks the crate entry points (its name
# carries its sources' digest, so no older build is ever loaded).
"""usdc ("crate") binary stage support — structural tier.

The reference reads crate files through full OpenUSD (Sdf_CrateFile);
this module binds the native structural reader (native/src/vri_usdc.cpp):
bootstrap + table of contents + the TOKENS string heap.  The remaining
sections (FIELDS / FIELDSETS / PATHS / SPECS) use pxr's custom integer
compression and are the next native milestone — ``Stage.open`` on a
.usdc file currently raises a *structured* UsdcUnsupported carrying the
file's version and section table, so callers can tell "real crate file,
decoder incomplete" apart from "corrupt file".
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

from vri_tpu_torch import _native as native_rt
from vri_tpu_torch.usd.usda import UsdaError


class UsdcError(UsdaError):
    pass


class UsdcUnsupported(UsdcError):
    """A well-formed crate file whose value sections we cannot decode yet."""

    def __init__(self, path: str, info: "CrateInfo"):
        self.info = info
        names = ", ".join(n for n, _, _ in info.sections)
        super().__init__(
            f"{path!r} is a usdc (crate) file v{info.version_str} with "
            f"sections [{names}]; the crate value decoder is not complete "
            "yet — export the stage as .usda text, or wait for the FIELDS/"
            "PATHS/SPECS decoders (ROADMAP P2)")


@dataclasses.dataclass
class CrateInfo:
    version: Tuple[int, int, int]
    sections: List[Tuple[str, int, int]]     # (name, start, size)
    tokens: Optional[List[str]] = None

    @property
    def version_str(self) -> str:
        return ".".join(str(v) for v in self.version)

    def section(self, name: str):
        for n, start, size in self.sections:
            if n == name:
                return start, size
        return None


class _Section(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char * 16),
                ("start", ctypes.c_uint64),
                ("size", ctypes.c_uint64)]


class _Info(ctypes.Structure):
    _fields_ = [("version", ctypes.c_uint8 * 3),
                ("n_sections", ctypes.c_longlong),
                ("sections", _Section * 64),
                ("error", ctypes.c_char * 128)]


def intcomp_decode(comp: bytes, n: int, width: int = 32):
    """pxr integer-compression decode via the native lib.  Returns an
    int32/int64 numpy array, or None on failure."""
    import numpy as np

    lib = _lib()
    if lib is None:
        return None
    if n == 0:
        return np.zeros(0, np.int32 if width == 32 else np.int64)
    buf = (ctypes.c_ubyte * max(len(comp), 1)).from_buffer_copy(
        comp or b"\x00")
    if width == 32:
        out = np.zeros(n, np.int32)
        r = lib.vri_intcomp_decode32(
            buf, len(comp), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    else:
        out = np.zeros(n, np.int64)
        r = lib.vri_intcomp_decode64(
            buf, len(comp), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    return out if r == 0 else None


def intcomp_encode(arr) -> bytes:
    import numpy as np

    lib = _lib()
    if lib is None:
        raise UsdcError("native library unavailable for usdc writing")
    arr = np.ascontiguousarray(arr, np.int32)
    cap = 64 + arr.size * 6
    out = (ctypes.c_ubyte * cap)()
    sz = lib.vri_intcomp_encode32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), arr.size, out,
        cap)
    if sz < 0:
        raise UsdcError("integer compression encode failed")
    return bytes(out)[:sz]


def fastcomp_decompress(comp: bytes, usize: int):
    """TfFastCompression (chunked LZ4) inflate.  None on failure."""
    lib = _lib()
    if lib is None:
        return None
    buf = (ctypes.c_ubyte * max(len(comp), 1)).from_buffer_copy(
        comp or b"\x00")
    out = (ctypes.c_ubyte * max(usize, 1))()
    got = lib.vri_fastcomp_decompress(buf, len(comp), out, usize)
    return bytes(out)[:got] if got == usize else None


def fastcomp_compress(data: bytes) -> bytes:
    lib = _lib()
    if lib is None:
        raise UsdcError("native library unavailable for usdc writing")
    cap = len(data) + len(data) // 100 + 256
    out = (ctypes.c_ubyte * cap)()
    sz = lib.vri_fastcomp_compress(data, len(data), out, cap)
    if sz < 0:
        raise UsdcError("LZ4 compression failed")
    return bytes(out)[:sz]


def _lib():
    lib = native_rt._load()
    if lib is None or not hasattr(lib, "vri_usdc_info"):
        return None
    lib.vri_usdc_info.restype = ctypes.c_int
    lib.vri_usdc_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_Info)]
    lib.vri_usdc_tokens.restype = ctypes.c_longlong
    lib.vri_usdc_tokens.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong]
    return lib


def is_crate(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == b"PXR-USDC"
    except OSError:
        return False


def read_info(path: str, want_tokens: bool = True) -> CrateInfo:
    """Bootstrap + TOC (+ TOKENS heap) of a crate file via the native lib."""
    lib = _lib()
    if lib is None:
        raise UsdcError("native library unavailable for usdc reading")
    info = _Info()
    if lib.vri_usdc_info(path.encode(), ctypes.byref(info)) != 0:
        raise UsdcError(
            f"{path!r}: {info.error.decode(errors='replace')}")
    sections = [
        (info.sections[i].name.decode(errors="replace").rstrip("\x00"),
         int(info.sections[i].start), int(info.sections[i].size))
        for i in range(int(info.n_sections))]
    out = CrateInfo(version=tuple(int(v) for v in info.version),
                    sections=sections)
    tok = out.section("TOKENS")
    if want_tokens and tok is not None:
        cap = max(int(tok[1]) * 8, 1 << 16)
        buf = (ctypes.c_ubyte * cap)()
        n = lib.vri_usdc_tokens(path.encode(), tok[0], tok[1],
                                out.version[1], buf, cap)
        if n >= 0:
            blob = bytes(buf)
            out.tokens = blob.split(b"\x00")[: int(n)]
            out.tokens = [t.decode(errors="replace") for t in out.tokens]
    return out


def open_crate(path: str):
    """Entry point used by Stage.open for .usdc files.

    Decodes the crate value layer (usd/crate.py) and returns a composed
    Stage; decode warnings (unsupported value types) are logged, never
    silent.  A corrupt file raises UsdcError.
    """
    import logging
    import os

    from vri_tpu_torch.usd import crate
    from vri_tpu_torch.usd.stage import Stage

    root, meta, warnings = crate.read_crate(path)
    for w in warnings:
        logging.getLogger("vri_tpu").warning("usdc %s: %s", path, w)
    stage = Stage(root, meta, anchor=os.path.dirname(os.path.abspath(path)))
    return stage


def write_crate(stage, path: str) -> None:
    """Serialize a Stage to .usdc (usd/crate.py writer)."""
    from vri_tpu_torch.usd import crate

    crate.write_crate(stage, path)
