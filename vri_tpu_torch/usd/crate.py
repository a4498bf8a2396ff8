# Copy of vri_tpu/usd/crate.py for the port; only the imports differ.
"""usdc ("crate") binary stage reader + writer — value tier.

The reference opens crate stages through full OpenUSD (``UsdStage::Open``,
Source/Main.cpp:33; format implementation pxr/usd/sdf/crateFile.cpp).  This
module implements the crate format natively for the USD-lite stack:

* the **reader** decodes FIELDS / FIELDSETS / PATHS / SPECS (pxr integer
  compression + LZ4, decoded by native/src/vri_usdc.cpp) and the common
  value representations — inlined scalars, out-of-line scalars, arrays
  (raw and integer-compressed), token/string/asset indices, timeSamples
  records — and builds the same ``Stage``/``Prim`` model the USDA parser
  produces, so everything downstream (delegate sync, rendering) is format
  agnostic.
* the **writer** emits a well-formed crate file (version 0.8.0 layout)
  for any stage this stack can represent, exercising the same codecs in
  reverse; ``.usda`` <-> ``.usdc`` round-trips are bit-exact at the value
  level (tests/test_usdc.py).

Format notes (layouts implemented from the public crate format as shipped
in pxr/usd/sdf/crateFile.cpp, crateDataTypes.h and usd/integerCoding.cpp;
no pxr code is used):

* ValueRep: u64 with bit 63 = isArray, 62 = isInlined, 61 = isCompressed,
  bits 48-55 = type enum, bits 0-47 = payload (inline value or offset).
* PATHS: three integer-compressed streams (pathIndexes,
  elementTokenIndexes, jumps) encoding a preorder DFS of the namespace;
  negative element token index marks a property path; jump semantics:
  -2 leaf, -1 child-only, 0 sibling-only, >0 child + sibling at i+jump.
* SPECS: three integer-compressed streams (pathIndexes, fieldSetIndexes,
  specTypes).
* FIELDSETS: one integer-compressed stream of field indexes, runs
  terminated by -1.
* Arrays: payload -> element count (u64 for file version >= 0.7.0, u32
  before) followed by raw elements, or integer-compressed data when the
  rep's compressed bit is set.
* TimeSamples: payload -> times ValueRep (8 B) + u64 offset of the values
  record (u64 count + count ValueReps).  A direct [count][reps] layout is
  also accepted on read.
* Dictionary: payload -> u64 count, then per entry [u32 string index
  (key)][i64 value-record size][value record].  The value record is a
  single 8-byte ValueRep (its payload, when out-of-line, is an absolute
  file offset like every other rep); the i64 size lets a reader skip
  entries whose rep type it cannot decode.
* ListOps (Token/String/Path/Int/Int64/UInt/UInt64/Reference/Payload):
  payload -> u8 flag byte (1 = explicit, then presence bits for
  explicitItems/added/prepended/appended/deleted/ordered), then each
  present list as [u64 count][items].  Items: u32 token index (token),
  u32 string index (string), u32 path index (path), raw ints, or — for
  references — [u32 string index asset][u32 path index prim path,
  0xFFFFFFFF = empty][f64 layer offset][f64 layer scale][inline
  dictionary record customData]; payloads are the same minus customData.

Anything outside the implemented set (unregistered values, variant
selection maps) surfaces as a structured warning on the stage — never a
silent drop and never a parse abort.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from vri_tpu_torch.usd import usda as usda_mod
from vri_tpu_torch.usd.usda import (AssetPath, Attribute, Prim, PrimPathRef,
                              Reference)

log = logging.getLogger("vri_tpu")


class CrateError(usda_mod.UsdaError):
    pass


# -- ValueRep ---------------------------------------------------------------

ARRAY_BIT = 1 << 63
INLINED_BIT = 1 << 62
COMPRESSED_BIT = 1 << 61
PAYLOAD_MASK = (1 << 48) - 1


class Ty:
    """Crate type enums (pxr/usd/sdf/crateDataTypes.h numbering)."""

    Bool = 1
    UChar = 2
    Int = 3
    UInt = 4
    Int64 = 5
    UInt64 = 6
    Half = 7
    Float = 8
    Double = 9
    String = 10
    Token = 11
    AssetPath = 12
    Matrix2d = 13
    Matrix3d = 14
    Matrix4d = 15
    Quatd = 16
    Quatf = 17
    Quath = 18
    Vec2d = 19
    Vec2f = 20
    Vec2h = 21
    Vec2i = 22
    Vec3d = 23
    Vec3f = 24
    Vec3h = 25
    Vec3i = 26
    Vec4d = 27
    Vec4f = 28
    Vec4h = 29
    Vec4i = 30
    Dictionary = 31
    TokenListOp = 32
    StringListOp = 33
    PathListOp = 34
    ReferenceListOp = 35
    IntListOp = 36
    Int64ListOp = 37
    UIntListOp = 38
    UInt64ListOp = 39
    PathVector = 40
    TokenVector = 41
    Specifier = 42
    Permission = 43
    Variability = 44
    VariantSelectionMap = 45
    TimeSamples = 46
    Payload = 47
    DoubleVector = 48
    LayerOffsetVector = 49
    StringVector = 50
    ValueBlock = 51
    Value = 52
    UnregisteredValue = 53
    UnregisteredValueListOp = 54
    PayloadListOp = 55


# numeric scalar/vector types: (numpy dtype, component count)
_NUMERIC: Dict[int, Tuple[np.dtype, int]] = {
    Ty.Bool: (np.dtype(np.uint8), 1),
    Ty.UChar: (np.dtype(np.uint8), 1),
    Ty.Int: (np.dtype(np.int32), 1),
    Ty.UInt: (np.dtype(np.uint32), 1),
    Ty.Int64: (np.dtype(np.int64), 1),
    Ty.UInt64: (np.dtype(np.uint64), 1),
    Ty.Half: (np.dtype(np.float16), 1),
    Ty.Float: (np.dtype(np.float32), 1),
    Ty.Double: (np.dtype(np.float64), 1),
    Ty.Matrix2d: (np.dtype(np.float64), 4),
    Ty.Matrix3d: (np.dtype(np.float64), 9),
    Ty.Matrix4d: (np.dtype(np.float64), 16),
    Ty.Quatd: (np.dtype(np.float64), 4),
    Ty.Quatf: (np.dtype(np.float32), 4),
    Ty.Quath: (np.dtype(np.float16), 4),
    Ty.Vec2d: (np.dtype(np.float64), 2),
    Ty.Vec2f: (np.dtype(np.float32), 2),
    Ty.Vec2h: (np.dtype(np.float16), 2),
    Ty.Vec2i: (np.dtype(np.int32), 2),
    Ty.Vec3d: (np.dtype(np.float64), 3),
    Ty.Vec3f: (np.dtype(np.float32), 3),
    Ty.Vec3h: (np.dtype(np.float16), 3),
    Ty.Vec3i: (np.dtype(np.int32), 3),
    Ty.Vec4d: (np.dtype(np.float64), 4),
    Ty.Vec4f: (np.dtype(np.float32), 4),
    Ty.Vec4h: (np.dtype(np.float16), 4),
    Ty.Vec4i: (np.dtype(np.int32), 4),
}

# SdfSpecType values
SPEC_ATTRIBUTE = 1
SPEC_PRIM = 6
SPEC_PSEUDO_ROOT = 7
SPEC_RELATIONSHIP = 8

_SPECIFIERS = {0: "def", 1: "over", 2: "class"}
_SPECIFIER_IDS = {v: k for k, v in _SPECIFIERS.items()}


def _rep(ty: int, payload: int, array=False, inlined=False,
         compressed=False) -> int:
    r = ((ty & 0xFF) << 48) | (payload & PAYLOAD_MASK)
    if array:
        r |= ARRAY_BIT
    if inlined:
        r |= INLINED_BIT
    if compressed:
        r |= COMPRESSED_BIT
    return r


# ===========================================================================
# Reader
# ===========================================================================

class CrateReader:
    """Decode a crate file into (paths, specs, fields) and python values."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:8] != b"PXR-USDC":
            raise CrateError(f"{path!r}: not a usdc file")
        self.version = tuple(self.data[8:11])
        (toc_off,) = struct.unpack_from("<Q", self.data, 16)
        (n_sec,) = struct.unpack_from("<Q", self.data, toc_off)
        if n_sec > 64:
            raise CrateError(f"{path!r}: implausible TOC ({n_sec} sections)")
        self.sections: Dict[str, Tuple[int, int]] = {}
        for i in range(n_sec):
            name, start, size = struct.unpack_from(
                "<16sQQ", self.data, toc_off + 8 + 32 * i)
            self.sections[name.split(b"\x00")[0].decode()] = (start, size)
        self.warnings: List[str] = []
        self._load_tokens()
        self._load_strings()
        self._load_fields()
        self._load_fieldsets()
        self._load_paths()
        self._load_specs()

    # -- section primitives -------------------------------------------------

    def _need(self, name: str) -> Tuple[int, int]:
        if name not in self.sections:
            raise CrateError(f"{self.path!r}: missing section {name}")
        return self.sections[name]

    def _u64(self, off: int) -> Tuple[int, int]:
        (v,) = struct.unpack_from("<Q", self.data, off)
        return v, off + 8

    def _compressed_ints(self, off: int, n: int, width: int = 32
                         ) -> Tuple[np.ndarray, int]:
        """[u64 compressedSize][buffer] -> n ints (native decoder)."""
        from vri_tpu_torch.usd import usdc as usdc_mod

        sz, off = self._u64(off)
        if off + sz > len(self.data):
            raise CrateError(f"{self.path!r}: compressed ints overrun")
        out = usdc_mod.intcomp_decode(self.data[off:off + sz], n, width)
        if out is None:
            raise CrateError(f"{self.path!r}: integer decompression failed "
                             f"(n={n}, width={width})")
        return out, off + sz

    def _lz4_block(self, off: int, csize: int, usize: int) -> bytes:
        from vri_tpu_torch.usd import usdc as usdc_mod

        out = usdc_mod.fastcomp_decompress(self.data[off:off + csize], usize)
        if out is None:
            raise CrateError(f"{self.path!r}: LZ4 payload failed to inflate")
        return out

    # -- sections -----------------------------------------------------------

    def _load_tokens(self):
        start, size = self._need("TOKENS")
        n, off = self._u64(start)
        if self.version[1] >= 4:
            usize, off = self._u64(off)
            csize, off = self._u64(off)
            blob = self._lz4_block(off, csize, usize)
        else:
            blob = self.data[start + 8:start + size]
        toks = blob.split(b"\x00")
        self.tokens = [t.decode("utf-8", errors="replace")
                       for t in toks[:n]]
        if len(self.tokens) != n:
            raise CrateError(f"{self.path!r}: token heap holds "
                             f"{len(self.tokens)} of {n} tokens")

    def _load_strings(self):
        self.strings = np.zeros(0, np.int64)
        if "STRINGS" not in self.sections:
            return
        start, _ = self.sections["STRINGS"]
        n, off = self._u64(start)
        self.strings = np.frombuffer(self.data, np.uint32, n, off)

    def _load_fields(self):
        start, _ = self._need("FIELDS")
        n, off = self._u64(start)
        idx, off = self._compressed_ints(off, n)
        reps_sz, off = self._u64(off)
        blob = self._lz4_block(off, reps_sz, n * 8)
        reps = np.frombuffer(blob, np.uint64, n)
        self.field_tokens = idx.astype(np.int64)
        self.field_reps = reps

    def _load_fieldsets(self):
        start, _ = self._need("FIELDSETS")
        n, off = self._u64(start)
        fs, _ = self._compressed_ints(off, n)
        self.fieldsets = fs.astype(np.int64)   # -1 terminates runs

    def _load_paths(self):
        start, _ = self._need("PATHS")
        n_paths, off = self._u64(start)
        n_enc, off = self._u64(off)
        path_idx, off = self._compressed_ints(off, n_enc)
        elem_tok, off = self._compressed_ints(off, n_enc)
        jumps, off = self._compressed_ints(off, n_enc)
        self.paths: List[Optional[str]] = [None] * n_paths
        self._build_paths(path_idx, elem_tok, jumps)

    def _build_paths(self, path_idx, elem_tok, jumps):
        """Iterative preorder DFS decode (recursion-free: real stages nest
        deeply).  Mirrors pxr's jump semantics exactly."""
        n = len(path_idx)
        if n == 0:
            return
        stack: List[Tuple[int, str]] = [(0, "")]     # (index, parent path)
        while stack:
            cur, parent = stack.pop()
            while True:
                this = cur
                cur += 1
                if parent == "":
                    me = "/"
                else:
                    tok = int(elem_tok[this])
                    name = self.tokens[abs(tok)]
                    if tok < 0:         # property path
                        me = f"{parent}.{name}"
                    elif parent == "/":
                        me = f"/{name}"
                    else:
                        me = f"{parent}/{name}"
                pi = int(path_idx[this])
                if 0 <= pi < len(self.paths):
                    self.paths[pi] = me
                j = int(jumps[this])
                has_child = j > 0 or j == -1
                has_sibling = j >= 0
                if has_child:
                    if has_sibling and this + j < n:
                        stack.append((this + j, parent))
                    parent = me          # descend
                elif has_sibling:
                    pass                 # next iteration is the sibling
                else:
                    break                # leaf, run ends
                if cur >= n:
                    break

    def _load_specs(self):
        start, _ = self._need("SPECS")
        n, off = self._u64(start)
        p, off = self._compressed_ints(off, n)
        fs, off = self._compressed_ints(off, n)
        st, off = self._compressed_ints(off, n)
        self.spec_paths = p.astype(np.int64)
        self.spec_fsets = fs.astype(np.int64)
        self.spec_types = st.astype(np.int64)

    # -- value unpack -------------------------------------------------------

    def fields_of(self, fset: int) -> List[Tuple[str, int]]:
        """Field-set run starting at ``fset``: [(field name, rep), ...]."""
        out = []
        i = fset
        while i < len(self.fieldsets) and self.fieldsets[i] != -1 \
                and np.uint32(self.fieldsets[i]) != np.uint32(0xFFFFFFFF):
            f = int(self.fieldsets[i])
            out.append((self.tokens[int(self.field_tokens[f])],
                        int(self.field_reps[f])))
            i += 1
        return out

    def _count_at(self, off: int) -> Tuple[int, int]:
        if self.version >= (0, 7, 0):
            return self._u64(off)
        (v,) = struct.unpack_from("<I", self.data, off)
        return v, off + 4

    def unpack(self, rep: int) -> Any:
        ty = (rep >> 48) & 0xFF
        payload = rep & PAYLOAD_MASK
        inlined = bool(rep & INLINED_BIT)
        array = bool(rep & ARRAY_BIT)
        compressed = bool(rep & COMPRESSED_BIT)

        if array:
            return self._unpack_array(ty, payload, compressed)
        if ty == Ty.Token or ty == Ty.AssetPath:
            tok = self.tokens[payload & 0xFFFFFFFF]
            return AssetPath(tok) if ty == Ty.AssetPath else tok
        if ty == Ty.String:
            return self.tokens[int(self.strings[payload & 0xFFFFFFFF])]
        if ty == Ty.Specifier:
            return _SPECIFIERS.get(payload & 0xFFFFFFFF, "def")
        if ty in (Ty.Permission, Ty.Variability):
            return int(payload & 0xFFFFFFFF)
        if ty == Ty.ValueBlock:
            return None
        if ty == Ty.Bool:
            return bool(payload & 1)
        if ty in (Ty.Int, Ty.UInt, Ty.Int64, Ty.UInt64, Ty.UChar,
                  Ty.Half, Ty.Float, Ty.Double):
            return self._unpack_scalar(ty, payload, inlined)
        if ty in _NUMERIC:               # vectors / matrices / quats
            return self._unpack_vec(ty, payload, inlined)
        if ty == Ty.TimeSamples:
            return self._unpack_time_samples(payload)
        if ty == Ty.PathListOp:
            return self._unpack_path_list_op(payload)
        if ty == Ty.TokenVector:
            return self._unpack_token_vector(payload)
        if ty == Ty.DoubleVector:
            n, off = self._count_at(payload)
            return np.frombuffer(self.data, np.float64, n, off).copy()
        if ty == Ty.StringVector:
            n, off = self._count_at(payload)
            idx = np.frombuffer(self.data, np.uint32, n, off)
            return [self.tokens[int(self.strings[i])] for i in idx]
        if ty == Ty.TokenListOp:
            return self._unpack_token_list_op(payload)
        if ty == Ty.StringListOp:
            return self._unpack_list_op(payload, "string")
        if ty == Ty.ReferenceListOp:
            return self._unpack_list_op(payload, "reference")
        if ty == Ty.PayloadListOp:
            return self._unpack_list_op(payload, "payload")
        if ty == Ty.IntListOp:
            return self._unpack_list_op(payload, "int")
        if ty == Ty.Int64ListOp:
            return self._unpack_list_op(payload, "int64")
        if ty == Ty.UIntListOp:
            return self._unpack_list_op(payload, "uint")
        if ty == Ty.UInt64ListOp:
            return self._unpack_list_op(payload, "uint64")
        if ty == Ty.Dictionary:
            d, _ = self._read_dict_at(payload)
            return d
        self.warnings.append(f"unsupported crate value type {ty}")
        return None

    def _unpack_scalar(self, ty: int, payload: int, inlined: bool):
        dt, _ = _NUMERIC[ty]
        if inlined:
            raw = struct.pack("<q", payload)[:4]
            if ty == Ty.Double:
                # doubles inline as their float32 image
                return float(np.frombuffer(raw, np.float32, 1)[0])
            if ty == Ty.Half:
                return float(np.frombuffer(raw, np.float16, 1)[0])
            if ty in (Ty.Int64, Ty.UInt64):
                v = np.frombuffer(raw, np.int32, 1)[0]
                return int(v)
            return dt.type(np.frombuffer(raw, dt if dt.itemsize <= 4
                                         else np.int32, 1)[0]).item()
        v = np.frombuffer(self.data, dt, 1, payload)[0]
        return v.item()

    def _unpack_vec(self, ty: int, payload: int, inlined: bool):
        dt, comps = _NUMERIC[ty]
        if inlined:
            if ty in (Ty.Matrix2d, Ty.Matrix3d, Ty.Matrix4d):
                # inlined matrices pack the diagonal as int8s
                dim = {Ty.Matrix2d: 2, Ty.Matrix3d: 3, Ty.Matrix4d: 4}[ty]
                raw = np.frombuffer(struct.pack("<q", payload), np.int8, dim)
                m = np.zeros((dim, dim), np.float64)
                np.fill_diagonal(m, raw.astype(np.float64))
                return m
            raw = np.frombuffer(struct.pack("<q", payload), np.int8, comps)
            return raw.astype(dt)
        out = np.frombuffer(self.data, dt, comps, payload).copy()
        if ty in (Ty.Matrix2d, Ty.Matrix3d, Ty.Matrix4d):
            dim = {Ty.Matrix2d: 2, Ty.Matrix3d: 3, Ty.Matrix4d: 4}[ty]
            return out.reshape(dim, dim)
        return out

    def _unpack_array(self, ty: int, payload: int, compressed: bool):
        from vri_tpu_torch.usd import usdc as usdc_mod

        if ty in (Ty.Token, Ty.AssetPath, Ty.String):
            n, off = self._count_at(payload)
            idx = np.frombuffer(self.data, np.uint32, n, off)
            if ty == Ty.String:
                return [self.tokens[int(self.strings[i])] for i in idx]
            toks = [self.tokens[int(i)] for i in idx]
            return [AssetPath(t) for t in toks] if ty == Ty.AssetPath \
                else toks
        if ty not in _NUMERIC:
            self.warnings.append(f"unsupported crate array type {ty}")
            return None
        dt, comps = _NUMERIC[ty]
        n, off = self._count_at(payload)
        if compressed:
            if ty in (Ty.Int, Ty.UInt, Ty.Int64, Ty.UInt64):
                sz, off = self._u64(off)
                width = 64 if ty in (Ty.Int64, Ty.UInt64) else 32
                out = usdc_mod.intcomp_decode(
                    self.data[off:off + sz], n, width)
                if out is None:
                    raise CrateError(
                        f"{self.path!r}: compressed int array failed")
                return out.astype(dt)
            if ty in (Ty.Float, Ty.Double, Ty.Half):
                code = self.data[off:off + 1]
                off += 1
                if code == b"i":
                    sz, off = self._u64(off)
                    out = usdc_mod.intcomp_decode(
                        self.data[off:off + sz], n, 32)
                    if out is None:
                        raise CrateError(
                            f"{self.path!r}: compressed float array ('i')")
                    return out.astype(dt)
                if code == b"t":
                    (n_lut,) = struct.unpack_from("<I", self.data, off)
                    off += 4
                    lut = np.frombuffer(self.data, dt, n_lut, off)
                    off += n_lut * dt.itemsize
                    sz, off = self._u64(off)
                    idx = usdc_mod.intcomp_decode(
                        self.data[off:off + sz], n, 32)
                    if idx is None:
                        raise CrateError(
                            f"{self.path!r}: compressed float array ('t')")
                    return lut[idx].copy()
                raise CrateError(
                    f"{self.path!r}: unknown float-array code {code!r}")
            self.warnings.append(
                f"compressed array of crate type {ty} unsupported")
            return None
        total = n * comps
        out = np.frombuffer(self.data, dt, total, off).copy()
        return out.reshape(n, comps) if comps > 1 else out

    def _unpack_time_samples(self, payload: int):
        """[times ValueRep][u64 values offset -> u64 count + reps]; also
        accepts the direct [times rep][u64 count][reps] layout."""
        times_rep, off = self._u64(payload)
        times = self.unpack(int(times_rep))
        if times is None:
            self.warnings.append("timeSamples: times vector failed")
            return None
        times = np.asarray(times, np.float64).reshape(-1)
        v0, off2 = self._u64(off)
        candidates = []
        if 0 < v0 < len(self.data):          # v0 = offset of [count][reps]
            candidates.append(self._count_at(v0))
        candidates.append((v0, off2))        # direct [count][reps] layout
        for n, roff in candidates:
            if n == len(times) and roff + 8 * n <= len(self.data):
                reps = np.frombuffer(self.data, np.uint64, n, roff)
                return {float(t): self.unpack(int(r))
                        for t, r in zip(times, reps)}
        self.warnings.append("timeSamples record failed to parse")
        return None

    def _unpack_token_vector(self, payload: int):
        n, off = self._count_at(payload)
        idx = np.frombuffer(self.data, np.uint32, n, off)
        return [self.tokens[int(i)] for i in idx]

    _LIST_INT = {"int": ("<i", 4), "uint": ("<I", 4),
                 "int64": ("<q", 8), "uint64": ("<Q", 8)}

    def _read_dict_at(self, off: int):
        """Dictionary record at ``off`` -> (dict, offset past it).  Each
        entry carries an i64 value-record size so unknown value types are
        skipped, not fatal (mirrors pxr's recursive-skip design)."""
        n, off = self._u64(off)
        out: Dict[str, Any] = {}
        if n > 1 << 20 or off + 16 * n > len(self.data):
            self.warnings.append("dictionary record implausible; skipped")
            return out, off
        for _ in range(n):
            (si,) = struct.unpack_from("<I", self.data, off)
            (size,) = struct.unpack_from("<q", self.data, off + 4)
            off += 12
            key = (self.tokens[int(self.strings[si])]
                   if si < len(self.strings) else None)
            if size < 8 or off + size > len(self.data):
                self.warnings.append(f"dictionary entry {key!r} malformed")
                return out, off
            (vrep,) = struct.unpack_from("<Q", self.data, off)
            if key is not None:
                out[key] = self.unpack(int(vrep))
            off += size
        return out, off

    def _string_at(self, idx: int) -> str:
        return (self.tokens[int(self.strings[idx])]
                if idx < len(self.strings) else "")

    def _list_op_items(self, off: int, item: str):
        n, off = self._u64(off)
        out = []
        for _ in range(n):
            if item == "path":
                (pi,) = struct.unpack_from("<I", self.data, off)
                off += 4
                out.append(self.paths[pi] if pi < len(self.paths) else None)
            elif item == "string":
                (si,) = struct.unpack_from("<I", self.data, off)
                off += 4
                out.append(self._string_at(si))
            elif item in self._LIST_INT:
                fmt, w = self._LIST_INT[item]
                (v,) = struct.unpack_from(fmt, self.data, off)
                off += w
                out.append(int(v))
            elif item in ("reference", "payload"):
                si, pi = struct.unpack_from("<II", self.data, off)
                l_off, l_scale = struct.unpack_from("<dd", self.data,
                                                    off + 8)
                off += 24
                if item == "reference":
                    custom, off = self._read_dict_at(off)
                else:
                    custom = {}
                asset = self._string_at(si)
                prim_path = (self.paths[pi]
                             if pi < len(self.paths) else "") or ""
                if l_off != 0.0 or l_scale != 1.0:
                    self.warnings.append(
                        f"layer offset ({l_off}, {l_scale}) on arc to "
                        f"{asset or prim_path!r} ignored (not modeled)")
                if asset:
                    out.append(Reference(asset, prim_path))
                elif prim_path:
                    out.append(PrimPathRef(prim_path))
                if custom:
                    log.debug("crate: arc customData %s ignored", custom)
            else:  # token
                (ti,) = struct.unpack_from("<I", self.data, off)
                off += 4
                out.append(self.tokens[ti])
        return out, off

    def _unpack_list_op(self, payload: int, item: str):
        """ListOp: u8 flag byte (explicit | per-list presence bits), then
        each present list as [u64 count][items]."""
        h = self.data[payload]
        off = payload + 1
        out = {"explicit": bool(h & 1)}
        for bit, name in ((2, "explicitItems"), (4, "added"),
                          (8, "prepended"), (16, "appended"),
                          (32, "deleted"), (64, "ordered")):
            if h & bit:
                items, off = self._list_op_items(off, item)
                out[name] = items
        return out

    def _unpack_path_list_op(self, payload: int):
        return self._unpack_list_op(payload, "path")

    def _unpack_token_list_op(self, payload: int):
        return self._unpack_list_op(payload, "token")


def _list_op_targets(op) -> List[str]:
    if not isinstance(op, dict):
        return []
    for k in ("explicitItems", "appended", "prepended", "added"):
        if op.get(k):
            return [p for p in op[k] if p]
    return []


def _is_list_op(v) -> bool:
    return isinstance(v, dict) and "explicit" in v and not (
        set(v) - {"explicit", "explicitItems", "added", "prepended",
                  "appended", "deleted", "ordered"})


def _list_op_effective(op: dict) -> List[Any]:
    """Apply a decoded ListOp over an empty weaker list: explicitItems when
    explicit, else prepended + added + appended — the single-layer-stack
    evaluation SdfListOp::ApplyOperations does.  ``deleted`` applies only
    to the WEAKER (base) list, which is empty here, so it never filters
    the layer's own prepend/add/append items (pxr semantics: a layer
    authoring both append and delete of one item still appends it —
    ADVICE r4); it is retained in the decoded record for any future
    multi-layer composition."""
    if op.get("explicit"):
        items = list(op.get("explicitItems") or [])
    else:
        items = (list(op.get("prepended") or []) + list(op.get("added") or [])
                 + list(op.get("appended") or []))
    return [x for x in items if x is not None]


# prim-metadata keys that carry composition-arc list ops; decoded list-op
# records become the plain ordered lists the Stage composer consumes
_ARC_LIST_KEYS = ("references", "payload", "payloads", "inherits",
                  "specializes", "inheritPaths", "specializesPaths")
_ARC_KEY_ALIASES = {"inheritPaths": "inherits",
                    "specializesPaths": "specializes"}


def read_crate(path: str):
    """Open a crate file -> (root Prim, stage metadata, warnings)."""
    r = CrateReader(path)

    # group specs by path
    prims: Dict[str, Prim] = {}
    root = Prim(name="")
    prims["/"] = root
    meta: Dict[str, Any] = {}

    order = np.argsort(r.spec_paths, kind="stable")

    # prim specs first (so properties can attach), in path order
    prim_specs, prop_specs = [], []
    for s in order:
        st = int(r.spec_types[s])
        if st in (SPEC_PRIM, SPEC_PSEUDO_ROOT):
            prim_specs.append(int(s))
        else:
            prop_specs.append(int(s))

    def ensure_prim(p: str) -> Prim:
        if p in prims:
            return prims[p]
        parent = ensure_prim(p.rsplit("/", 1)[0] or "/")
        prim = Prim(name=p.rsplit("/", 1)[1], parent=parent)
        parent.children.append(prim)
        prims[p] = prim
        return prim

    for s in prim_specs:
        p = r.paths[int(r.spec_paths[s])]
        if p is None:
            continue
        fields = r.fields_of(int(r.spec_fsets[s]))
        if int(r.spec_types[s]) == SPEC_PSEUDO_ROOT or p == "/":
            for name, rep in fields:
                v = r.unpack(rep)
                if name == "subLayers":
                    meta["subLayers"] = [str(x) for x in (v or [])]
                elif v is not None:
                    meta[name] = v
            continue
        prim = ensure_prim(p)
        for name, rep in fields:
            v = r.unpack(rep)
            if name == "specifier":
                prim.specifier = v
            elif name == "typeName":
                prim.type_name = v or ""
            elif name == "primChildren" or name == "properties":
                pass                     # ordering hints; tree has them
            elif v is not None:
                if name in _ARC_LIST_KEYS and _is_list_op(v):
                    v = _list_op_effective(v)
                    if not v:
                        continue
                    name = _ARC_KEY_ALIASES.get(name, name)
                prim.metadata[name] = v

    for s in prop_specs:
        p = r.paths[int(r.spec_paths[s])]
        if p is None or "." not in p:
            continue
        prim_path, attr_name = p.rsplit(".", 1)
        prim = ensure_prim(prim_path if prim_path else "/")
        fields = dict(r.fields_of(int(r.spec_fsets[s])))
        a = Attribute(name=attr_name)
        st = int(r.spec_types[s])
        if st == SPEC_RELATIONSHIP:
            a.type_name = "rel"
            op = r.unpack(fields["targetPaths"]) \
                if "targetPaths" in fields else None
            tg = _list_op_targets(op)
            if tg:
                a.value = PrimPathRef(tg[0])
        else:
            for name, rep in fields.items():
                if name == "default":
                    a.value = r.unpack(rep)
                elif name == "typeName":
                    a.type_name = str(r.unpack(rep))
                elif name == "variability":
                    a.uniform = r.unpack(rep) == 1
                elif name == "custom":
                    a.custom = bool(r.unpack(rep))
                elif name == "timeSamples":
                    ts = r.unpack(rep)
                    if ts is not None:
                        a.metadata["timeSamples"] = ts
                elif name == "connectionPaths":
                    tg = _list_op_targets(r.unpack(rep))
                    if tg:
                        a.connect = tg[0]
                else:
                    v = r.unpack(rep)
                    if v is not None:
                        a.metadata[name] = v
        prim.attributes[a.name] = a

    return root, meta, r.warnings


# ===========================================================================
# Writer
# ===========================================================================

_WRITE_VERSION = (0, 8, 0)


class _Pool:
    """Dedup pool assigning dense indices."""

    def __init__(self):
        self.items: List[Any] = []
        self.index: Dict[Any, int] = {}

    def add(self, item) -> int:
        i = self.index.get(item)
        if i is None:
            i = len(self.items)
            self.index[item] = i
            self.items.append(item)
        return i


class CrateWriter:
    def __init__(self):
        self.tokens = _Pool()
        self.tokens.add("")              # index 0 reserved: property-path
                                         # element tokens are stored negated
        self.strings = _Pool()           # -> token index
        self.fields = _Pool()            # (token idx, rep) pairs
        self.fieldsets: List[int] = []
        self.paths = _Pool()             # path string -> PathIndex
        self.specs: List[Tuple[int, int, int]] = []
        self.body = bytearray(b"\x00" * 88)   # bootstrap patched at end

    # -- payload helpers ----------------------------------------------------

    def _align(self, n: int = 8):
        while len(self.body) % n:
            self.body += b"\x00"

    def _write_payload(self, blob: bytes) -> int:
        self._align()
        off = len(self.body)
        self.body += blob
        return off

    def _string_idx(self, s: str) -> int:
        return self.strings.add(self.tokens.add(s))

    # -- value packing ------------------------------------------------------

    def pack_value(self, value, type_name: str) -> int:
        """Python value + sdf type name -> ValueRep (payload written)."""
        base = type_name.rstrip("[]").strip()
        is_array = type_name.endswith("[]")
        ty = _SDF_TO_TY.get(base)
        if isinstance(value, dict):
            return self.pack_dictionary(value)
        if isinstance(value, AssetPath):
            return _rep(Ty.AssetPath, self.tokens.add(value.path),
                        inlined=True)
        if isinstance(value, PrimPathRef):
            raise CrateError("PrimPathRef packs via relationship specs")
        if isinstance(value, str) and ty in (None, Ty.Token, Ty.String):
            if ty == Ty.String or base == "string":
                return _rep(Ty.String, self._string_idx(value), inlined=True)
            return _rep(Ty.Token, self.tokens.add(value), inlined=True)
        if isinstance(value, bool):
            return _rep(Ty.Bool, int(value), inlined=True)
        if is_array:
            return self._pack_array(value, base, ty)
        if ty is None and isinstance(value, (list, np.ndarray)):
            # untyped sequence metadata: shape decides scalar-vec vs array
            arr = np.asarray(value)
            if arr.ndim == 1 and arr.size in (2, 3, 4):
                ty = {2: Ty.Vec2d, 3: Ty.Vec3d, 4: Ty.Vec4d}[arr.size]
            else:
                return self._pack_array(arr.reshape(-1), "double", Ty.Double)
        if ty is None:
            # fall back on python type
            if isinstance(value, float):
                ty = Ty.Double
            elif isinstance(value, int):
                ty = Ty.Int
            else:
                raise CrateError(
                    f"cannot pack {type(value).__name__} as {type_name!r}")
        return self._pack_scalar(value, ty)

    def _pack_scalar(self, value, ty: int) -> int:
        dt, comps = _NUMERIC[ty]
        if comps == 1:
            if ty == Ty.Int and -2**31 <= int(value) < 2**31:
                return _rep(ty, int(np.int64(np.uint32(np.int32(value)))),
                            inlined=True)
            if ty == Ty.Float:
                bits = int(np.frombuffer(
                    np.float32(value).tobytes(), np.uint32)[0])
                return _rep(ty, bits, inlined=True)
            if ty == Ty.Double:
                f32 = np.float32(value)
                if float(f32) == float(value):
                    bits = int(np.frombuffer(f32.tobytes(), np.uint32)[0])
                    return _rep(ty, bits, inlined=True)
            off = self._write_payload(np.asarray(value, dt).tobytes())
            return _rep(ty, off)
        arr = np.asarray(value, dt).reshape(-1)
        if arr.size != comps:
            raise CrateError(f"type {ty} expects {comps} components, "
                             f"got {arr.size}")
        if ty in (Ty.Matrix2d, Ty.Matrix3d, Ty.Matrix4d):
            dim = {Ty.Matrix2d: 2, Ty.Matrix3d: 3, Ty.Matrix4d: 4}[ty]
            m = arr.reshape(dim, dim)
            diag = np.diag(np.diag(m))
            d8 = np.diag(m).astype(np.int64)
            if np.array_equal(m, diag) and np.all(np.abs(d8) < 128) \
                    and np.array_equal(np.diag(m), d8):
                payload = int.from_bytes(
                    d8.astype(np.int8).tobytes() + b"\x00" * (8 - dim),
                    "little", signed=False) & PAYLOAD_MASK
                return _rep(ty, payload, inlined=True)
        else:
            i8 = arr.astype(np.int64)
            if np.array_equal(arr.astype(np.float64),
                              i8.astype(np.float64)) \
                    and np.all(np.abs(i8) < 128) and comps <= 6:
                payload = int.from_bytes(
                    i8.astype(np.int8).tobytes() + b"\x00" * (8 - comps),
                    "little", signed=False) & PAYLOAD_MASK
                return _rep(ty, payload, inlined=True)
        off = self._write_payload(arr.tobytes())
        return _rep(ty, off)

    def _pack_array(self, value, base: str, ty: Optional[int]) -> int:
        if base in ("token", "string", "asset"):
            items = list(value)
            idx = []
            for it in items:
                if base == "string":
                    idx.append(self._string_idx(str(it)))
                else:
                    idx.append(self.tokens.add(
                        it.path if isinstance(it, AssetPath) else str(it)))
            tyv = {"token": Ty.Token, "string": Ty.String,
                   "asset": Ty.AssetPath}[base]
            blob = struct.pack("<Q", len(idx)) \
                + np.asarray(idx, np.uint32).tobytes()
            return _rep(tyv, self._write_payload(blob), array=True)
        if ty is None:
            raise CrateError(f"cannot pack array of {base!r}")
        dt, comps = _NUMERIC[ty]
        arr = np.asarray(value, dt)
        if comps > 1:
            arr = arr.reshape(-1, comps)
        n = arr.shape[0] if arr.ndim else 0
        blob = struct.pack("<Q", n) + arr.tobytes()
        return _rep(ty, self._write_payload(blob), array=True)

    def pack_time_samples(self, samples: Dict[float, Any],
                          type_name: str) -> int:
        times = np.asarray(sorted(samples), np.float64)
        times_blob = struct.pack("<Q", len(times)) + times.tobytes()
        times_rep = _rep(Ty.Double, self._write_payload(times_blob),
                         array=True)
        reps = [self.pack_value(samples[float(t)], type_name)
                for t in times]
        self._align()
        off = len(self.body)
        # [times rep][values offset] -> [count][reps]
        values_off = off + 16
        blob = struct.pack("<QQQ", times_rep, values_off, len(reps)) \
            + np.asarray(reps, np.uint64).tobytes()
        self.body += blob
        return _rep(Ty.TimeSamples, off)

    def pack_path_list_op(self, targets: List[str]) -> int:
        # explicit list op with explicit items
        blob = bytearray()
        blob.append(1 | 2)               # isExplicit + has explicitItems
        blob += struct.pack("<Q", len(targets))
        for t in targets:
            blob += struct.pack("<I", self.paths.add(t))
        return _rep(Ty.PathListOp, self._write_payload(bytes(blob)))

    # -- dictionaries / arc list ops ----------------------------------------

    def _meta_rep(self, v) -> int:
        """Generic (schema-less) metadata value -> ValueRep."""
        if isinstance(v, dict):
            return self.pack_dictionary(v)
        if isinstance(v, AssetPath):
            return _rep(Ty.AssetPath, self.tokens.add(v.path), inlined=True)
        if isinstance(v, bool):
            return _rep(Ty.Bool, int(v), inlined=True)
        if isinstance(v, str):
            return _rep(Ty.String, self._string_idx(v), inlined=True)
        return self.pack_value(v, "")

    def _dict_blob(self, d: dict) -> bytes:
        """Dictionary record (see module docstring): nested value payloads
        are written to the body first so every rep's offset is absolute."""
        entries = []
        for k, v in d.items():
            entries.append((self._string_idx(str(k)), self._meta_rep(v)))
        parts = [struct.pack("<Q", len(entries))]
        for si, rep in entries:
            parts.append(struct.pack("<IqQ", si, 8, rep))
        return b"".join(parts)

    def pack_dictionary(self, d: dict) -> int:
        return _rep(Ty.Dictionary, self._write_payload(self._dict_blob(d)))

    _LIST_MODE_BITS = {"explicitItems": 2, "added": 4, "prepended": 8,
                       "appended": 16, "deleted": 32, "ordered": 64}

    def _arc_item_blob(self, item, payload: bool) -> bytes:
        if isinstance(item, Reference):
            asset, prim_path = item.asset, item.prim_path
        elif isinstance(item, AssetPath):
            asset, prim_path = item.path, ""
        elif isinstance(item, PrimPathRef):
            asset, prim_path = "", item.path
        else:
            asset, prim_path = str(item), ""
        si = self._string_idx(asset)
        pi = self.paths.add(prim_path) if prim_path else 0xFFFFFFFF
        blob = struct.pack("<IIdd", si, pi, 0.0, 1.0)   # identity offset
        if not payload:
            blob += struct.pack("<Q", 0)                # empty customData
        return blob

    def pack_reference_list_op(self, items, *, payload: bool = False,
                               mode: str = "explicitItems") -> int:
        """Reference/Payload list op.  ``items`` is either a flat list
        (written under ``mode``, with explicit set for explicitItems) or a
        {mode: items} dict for mixed prepend/append authoring."""
        if not isinstance(items, dict):
            items = {mode: list(items)}
        flags = 1 if "explicitItems" in items else 0
        for m in items:
            flags |= self._LIST_MODE_BITS[m]
        blob = bytearray([flags])
        for m in self._LIST_MODE_BITS:                  # canonical order
            if m not in items:
                continue
            blob += struct.pack("<Q", len(items[m]))
            for it in items[m]:
                blob += self._arc_item_blob(it, payload)
        ty = Ty.PayloadListOp if payload else Ty.ReferenceListOp
        return _rep(ty, self._write_payload(bytes(blob)))

    # -- structure ----------------------------------------------------------

    def add_field(self, name: str, rep: int) -> int:
        return self.fields.add((self.tokens.add(name), rep))

    def add_fieldset(self, field_ids: List[int]) -> int:
        off = len(self.fieldsets)
        self.fieldsets.extend(field_ids)
        self.fieldsets.append(-1)
        return off

    def add_spec(self, path: str, fset: int, spec_type: int):
        self.specs.append((self.paths.add(path), fset, spec_type))

    # -- path DFS encode ----------------------------------------------------

    def _encode_paths(self):
        """Preorder DFS over collected paths -> (pathIndexes,
        elementTokenIndexes, jumps)."""
        # build the namespace tree over all collected paths
        children: Dict[str, List[str]] = {}
        all_paths = list(self.paths.items)

        def parent_of(p: str) -> Optional[str]:
            if p == "/":
                return None
            if "." in p.rsplit("/", 1)[-1]:
                return p.rsplit(".", 1)[0]
            q = p.rsplit("/", 1)[0]
            return q if q else "/"

        known = set(all_paths)
        for p in list(all_paths):
            q = parent_of(p)
            while q is not None and q not in known:
                known.add(q)
                self.paths.add(q)
                q = parent_of(q)
        for p in self.paths.items:
            q = parent_of(p)
            if q is not None:
                children.setdefault(q, []).append(p)
        for v in children.values():
            v.sort()

        pidx, etok, jumps = [], [], []

        def element(p: str) -> int:
            leaf = p[p.rfind("/") + 1:]
            if "." in leaf:
                name = leaf.rsplit(".", 1)[1]
                ti = self.tokens.add(name)
                if ti == 0:
                    raise CrateError("property token at index 0")
                return -ti
            return self.tokens.add(leaf)

        def walk(p: str) -> int:
            """Emit p's subtree in preorder; return p's node index.  Each
            node's jump is patched by its parent (root at the end): -2
            leaf, -1 child-only, 0 sibling-is-next, >0 child + sibling at
            i + jump."""
            i = len(pidx)
            pidx.append(self.paths.index[p])
            etok.append(0 if p == "/" else element(p))
            jumps.append(-2)
            kids = children.get(p, [])
            child_indexes = [walk(c) for c in kids]
            for k, ci in enumerate(child_indexes):
                has_child = bool(children.get(kids[k]))
                if k + 1 < len(child_indexes):
                    sib = child_indexes[k + 1] - ci
                    jumps[ci] = sib if has_child else 0
                else:
                    jumps[ci] = -1 if has_child else -2
            return i

        ri = walk("/")
        jumps[ri] = -1 if children.get("/") else -2
        return (np.asarray(pidx, np.int32), np.asarray(etok, np.int32),
                np.asarray(jumps, np.int32))

    # -- file assembly ------------------------------------------------------

    def _compressed_ints_blob(self, arr: np.ndarray) -> bytes:
        from vri_tpu_torch.usd import usdc as usdc_mod

        comp = usdc_mod.intcomp_encode(np.asarray(arr, np.int32))
        return struct.pack("<Q", len(comp)) + comp

    def tobytes(self) -> bytes:
        from vri_tpu_torch.usd import usdc as usdc_mod

        sections = []

        # paths first: the DFS encode interns element-name tokens, which
        # must land in the TOKENS heap serialized below
        pidx, etok, jumps = self._encode_paths()

        # TOKENS
        blob = b"\x00".join(t.encode() for t in self.tokens.items) + b"\x00"
        comp = usdc_mod.fastcomp_compress(blob)
        tok = struct.pack("<QQQ", len(self.tokens.items), len(blob),
                          len(comp)) + comp
        sections.append((b"TOKENS", tok))

        # STRINGS
        s = struct.pack("<Q", len(self.strings.items)) \
            + np.asarray(self.strings.items, np.uint32).tobytes()
        sections.append((b"STRINGS", s))

        # FIELDS
        n = len(self.fields.items)
        tok_idx = np.asarray([t for t, _ in self.fields.items], np.int32)
        reps = np.asarray([r for _, r in self.fields.items], np.uint64)
        reps_comp = usdc_mod.fastcomp_compress(reps.tobytes())
        f = struct.pack("<Q", n) + self._compressed_ints_blob(tok_idx) \
            + struct.pack("<Q", len(reps_comp)) + reps_comp
        sections.append((b"FIELDS", f))

        # FIELDSETS
        fs = np.asarray(self.fieldsets, np.int32)
        fsb = struct.pack("<Q", len(fs)) + self._compressed_ints_blob(fs)
        sections.append((b"FIELDSETS", fsb))

        # PATHS
        pb = struct.pack("<QQ", len(self.paths.items), len(pidx)) \
            + self._compressed_ints_blob(pidx) \
            + self._compressed_ints_blob(etok) \
            + self._compressed_ints_blob(jumps)
        sections.append((b"PATHS", pb))

        # SPECS
        sp = np.asarray(self.specs, np.int64)
        sb = struct.pack("<Q", len(self.specs)) \
            + self._compressed_ints_blob(sp[:, 0] if len(sp) else sp) \
            + self._compressed_ints_blob(sp[:, 1] if len(sp) else sp) \
            + self._compressed_ints_blob(sp[:, 2] if len(sp) else sp)
        sections.append((b"SPECS", sb))

        body = self.body
        toc_entries = []
        for name, blob in sections:
            while len(body) % 8:
                body += b"\x00"
            toc_entries.append((name, len(body), len(blob)))
            body += blob
        while len(body) % 8:
            body += b"\x00"
        toc_off = len(body)
        body += struct.pack("<Q", len(toc_entries))
        for name, start, size in toc_entries:
            body += name.ljust(16, b"\x00") + struct.pack("<QQ", start, size)

        boot = b"PXR-USDC" + bytes(_WRITE_VERSION) + b"\x00" * 5 \
            + struct.pack("<Q", toc_off) + b"\x00" * 64
        assert len(boot) == 88
        body[:88] = boot
        return bytes(body)


_SDF_TO_TY = {
    "bool": Ty.Bool,
    "uchar": Ty.UChar,
    "int": Ty.Int,
    "uint": Ty.UInt,
    "int64": Ty.Int64,
    "uint64": Ty.UInt64,
    "half": Ty.Half,
    "float": Ty.Float,
    "double": Ty.Double,
    "timecode": Ty.Double,
    "string": Ty.String,
    "token": Ty.Token,
    "asset": Ty.AssetPath,
    "matrix2d": Ty.Matrix2d,
    "matrix3d": Ty.Matrix3d,
    "matrix4d": Ty.Matrix4d,
    "frame4d": Ty.Matrix4d,
    "quatd": Ty.Quatd,
    "quatf": Ty.Quatf,
    "quath": Ty.Quath,
    "double2": Ty.Vec2d, "float2": Ty.Vec2f, "half2": Ty.Vec2h,
    "int2": Ty.Vec2i, "texCoord2f": Ty.Vec2f, "texCoord2d": Ty.Vec2d,
    "texCoord2h": Ty.Vec2h,
    "double3": Ty.Vec3d, "float3": Ty.Vec3f, "half3": Ty.Vec3h,
    "int3": Ty.Vec3i, "point3f": Ty.Vec3f, "point3d": Ty.Vec3d,
    "normal3f": Ty.Vec3f, "normal3d": Ty.Vec3d, "color3f": Ty.Vec3f,
    "color3d": Ty.Vec3d, "vector3f": Ty.Vec3f, "vector3d": Ty.Vec3d,
    "texCoord3f": Ty.Vec3f,
    "double4": Ty.Vec4d, "float4": Ty.Vec4f, "half4": Ty.Vec4h,
    "int4": Ty.Vec4i, "color4f": Ty.Vec4f, "color4d": Ty.Vec4d,
}


def write_crate(stage, path: str) -> None:
    """Serialize a Stage to a crate file."""
    w = CrateWriter()

    # pseudo-root spec from stage metadata
    root_fields = []
    for k, v in (stage.metadata or {}).items():
        try:
            if k == "subLayers":
                rep = w.pack_value([AssetPath(str(x)) for x in v], "asset[]")
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                rep = w.pack_value(float(v), "double")
            else:
                rep = w.pack_value(v, "token" if isinstance(v, str) else "")
        except CrateError:
            continue
        root_fields.append(w.add_field(k, rep))
    w.add_spec("/", w.add_fieldset(root_fields), SPEC_PSEUDO_ROOT)

    def emit_prim(prim: Prim):
        p = prim.path
        fields = []
        fields.append(w.add_field(
            "specifier", _rep(Ty.Specifier,
                              _SPECIFIER_IDS.get(prim.specifier, 0),
                              inlined=True)))
        if prim.type_name:
            fields.append(w.add_field(
                "typeName", _rep(Ty.Token, w.tokens.add(prim.type_name),
                                 inlined=True)))
        for k, v in prim.metadata.items():
            try:
                if k in ("references", "payload", "payloads"):
                    lst = v if isinstance(v, (list, dict)) else [v]
                    rep = w.pack_reference_list_op(
                        lst, payload=k.startswith("payload"))
                    k = "payload" if k.startswith("payload") else k
                elif k in ("inherits", "specializes"):
                    lst = v if isinstance(v, list) else [v]
                    rep = w.pack_path_list_op(
                        [getattr(t, "path", None) or str(t) for t in lst])
                    k = "inheritPaths" if k == "inherits" else k
                elif isinstance(v, dict):
                    rep = w.pack_dictionary(v)
                else:
                    rep = w.pack_value(
                        v, "token" if isinstance(v, str) else "")
                fields.append(w.add_field(k, rep))
            except CrateError:
                log.debug("crate write: dropping prim metadata %s on %s",
                          k, p)
        w.add_spec(p, w.add_fieldset(fields), SPEC_PRIM)

        for a in prim.attributes.values():
            ap = f"{p}.{a.name}"
            afields = []
            if a.type_name == "rel":
                if isinstance(a.value, PrimPathRef):
                    afields.append(w.add_field(
                        "targetPaths", w.pack_path_list_op([a.value.path])))
                w.add_spec(ap, w.add_fieldset(afields), SPEC_RELATIONSHIP)
                continue
            if a.type_name:
                afields.append(w.add_field(
                    "typeName", _rep(Ty.Token, w.tokens.add(a.type_name),
                                     inlined=True)))
            if a.uniform:
                afields.append(w.add_field(
                    "variability", _rep(Ty.Variability, 1, inlined=True)))
            if a.connect:
                afields.append(w.add_field(
                    "connectionPaths", w.pack_path_list_op([a.connect])))
            if a.value is not None:
                try:
                    afields.append(w.add_field(
                        "default", w.pack_value(a.value, a.type_name)))
                except CrateError as e:
                    raise CrateError(f"{ap}: {e}") from e
            ts = a.metadata.get("timeSamples")
            for k, v in a.metadata.items():
                if k == "timeSamples":
                    continue
                try:
                    afields.append(w.add_field(k, w.pack_value(
                        v, "token" if isinstance(v, str) else "")))
                except CrateError:
                    log.debug("crate write: dropping attr metadata %s on %s",
                              k, ap)
            if ts:
                afields.append(w.add_field(
                    "timeSamples", w.pack_time_samples(ts, a.type_name)))
            w.add_spec(ap, w.add_fieldset(afields), SPEC_ATTRIBUTE)

        for c in prim.children:
            emit_prim(c)

    for c in stage.root.children:
        emit_prim(c)

    with open(path, "wb") as f:
        f.write(w.tobytes())
