# Copy of vri_tpu/usd/usda.py for the port; only the imports differ.
"""Minimal USDA (text USD) parser + writer.

The reference links full OpenUSD and opens stages with ``UsdStage::Open``
(Source/Main.cpp:33) followed by ``UsdImagingDelegate::Populate``.  This
environment has no ``pxr`` module, so the framework carries its own USD-lite:
a tokenizer + recursive-descent parser for the subset of USDA the renderer
consumes —

  * prim hierarchy (``def``/``over``/``class``, typed or untyped)
  * stage + prim metadata in ``( ... )`` blocks
  * typed attributes: scalars, tuples, arrays of tuples, strings, asset paths
    (``@...@``), prim paths (``<...>``), token lists
  * attribute connections (``.connect =``) and relationships (``rel``)
  * per-attribute metadata (e.g. ``interpolation = "faceVarying"``)

If a real ``pxr`` is ever present, :mod:`vri_tpu_torch.usd.stage` prefers it; this
parser is the hermetic fallback and the one exercised in CI.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class UsdaError(ValueError):
    pass


@dataclasses.dataclass
class Attribute:
    """A prim property: attribute or relationship."""

    name: str
    type_name: str = ""              # e.g. "point3f[]", "rel", "token"
    value: Any = None
    uniform: bool = False
    custom: bool = False
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    connect: Optional[str] = None    # target path of a `.connect`

    @property
    def interpolation(self) -> Optional[str]:
        return self.metadata.get("interpolation")

    @property
    def time_samples(self) -> Optional[Dict[float, Any]]:
        return self.metadata.get("timeSamples")

    def value_at(self, time: Optional[float] = None):
        """Resolve the value at ``time``.

        USD semantics: the default value answers UsdTimeCode::Default
        (time None); authored timeSamples answer numeric times with
        linear interpolation for floating-point data and held
        interpolation otherwise (the reference gets this resolution from
        UsdImagingDelegate, Source/Main.cpp:41-46).  A samples-only
        attribute falls back to its earliest sample at Default.
        """
        ts = self.metadata.get("timeSamples")
        if not ts:
            return self.value
        if time is None:
            return self.value if self.value is not None \
                else ts[min(ts)]
        keys = sorted(ts)
        if time <= keys[0]:
            return ts[keys[0]]
        if time >= keys[-1]:
            return ts[keys[-1]]
        import bisect

        hi = bisect.bisect_right(keys, time)
        t0, t1 = keys[hi - 1], keys[hi]
        v0, v1 = ts[t0], ts[t1]
        try:
            a0 = np.asarray(v0)
            a1 = np.asarray(v1)
            if a0.shape == a1.shape and a0.dtype.kind == "f" \
                    and a1.dtype.kind == "f":
                w = (time - t0) / (t1 - t0)
                return (a0 * (1.0 - w) + a1 * w).astype(a0.dtype)
        except (TypeError, ValueError):
            pass
        return v0                         # held interpolation


@dataclasses.dataclass
class Prim:
    name: str
    type_name: str = ""              # "", "Xform", "Mesh", ...
    specifier: str = "def"
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attributes: Dict[str, Attribute] = dataclasses.field(default_factory=dict)
    children: List["Prim"] = dataclasses.field(default_factory=list)
    parent: Optional["Prim"] = dataclasses.field(default=None, repr=False)
    # variantSet name -> {variant name -> opinions (a detached Prim)}
    variant_sets: Dict[str, Dict[str, "Prim"]] = dataclasses.field(
        default_factory=dict)

    @property
    def path(self) -> str:
        parts = []
        p: Optional[Prim] = self
        while p is not None and p.name:
            parts.append(p.name)
            p = p.parent
        return "/" + "/".join(reversed(parts))

    def child(self, name: str) -> Optional["Prim"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def get(self, attr: str, default=None):
        a = self.attributes.get(attr)
        return default if a is None or a.value is None else a.value

    def get_at(self, attr: str, time=None, default=None):
        """Like ``get`` but resolving timeSamples at ``time``."""
        a = self.attributes.get(attr)
        if a is None:
            return default
        v = a.value_at(time)
        return default if v is None else v

    def traverse(self):
        yield self
        for c in self.children:
            yield from c.traverse()


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<asset>@[^@]*@)
  | (?P<path><[^>]*>)
  | (?P<number>[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9:.\[\]]*)
  | (?P<punct>[{}()\[\],=;:])
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            line = text.count("\n", 0, pos) + 1
            raise UsdaError(f"usda tokenize error at line {line}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> Tuple[str, str]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        kind, val = self.next()
        if val != text:
            raise UsdaError(f"expected {text!r}, got {val!r} (token {self.i})")

    # -- values ------------------------------------------------------------

    def parse_value(self) -> Any:
        kind, val = self.peek()
        if val == "(":
            return self.parse_tuple()
        if val == "[":
            return self.parse_list()
        if val == "{":
            return self.parse_dict()
        if kind == "string":
            self.next()
            return _unquote(val)
        if kind == "asset":
            self.next()
            # composition arc payload: `@file.usda@</Prim/Path>` — an asset
            # immediately followed by a prim path is one reference value
            if self.peek()[0] == "path":
                _, p = self.next()
                return Reference(val[1:-1], p[1:-1])
            return AssetPath(val[1:-1])
        if kind == "path":
            self.next()
            return PrimPathRef(val[1:-1])
        if kind == "number":
            self.next()
            return _num(val)
        if kind == "ident":
            self.next()
            if val in ("true", "True"):
                return True
            if val in ("false", "False"):
                return False
            if val in ("None", "none"):
                return None
            return val  # bare token
        raise UsdaError(f"unexpected value token {val!r}")

    def parse_tuple(self) -> tuple:
        self.expect("(")
        items = []
        while self.peek()[1] != ")":
            items.append(self.parse_value())
            if self.peek()[1] == ",":
                self.next()
        self.expect(")")
        return tuple(items)

    def parse_list(self) -> list:
        self.expect("[")
        items = []
        while self.peek()[1] != "]":
            items.append(self.parse_value())
            if self.peek()[1] == ",":
                self.next()
        self.expect("]")
        return items

    def parse_dict(self) -> dict:
        """``{ [type] key = value; ... }`` metadata dictionaries (e.g. the
        ``variants`` selection block)."""
        self.expect("{")
        out: Dict[str, Any] = {}
        while self.peek()[1] != "}":
            kind, tok = self.next()
            key = tok
            # optional type token before the key ("string shadingVariant")
            if self.peek()[1] not in ("=",) and self.peek()[0] in (
                    "ident", "string"):
                kind, key = self.next()
            if kind == "string":
                key = _unquote(key)
            self.expect("=")
            out[key] = self.parse_value()
            if self.peek()[1] in (",", ";"):
                self.next()
        self.expect("}")
        return out

    def parse_metadata_block(self) -> Dict[str, Any]:
        """Parse a ``( key = value ... )`` metadata block."""
        self.expect("(")
        meta: Dict[str, Any] = {}
        while self.peek()[1] != ")":
            kind, key = self.next()
            if kind == "string":
                # doc-string style comment metadata; store under 'doc'
                meta.setdefault("doc", _unquote(key))
                continue
            if self.peek()[1] == "=":
                self.next()
                meta[key] = self.parse_value()
            else:
                meta[key] = True
        self.expect(")")
        return meta

    # -- prims & properties ------------------------------------------------

    def parse_prim(self, specifier: str, parent: Optional[Prim]) -> Prim:
        kind, tok = self.next()
        if kind == "ident":
            type_name = tok
            kind, tok = self.next()
        else:
            type_name = ""
        if kind != "string":
            raise UsdaError(f"expected prim name string, got {tok!r}")
        prim = Prim(name=_unquote(tok), type_name=type_name, specifier=specifier,
                    parent=parent)
        if self.peek()[1] == "(":
            prim.metadata = self.parse_metadata_block()
        self.expect("{")
        while self.peek()[1] != "}":
            self.parse_statement(prim)
        self.expect("}")
        return prim

    def parse_statement(self, prim: Prim) -> None:
        kind, tok = self.peek()
        if tok in ("def", "over", "class"):
            self.next()
            child = self.parse_prim(tok, prim)
            prim.children.append(child)
            return
        if tok == "variantSet" and self.peek(1)[0] == "string":
            self.next()
            _, name = self.next()
            set_name = _unquote(name)
            self.expect("=")
            self.expect("{")
            variants: Dict[str, Prim] = {}
            while self.peek()[1] != "}":
                kind, vname = self.next()
                if kind != "string":
                    raise UsdaError(
                        f"expected variant name string, got {vname!r}")
                body = Prim(name=_unquote(vname), specifier="over")
                if self.peek()[1] == "(":
                    body.metadata = self.parse_metadata_block()
                self.expect("{")
                while self.peek()[1] != "}":
                    self.parse_statement(body)
                self.expect("}")
                variants[body.name] = body
            self.expect("}")
            prim.variant_sets[set_name] = variants
            return
        # property
        uniform = custom = False
        while self.peek()[1] in ("uniform", "custom", "prepend", "append", "delete"):
            t = self.next()[1]
            uniform |= t == "uniform"
            custom |= t == "custom"
        kind, type_name = self.next()
        if kind != "ident":
            raise UsdaError(f"expected property type, got {type_name!r}")
        if type_name == "rel":
            kind, name = self.next()
            attr = Attribute(name=name, type_name="rel")
            if self.peek()[1] == "=":
                self.next()
                attr.value = self.parse_value()
            if self.peek()[1] == "(":
                attr.metadata = self.parse_metadata_block()
            prim.attributes[name] = attr
            return
        kind, name = self.next()
        connect = name.endswith(".connect")
        if connect:
            name = name[: -len(".connect")]
        samples = name.endswith(".timeSamples")
        if samples:
            name = name[: -len(".timeSamples")]
        attr = prim.attributes.get(name) or Attribute(name=name, type_name=type_name)
        attr.type_name = type_name
        attr.uniform, attr.custom = uniform, custom
        if self.peek()[1] == "=":
            self.next()
            if samples:
                attr.metadata["timeSamples"] = \
                    self.parse_time_samples(type_name)
            else:
                v = self.parse_value()
                if connect:
                    attr.connect = v.path if isinstance(v, PrimPathRef) \
                        else str(v)
                else:
                    attr.value = _to_array(type_name, v)
        if self.peek()[1] == "(":
            attr.metadata.update(self.parse_metadata_block())
        prim.attributes[name] = attr

    def parse_time_samples(self, type_name: str) -> Dict[float, Any]:
        """``{ <time>: <value>, ... }`` blocks (authored animation — the
        reference resolves these through UsdImagingDelegate,
        Source/Main.cpp:41-46)."""
        self.expect("{")
        out: Dict[float, Any] = {}
        while self.peek()[1] != "}":
            kind, t = self.next()
            if kind != "number":
                raise UsdaError(f"expected sample time, got {t!r}")
            self.expect(":")
            out[float(t)] = _to_array(type_name, self.parse_value())
            if self.peek()[1] in (",", ";"):
                self.next()
        self.expect("}")
        return out


@dataclasses.dataclass(frozen=True)
class AssetPath:
    path: str

    def __str__(self) -> str:
        return self.path


@dataclasses.dataclass(frozen=True)
class PrimPathRef:
    path: str

    def __str__(self) -> str:
        return self.path


@dataclasses.dataclass(frozen=True)
class Reference:
    """A reference/payload arc target: layer asset + optional prim path
    (empty = the target layer's defaultPrim)."""

    asset: str
    prim_path: str = ""


def _unquote(s: str) -> str:
    return s[1:-1].encode("utf-8").decode("unicode_escape")


def _num(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


_ARRAY_DTYPES = {
    "int": np.int32,
    "uint": np.uint32,
    "int64": np.int64,
    "float": np.float32,
    "double": np.float64,
    "half": np.float16,
    "point3f": np.float32,
    "point3d": np.float64,
    "normal3f": np.float32,
    "vector3f": np.float32,
    "color3f": np.float32,
    "color4f": np.float32,
    "float2": np.float32,
    "float3": np.float32,
    "float4": np.float32,
    "texCoord2f": np.float32,
    "texCoord2d": np.float64,
    "matrix4d": np.float64,
    "quatf": np.float32,
}


def _to_array(type_name: str, v: Any) -> Any:
    """Convert parsed lists/tuples into numpy arrays for known numeric types."""
    base = type_name.rstrip("[]")
    dt = _ARRAY_DTYPES.get(base)
    if dt is None:
        return v
    try:
        if type_name.endswith("[]"):
            if isinstance(v, list):
                return np.asarray(v, dtype=dt)
            return v
        if base == "matrix4d":
            return np.asarray(v, dtype=dt).reshape(4, 4)
        if isinstance(v, (tuple, list, int, float)):
            return np.asarray(v, dtype=dt)
    except (TypeError, ValueError):
        return v
    return v


def parse_usda(text: str) -> Tuple[Prim, Dict[str, Any]]:
    """Parse USDA text -> (pseudo-root prim, stage metadata).

    The pseudo-root has name ``""`` and holds top-level prims as children
    (mirroring pxr's pseudo-root ``/``).
    """
    text = text.lstrip()
    if text.startswith("#usda"):
        text = text.split("\n", 1)[1] if "\n" in text else ""
    p = _Parser(_tokenize(text))
    stage_meta: Dict[str, Any] = {}
    if p.peek()[1] == "(":
        stage_meta = p.parse_metadata_block()
    root = Prim(name="", type_name="", specifier="def")
    while p.peek()[0] != "eof":
        kind, tok = p.next()
        if tok not in ("def", "over", "class"):
            raise UsdaError(f"expected prim specifier at top level, got {tok!r}")
        root.children.append(p.parse_prim(tok, root))
    return root, stage_meta


# ---------------------------------------------------------------------------
# Writer (round-trip for procedural scenes and the scene cache)
# ---------------------------------------------------------------------------

def _fmt_value(v: Any) -> str:
    if isinstance(v, Reference):
        return f"@{v.asset}@" + (f"<{v.prim_path}>" if v.prim_path else "")
    if isinstance(v, AssetPath):
        return f"@{v.path}@"
    if isinstance(v, PrimPathRef):
        return f"<{v.path}>"
    if isinstance(v, str):
        return '"%s"' % v.replace("\\", "\\\\").replace('"', '\\"')
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, np.ndarray):
        if v.ndim == 0:
            return _fmt_value(v.item())
        if v.ndim == 1:
            return "[" + ", ".join(_fmt_value(x) for x in v.tolist()) + "]"
        if v.ndim == 2 and v.shape == (4, 4):
            rows = ", ".join("(" + ", ".join(repr(float(x)) for x in r) + ")" for r in v.tolist())
            return f"( {rows} )"
        return "[" + ", ".join(
            "(" + ", ".join(_fmt_value(x) for x in row) + ")" for row in v.tolist()
        ) + "]"
    if isinstance(v, tuple):
        return "(" + ", ".join(_fmt_value(x) for x in v) + ")"
    if isinstance(v, list):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, dict):
        items = " ".join(f'string {k} = {_fmt_value(val)}'
                         for k, val in v.items())
        return "{ " + items + " }"
    return str(v)


def _write_prim(prim: Prim, out: List[str], indent: int) -> None:
    pad = "    " * indent
    head = f"{pad}{prim.specifier}"
    if prim.type_name:
        head += f" {prim.type_name}"
    head += f' "{prim.name}"'
    if prim.metadata:
        head += " (\n" + "".join(
            f"{pad}    {k} = {_fmt_value(v)}\n" for k, v in prim.metadata.items()
        ) + f"{pad})"
    out.append(head + "\n")
    out.append(pad + "{\n")
    for attr in prim.attributes.values():
        line = "    " * (indent + 1)
        if attr.uniform:
            line += "uniform "
        if attr.type_name == "rel":
            line += f"rel {attr.name}"
            if attr.value is not None:
                line += f" = {_fmt_value(attr.value)}"
        else:
            nm = attr.name + (".connect" if attr.connect and attr.value is None else "")
            line += f"{attr.type_name} {nm}"
            if attr.connect and attr.value is None:
                line += f" = <{attr.connect}>"
            elif attr.value is not None:
                line += f" = {_fmt_value(attr.value)}"
        meta = {k: v for k, v in attr.metadata.items() if k != "timeSamples"}
        if meta:
            line += " (" + " ".join(
                f"{k} = {_fmt_value(v)}" for k, v in meta.items()
            ) + ")"
        out.append(line + "\n")
        ts = attr.metadata.get("timeSamples")
        if ts and attr.type_name != "rel":
            tpad = "    " * (indent + 1)
            out.append(f"{tpad}{attr.type_name} {attr.name}.timeSamples"
                       " = {\n")
            for t in sorted(ts):
                out.append(f"{tpad}    {t!r}: {_fmt_value(ts[t])},\n")
            out.append(tpad + "}\n")
    for set_name, variants in prim.variant_sets.items():
        vpad = "    " * (indent + 1)
        out.append(f'{vpad}variantSet "{set_name}" = {{\n')
        for vname, body in variants.items():
            out.append(f'{vpad}    "{vname}" {{\n')
            inner: List[str] = []
            _write_prim(body, inner, indent + 2)
            # body writes as a prim; keep only its statements
            out.extend(inner[2:-1])
            out.append(f"{vpad}    }}\n")
        out.append(vpad + "}\n")
    for child in prim.children:
        _write_prim(child, out, indent + 1)
    out.append(pad + "}\n")


def write_usda(root: Prim, stage_meta: Optional[Dict[str, Any]] = None) -> str:
    out: List[str] = ["#usda 1.0\n"]
    if stage_meta:
        out.append("(\n")
        for k, v in stage_meta.items():
            out.append(f"    {k} = {_fmt_value(v)}\n")
        out.append(")\n")
    for prim in root.children:
        _write_prim(prim, out, 0)
    return "".join(out)
