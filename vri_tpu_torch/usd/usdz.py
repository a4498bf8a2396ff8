# Copy of vri_tpu/usd/usdz.py for the port; only the imports differ.
"""usdz package support (read + write).

A .usdz is an UNCOMPRESSED zip archive whose first entry is the default
(root) layer; other entries are referenced layers and texture assets with
archive-relative paths.  The reference opens packages through full
OpenUSD's Ar package resolver (``UsdStage::Open``, Source/Main.cpp:33);
this USD-lite extracts the archive to a private temp directory and lets
the ordinary file-anchored composition + texture resolution machinery
run unchanged — equivalent behavior without a virtual filesystem layer.

Writing follows the packaging spec: ZIP_STORED entries with the data of
each entry aligned to 64 bytes (via local-header extra-field padding, the
same trick usdzconvert uses), root layer first.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import List, Optional

from vri_tpu_torch.usd import usda

_LAYER_EXTS = (".usda", ".usdc", ".usd")


def is_usdz(path: str) -> bool:
    return path.lower().endswith(".usdz")


def extract(path: str) -> str:
    """Unpack a .usdz to a temp dir; returns the root-layer path there.

    The root layer is the archive's FIRST entry per the spec; archives
    that lead with other files fall back to the first layer-suffixed
    entry.  Member paths are validated against zip-slip (absolute paths
    or ``..`` escapes raise — a hostile package must not write outside
    its extraction dir).
    """
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        if not names:
            raise usda.UsdaError(f"empty usdz package: {path!r}")
        for n in names:
            norm = os.path.normpath(n)
            if norm.startswith("..") or os.path.isabs(norm) or ":" in norm:
                raise usda.UsdaError(f"unsafe member path in usdz: {n!r}")
        root: Optional[str] = None
        if names[0].lower().endswith(_LAYER_EXTS):
            root = names[0]
        else:
            root = next((n for n in names
                         if n.lower().endswith(_LAYER_EXTS)), None)
        if root is None:
            raise usda.UsdaError(f"no root layer in usdz: {path!r}")
        tmp = tempfile.mkdtemp(prefix="vri_usdz_")
        z.extractall(tmp)
    return os.path.join(tmp, root)


def _aligned_write(z: zipfile.ZipFile, name: str, data: bytes,
                   align: int = 64) -> None:
    """Write one ZIP_STORED entry with its DATA 64-byte aligned (the usdz
    packaging requirement, so crate layers can be mmapped in place)."""
    zinfo = zipfile.ZipInfo(name)
    zinfo.compress_type = zipfile.ZIP_STORED
    offset = z.fp.tell()
    header = 30 + len(name.encode("utf-8"))     # local file header size
    pad = (-(offset + header)) % align
    if 0 < pad < 4:                             # extra fields need >= 4 bytes
        pad += align
    if pad:
        # extra field: id 0x1986 (private padding id), sized to the gap
        zinfo.extra = (b"\x86\x19" + (pad - 4).to_bytes(2, "little")
                       + b"\x00" * (pad - 4))
    z.writestr(zinfo, data)


def write(stage, path: str, layer_format: str = "usdc") -> None:
    """Package ``stage`` as .usdz: root layer + every on-disk asset the
    stage references (textures etc.), archive paths kept stage-relative."""
    import io

    assets: List[str] = []
    for prim in stage.root.traverse():
        for attr in prim.attributes.values():
            v = attr.value if hasattr(attr, "value") else None
            vals = v if isinstance(v, list) else [v]
            for x in vals:
                if isinstance(x, usda.AssetPath):
                    assets.append(str(x))

    root_name = "root." + layer_format
    if layer_format == "usdc":
        from vri_tpu_torch.usd import usdc
        buf = tempfile.NamedTemporaryFile(suffix=".usdc", delete=False)
        buf.close()
        usdc.write_crate(stage, buf.name)
        with open(buf.name, "rb") as f:
            root_bytes = f.read()
        os.unlink(buf.name)
    else:
        root_name = "root.usda"
        root_bytes = stage.export().encode("utf-8")

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        _aligned_write(z, root_name, root_bytes)
        seen = set()
        for rel in assets:
            if rel in seen or os.path.isabs(rel):
                continue
            seen.add(rel)
            src = stage.resolve_asset(rel)
            if not os.path.isfile(src):
                continue
            with open(src, "rb") as f:
                _aligned_write(z, rel.replace(os.sep, "/"), f.read())
