# Copy of vri_tpu/usd/stage.py for the port; only the imports differ.
"""Stage model on top of the USDA parser.

Plays the role of ``UsdStage`` + ``UsdImagingDelegate`` scene access in the
reference (Source/Main.cpp:33-46): opening a stage, resolving prim transforms,
and answering the queries the Hydra-style sync layer makes (points, topology,
primvars, material bindings, camera parameters).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from vri_tpu_torch.usd import usda
from vri_tpu_torch.usd.usda import Attribute, Prim, PrimPathRef
from vri_tpu_torch.utils import math3d


class Stage:
    """An opened USD-lite stage.

    ``Stage.open(path)`` / ``Stage.from_string(text)`` parse USDA;
    procedural builders construct prims directly and wrap them.
    """

    def __init__(self, root: Prim, metadata: Optional[Dict[str, Any]] = None,
                 anchor: str = ""):
        self.root = root
        self.metadata = metadata or {}
        #: directory used to resolve relative asset paths (textures)
        self.anchor = anchor
        #: current time code for timeSamples resolution (None = Default)
        self.time: Optional[float] = None
        self._index: Dict[str, Prim] = {}
        self._reindex()

    # -- constructors ------------------------------------------------------

    @classmethod
    def open(cls, path: str, _depth: int = 0) -> "Stage":
        """Open + compose a stage.

        The reference gets composition from full OpenUSD
        (CMakeLists.txt:25-37); this USD-lite composes the arcs real stages
        depend on: ``subLayers`` (weaker opinions under the root layer),
        ``references`` and ``payloads`` (grafting a target layer's prim —
        explicit ``@asset@</Path>`` or the layer's ``defaultPrim``), each
        recursively composed and resolved relative to its own layer.
        """
        if _depth > 8:
            raise usda.UsdaError(f"composition arc depth > 8 at {path!r}")
        from vri_tpu_torch.usd import usdc, usdz
        if usdz.is_usdz(path):
            # package: extract once, then open the root layer file-anchored
            return cls.open(usdz.extract(path), _depth=_depth)
        if usdc.is_crate(path):
            stage = usdc.open_crate(path)   # crate value decode (usd/crate)
            stage._compose(_depth)
            return stage
        with open(path, "r") as f:
            text = f.read()
        root, meta = usda.parse_usda(text)
        stage = cls(root, meta, anchor=os.path.dirname(os.path.abspath(path)))
        stage._compose(_depth)
        return stage

    @classmethod
    def from_string(cls, text: str, anchor: str = "",
                    compose: bool = True) -> "Stage":
        root, meta = usda.parse_usda(text)
        stage = cls(root, meta, anchor=anchor)
        if compose:
            stage._compose(0)
        return stage

    # -- composition ---------------------------------------------------------

    def _open_layer(self, asset: str, depth: int) -> "Stage":
        return Stage.open(self.resolve_asset(str(asset)), _depth=depth + 1)

    def _compose(self, depth: int) -> None:
        # subLayers: listed strongest-first, all weaker than the root layer
        for asset in reversed(self.metadata.get("subLayers", []) or []):
            try:
                layer = self._open_layer(asset, depth)
            except FileNotFoundError:
                continue
            for p in list(layer.root.children):
                _merge_weaker(self.root, p, layer.anchor, self.anchor)
        self._reindex()
        # inherits: class-prim opinions, stronger than variants/references
        # (the I in LIVRPS) — applied first so later, weaker arcs only fill
        # remaining gaps
        self._apply_class_arcs("inherits")
        # variant selections (strength: local > inherits > variants >
        # references — LIVRPS); a variant may itself add reference arcs,
        # which the pass below then resolves
        for prim in list(self.traverse(include_abstract=True)):
            self._apply_variants(prim)
        # references / payloads on any prim (local opinions stay stronger)
        for prim in list(self.traverse(include_abstract=True)):
            arcs = []
            for key in ("references", "payload", "payloads"):
                v = prim.metadata.get(key)
                if v is None:
                    continue
                arcs.extend(v if isinstance(v, list) else [v])
            for arc in arcs:
                self._apply_reference(prim, arc, depth)
        # specializes: weakest arc of all (the S in LIVRPS) — fills only
        # what no other arc authored
        self._apply_class_arcs("specializes")
        self._reindex()

    def _apply_class_arcs(self, key: str) -> None:
        """Merge ``inherits``/``specializes`` targets (class prims in this
        layer stack) into each arc-bearing prim as weaker opinions.  The
        reference relies on full OpenUSD for these arcs (Main.cpp:33)."""
        self._reindex()
        for prim in list(self.traverse(include_abstract=True)):
            v = prim.metadata.get(key)
            if v is None:
                continue
            for arc in v if isinstance(v, list) else [v]:
                path = getattr(arc, "path", None) or str(arc)
                target = self.prim_at_path(path)
                if target is None or target is prim:
                    continue
                if not prim.type_name:
                    prim.type_name = target.type_name
                _merge_weaker_into_prim(prim, target, self.anchor,
                                        self.anchor,
                                        path_map=(target.path, prim.path))

    def _apply_variants(self, prim: Prim) -> None:
        """Compose the selected variant of each variantSet into the prim.

        The selection comes from the prim's ``variants`` metadata dict
        (no selection -> no opinions, as in USD).  Arcs authored inside
        the chosen variant surface onto the prim for the reference pass.
        """
        if not prim.variant_sets:
            return
        sel = prim.metadata.get("variants") or {}
        for set_name, variants in prim.variant_sets.items():
            choice = sel.get(set_name)
            body = variants.get(str(choice)) if choice is not None else None
            if body is None:
                continue
            for key in ("references", "payload", "payloads"):
                if key in body.metadata and key not in prim.metadata:
                    prim.metadata[key] = body.metadata[key]
            _merge_weaker_into_prim(prim, body, self.anchor, self.anchor)

    def _apply_reference(self, prim: Prim, arc, depth: int) -> None:
        if isinstance(arc, usda.Reference):
            asset, target_path = arc.asset, arc.prim_path
        elif isinstance(arc, usda.AssetPath):
            asset, target_path = arc.path, ""
        elif isinstance(arc, PrimPathRef):
            asset, target_path = "", arc.path        # internal reference
        else:
            return
        if asset:
            try:
                layer = self._open_layer(asset, depth)
            except FileNotFoundError:
                return
            src_anchor = layer.anchor
        else:
            layer = self
            src_anchor = self.anchor
        if not target_path:
            target_path = str(layer.metadata.get("defaultPrim", ""))
            if target_path and not target_path.startswith("/"):
                target_path = "/" + target_path
        target = layer.prim_at_path(target_path) if target_path else None
        if target is None and layer.root.children and not target_path:
            target = layer.root.children[0]
        if target is None or target is prim:
            return
        # graft: the target's type/attrs/children merge in as weaker opinions
        if not prim.type_name:
            prim.type_name = target.type_name
        _merge_weaker_into_prim(prim, target, src_anchor, self.anchor,
                                path_map=(target.path, prim.path))

    def export(self) -> str:
        return usda.write_usda(self.root, self.metadata)

    def save(self, path: str) -> None:
        """Write this stage to disk — .usdc gets the binary crate writer
        (usd/crate.py), .usdz the aligned zip packager (usd/usdz.py),
        anything else USDA text."""
        if path.endswith(".usdc"):
            from vri_tpu_torch.usd import usdc
            usdc.write_crate(self, path)
        elif path.endswith(".usdz"):
            from vri_tpu_torch.usd import usdz
            usdz.write(self, path)
        else:
            with open(path, "w") as f:
                f.write(self.export())

    # -- prim access -------------------------------------------------------

    def _reindex(self) -> None:
        self._index.clear()
        for p in self.root.traverse():
            if p.name:
                self._index[p.path] = p

    def prim_at_path(self, path: str) -> Optional[Prim]:
        return self._index.get(path)

    def set_time(self, time: Optional[float]) -> None:
        """Set the stage time code; timeSamples resolve against it."""
        self.time = time

    def traverse(self, include_abstract: bool = False) -> Iterator[Prim]:
        """Composed prims, depth-first.  Abstract (``class``) prims never
        image in USD — they exist only as inherit/specialize targets — so
        they (and their subtrees) are skipped unless ``include_abstract``."""
        def walk(prim):
            for c in prim.children:
                if not c.name:
                    continue
                if c.specifier == "class" and not include_abstract:
                    continue
                yield c
                yield from walk(c)
        yield from walk(self.root)

    def prims_of_type(self, type_name: str) -> List[Prim]:
        return [p for p in self.traverse() if p.type_name == type_name]

    # -- computed queries --------------------------------------------------

    def local_transform(self, prim: Prim) -> np.ndarray:
        """Resolve the prim's local transform from its xformOps.

        Supports the op set our writer and common exporters emit:
        ``xformOp:transform`` (matrix4d), ``:translate``, ``:scale``,
        ``:rotateX/Y/Z`` and ``:rotateXYZ`` (degrees), applied in
        ``xformOpOrder``.  USD matrix4d is row-major with *row-vector*
        convention (p' = p @ M); we transpose into our column-vector world.
        """
        order = prim.get("xformOpOrder")
        if order is None:
            order = [n for n in prim.attributes if n.startswith("xformOp:")]
        m = np.eye(4, dtype=np.float32)
        for op_name in order:
            op = str(op_name)
            a = prim.attributes.get(op)
            if a is None:
                continue
            v = a.value_at(self.time)
            if v is None:
                continue
            if op.startswith("xformOp:transform"):
                om = np.asarray(v, np.float64).reshape(4, 4).T.astype(np.float32)
            elif op.startswith("xformOp:translate"):
                om = math3d.translate(np.asarray(v, np.float32))
            elif op.startswith("xformOp:scale"):
                om = math3d.scale(np.asarray(v, np.float32))
            elif op.startswith("xformOp:rotateXYZ"):
                r = np.deg2rad(np.asarray(v, np.float64))
                om = (math3d.rotate_z(r[2]) @ math3d.rotate_y(r[1]) @
                      math3d.rotate_x(r[0]))
            elif op.startswith("xformOp:rotateX"):
                om = math3d.rotate_x(math.radians(float(v)))
            elif op.startswith("xformOp:rotateY"):
                om = math3d.rotate_y(math.radians(float(v)))
            elif op.startswith("xformOp:rotateZ"):
                om = math3d.rotate_z(math.radians(float(v)))
            else:
                continue
            m = m @ om
        return m

    def world_transform(self, prim: Prim) -> np.ndarray:
        """Concatenated local-to-world transform (like
        ``UsdGeomXformable::ComputeLocalToWorldTransform``)."""
        chain: List[Prim] = []
        p: Optional[Prim] = prim
        while p is not None and p.name:
            chain.append(p)
            p = p.parent
        m = np.eye(4, dtype=np.float32)
        for p in reversed(chain):
            m = m @ self.local_transform(p)
        return m

    def bound_material(self, prim: Prim) -> Optional[Prim]:
        """Resolve ``rel material:binding`` (reference reads the bound
        material id as a hash — Source/Mesh.cpp:106)."""
        rel = prim.attributes.get("material:binding")
        if rel is None or rel.value is None:
            # inherit from ancestors, as USD binding resolution does
            if prim.parent is not None and prim.parent.name:
                return self.bound_material(prim.parent)
            return None
        target = rel.value
        if isinstance(target, list):
            target = target[0] if target else None
        if isinstance(target, PrimPathRef):
            target = target.path
        return self.prim_at_path(str(target)) if target else None

    def resolve_asset(self, asset_path: str) -> str:
        if os.path.isabs(asset_path) or not self.anchor:
            return asset_path
        return os.path.join(self.anchor, asset_path)

    # -- authoring helpers (procedural scenes, animation) ------------------

    def define_prim(self, path: str, type_name: str = "") -> Prim:
        parts = [p for p in path.split("/") if p]
        node = self.root
        for i, name in enumerate(parts):
            child = node.child(name)
            if child is None:
                child = Prim(name=name, parent=node,
                             type_name=type_name if i == len(parts) - 1 else "Xform")
                node.children.append(child)
            node = child
        if type_name and not node.type_name:
            node.type_name = type_name
        self._reindex()
        return node

    def set_attr(self, prim: Prim, name: str, type_name: str, value,
                 uniform: bool = False, **metadata) -> Attribute:
        a = prim.attributes.get(name) or Attribute(name=name)
        a.type_name, a.value, a.uniform = type_name, value, uniform
        a.metadata.update(metadata)
        prim.attributes[name] = a
        return a


# ---------------------------------------------------------------------------
# Composition merge helpers (opinion strength: existing/strong wins)
# ---------------------------------------------------------------------------

def _remap_path(path: str, path_map) -> str:
    if path_map is not None:
        old, new = path_map
        if path == old or path.startswith(old + "/"):
            return new + path[len(old):]
    return path


def _reanchor(value, src_anchor: str, dst_anchor: str, path_map=None):
    """Opinions authored in another layer stay resolvable after the merge:
    relative asset paths are absolutized against their own layer, and prim
    paths inside a referenced subtree remap to the graft site (the
    reference-arc path translation real USD composition performs)."""
    if isinstance(value, usda.AssetPath) and src_anchor \
            and src_anchor != dst_anchor and value.path \
            and not os.path.isabs(value.path):
        return usda.AssetPath(os.path.join(src_anchor, value.path))
    if isinstance(value, PrimPathRef):
        return PrimPathRef(_remap_path(value.path, path_map))
    if isinstance(value, list):
        return [_reanchor(v, src_anchor, dst_anchor, path_map)
                for v in value]
    return value


def _copy_attr(a: Attribute, src_anchor: str, dst_anchor: str,
               path_map=None) -> Attribute:
    connect = a.connect
    if connect is not None:
        connect = _remap_path(connect, path_map)
    return Attribute(name=a.name, type_name=a.type_name,
                     value=_reanchor(a.value, src_anchor, dst_anchor,
                                     path_map),
                     uniform=a.uniform, custom=a.custom,
                     metadata=dict(a.metadata), connect=connect)


def _copy_prim(p: Prim, parent: Prim, src_anchor: str,
               dst_anchor: str, path_map=None) -> Prim:
    out = Prim(name=p.name, type_name=p.type_name, specifier="def",
               metadata=dict(p.metadata), parent=parent)
    out.attributes = {k: _copy_attr(a, src_anchor, dst_anchor, path_map)
                      for k, a in p.attributes.items()}
    out.children = [_copy_prim(c, out, src_anchor, dst_anchor, path_map)
                    for c in p.children]
    return out


def _merge_weaker_into_prim(strong: Prim, weak: Prim, src_anchor: str,
                            dst_anchor: str, path_map=None) -> None:
    """Merge a weaker prim's opinions under ``strong`` (strong wins)."""
    if not strong.type_name and weak.type_name:
        strong.type_name = weak.type_name
    if strong.specifier == "over" and weak.specifier != "over":
        strong.specifier = "def"
    for k, v in weak.metadata.items():
        if k in ("references", "payload", "payloads"):
            continue      # arcs were applied in the weak layer's compose
        strong.metadata.setdefault(k, v)
    for name, a in weak.attributes.items():
        cur = strong.attributes.get(name)
        if cur is None or (cur.value is None and cur.connect is None):
            merged = _copy_attr(a, src_anchor, dst_anchor, path_map)
            if cur is not None:     # keep the stronger layer's metadata
                merged.metadata.update(cur.metadata)
                merged.type_name = cur.type_name or merged.type_name
            strong.attributes[name] = merged
        else:
            for mk, mv in a.metadata.items():
                cur.metadata.setdefault(mk, mv)
    for wc in weak.children:
        sc = strong.child(wc.name)
        if sc is None:
            strong.children.append(
                _copy_prim(wc, strong, src_anchor, dst_anchor, path_map))
        else:
            _merge_weaker_into_prim(sc, wc, src_anchor, dst_anchor,
                                    path_map)


def _merge_weaker(strong_root: Prim, weak_prim: Prim, src_anchor: str,
                  dst_anchor: str) -> None:
    """Merge a weaker layer's top-level prim under the composed root."""
    existing = strong_root.child(weak_prim.name)
    if existing is None:
        strong_root.children.append(
            _copy_prim(weak_prim, strong_root, src_anchor, dst_anchor))
    else:
        _merge_weaker_into_prim(existing, weak_prim, src_anchor, dst_anchor)
