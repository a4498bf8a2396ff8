"""Scene validation (copy of ``vri_tpu/runtime/checks.py`` over the
port's ``SceneBuffers``).

Callers get a list of findings, or an exception on demand, instead of a
fatal assert; capacity overflows (registry pools, SDF brick atlas,
material table) are counted at their sources.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from vri_tpu_torch.registry import SceneBuffers


@dataclasses.dataclass
class Finding:
    severity: str      # "error" | "warning"
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.message}"


class SceneValidationError(ValueError):
    def __init__(self, findings: List[Finding]):
        self.findings = findings
        super().__init__("; ".join(map(str, findings)))


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def validate_scene(scene: SceneBuffers, raise_on_error: bool = False
                   ) -> List[Finding]:
    out: List[Finding] = []
    nv = int(scene.num_vertices)
    nf = int(scene.num_faces)
    ni = int(scene.num_instances)

    # proto layout: positions is the prototype pool, smaller than nv
    npos = scene.positions.shape[0] if scene.vertex_proto is not None else nv
    pos = _np(scene.positions[:npos])
    if not np.isfinite(pos).all():
        out.append(Finding("error", "non-finite vertex positions"))
    tris = _np(scene.tri_vertices[:nf])
    if nf and (tris.min() < 0 or tris.max() >= max(nv, 1)):
        out.append(Finding("error",
                           f"triangle indices out of range [0, {nv})"))
    ti = _np(scene.tri_instance[:nf])
    if nf and (ti.min() < 0 or ti.max() >= max(ni, 1)):
        out.append(Finding("error", "triangle instance ids out of range"))
    tr = _np(scene.instance_transform[:ni])
    if ni and not np.isfinite(tr).all():
        out.append(Finding("error", "non-finite instance transforms"))
    if ni:
        det = np.linalg.det(tr[:, :3, :3])
        if (np.abs(det) < 1e-12).any():
            out.append(Finding("warning",
                               "singular instance transform(s)"))
    mats = _np(scene.instance_material[:ni])
    if ni and (mats.min() < 0 or mats.max() >= scene.mat_base_color.shape[0]):
        out.append(Finding("error", "instance material ids out of range"))
    if int(scene.num_lights) == 0:
        out.append(Finding("warning", "scene has no lights"))

    if raise_on_error and any(f.severity == "error" for f in out):
        raise SceneValidationError(
            [f for f in out if f.severity == "error"])
    return out
