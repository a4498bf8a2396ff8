"""Ray-triangle intersection (Möller–Trumbore) and a chunked brute-force
tracer (counterpart of ``vri_tpu/ops/intersect.py``): the visibility
oracle the raster is tested against.  Two-sided by default, with optional
per-face backface culling (``cull_sign``) carrying USD doubleSided
semantics."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INF = 3.0e38
EPS = 1.0e-9


@dataclasses.dataclass
class HitRecord:
    """Per-ray nearest hit. ``tri == -1`` is a miss (t == INF)."""

    t: torch.Tensor      # (N,) f32
    tri: torch.Tensor    # (N,) i32 global triangle id, -1 = miss
    u: torch.Tensor      # (N,) f32 barycentric of corner 1
    v: torch.Tensor      # (N,) f32 barycentric of corner 2
    #: () i32 — nonzero when a raster capacity overflowed (geometry may be
    #: missing); None for tracers that cannot overflow
    overflow: Optional[torch.Tensor] = None


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def gather_triangles(world_positions: torch.Tensor,
                     tri_vertices: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V,3) world verts + (F,3) indices -> (v0, e1, e2) each (F,3)."""
    p = world_positions[tri_vertices.long()]          # (F, 3, 3)
    v0 = p[:, 0]
    return v0, p[:, 1] - v0, p[:, 2] - v0


def moller_trumbore(o, d, v0, e1, e2, t_min=1e-4, t_max=INF):
    """Batched Möller–Trumbore.  o, d: (..., 1, 3) rays; v0, e1, e2:
    (T, 3) triangles.  Returns t, u, v, hit — each (..., T)."""
    pvec = _cross(d, e2)
    det = (pvec * e1).sum(-1)
    safe = torch.where(torch.abs(det) > EPS, det, torch.ones_like(det))
    inv_det = torch.where(torch.abs(det) > EPS, 1.0 / safe,
                          torch.zeros_like(det))
    tvec = o - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = _cross(tvec, e1)
    v = (qvec * d).sum(-1) * inv_det
    t = (qvec * e2).sum(-1) * inv_det
    hit = ((torch.abs(det) > EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, u, v, hit


def trace_brute(origins: torch.Tensor, dirs: torch.Tensor,
                v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                num_faces, chunk: int = 512, t_max=INF,
                cull_sign: torch.Tensor | None = None) -> HitRecord:
    """Nearest hit over all triangles, chunked.  Faces at index >=
    ``num_faces`` are ignored; ``t_max`` may be scalar or per-ray (N,).
    ``cull_sign`` ((F,) f32): 0 = two-sided, ±1 = keep only faces whose
    Möller–Trumbore determinant sign matches."""
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max_row = t_max[:, None] if t_max.ndim == 1 else t_max
    f = v0.shape[0]
    o = origins[:, None, :]
    d = dirs[:, None, :]
    best_t = t_max.expand(n).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    for s in range(0, f, chunk):
        cv0, ce1, ce2 = v0[s:s + chunk], e1[s:s + chunk], e2[s:s + chunk]
        t, u, v, hit = moller_trumbore(o, d, cv0, ce1, ce2, t_max=t_max_row)
        ids = torch.arange(s, s + cv0.shape[0], dtype=torch.int32,
                           device=dev)
        valid = hit & (ids[None, :] < num_faces)
        if cull_sign is not None:
            # MT det > 0 iff the CCW front side faces the ray
            det = (_cross(d, ce2) * ce1).sum(-1)
            cs = cull_sign[s:s + chunk][None, :]
            valid &= (cs == 0.0) | (det * cs > 0.0)
        t = torch.where(valid, t, torch.full_like(t, INF))
        k = torch.argmin(t, dim=-1)
        tk = t[rows, k]
        closer = tk < best_t
        best_t = torch.where(closer, tk, best_t)
        best_tri = torch.where(closer, ids[k], best_tri)
        best_u = torch.where(closer, u[rows, k], best_u)
        best_v = torch.where(closer, v[rows, k], best_v)
    return HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)
