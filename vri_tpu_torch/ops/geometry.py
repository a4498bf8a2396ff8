"""Vectorized geometric primitives shared by the SDF builder (counterpart
of ``vri_tpu/ops/geometry.py``, same operation order).

Three-wide sums are written out as ``(x + y) + z`` so their rounding does
not depend on how a backend orders a reduction."""

from __future__ import annotations

import torch


def dot3(u, v):
    """Dot product over the last (size-3) axis, summed left to right."""
    p = u * v
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def norm3(u):
    return torch.sqrt(dot3(u, u))


def cross(u, v):
    """Cross product over the last axis, each component one rounded
    product minus another, for the SDF builders' parity with the JAX
    build (``torch.linalg.cross`` may fuse them into a multiply-add,
    which leaves a rounding residue where they cancel)."""
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2,
                        u0 * v1 - u1 * v0], dim=-1)


def closest_point_on_triangle(p, a, b, c):
    """Closest point on triangle (a,b,c) to point p.  All inputs
    broadcastable (..., 3).  Branchless Voronoi-region case analysis."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot3(ab, ap)
    d2 = dot3(ac, ap)

    bp = p - b
    d3 = dot3(ab, bp)
    d4 = dot3(ac, bp)

    cp = p - c
    d5 = dot3(ab, cp)
    d6 = dot3(ac, cp)

    one = torch.ones_like(d1)
    zero = torch.zeros_like(d1)
    where = torch.where
    # region barycentric candidates
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    sv = vb + va + vc
    denom_v = 1.0 / where(torch.abs(sv) > 1e-30, sv, one)

    # edge AB
    v_ab = d1 / where(torch.abs(d1 - d3) > 1e-30, d1 - d3, one)
    v_ab = torch.clamp(v_ab, 0.0, 1.0)
    # edge AC
    w_ac = d2 / where(torch.abs(d2 - d6) > 1e-30, d2 - d6, one)
    w_ac = torch.clamp(w_ac, 0.0, 1.0)
    # edge BC
    num_bc = d4 - d3
    den_bc = (d4 - d3) + (d5 - d6)
    w_bc = num_bc / where(torch.abs(den_bc) > 1e-30, den_bc, one)
    w_bc = torch.clamp(w_bc, 0.0, 1.0)

    # interior
    v_in = vb * denom_v
    w_in = vc * denom_v

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0) & ~in_a & ~in_b
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0) & ~in_a & ~in_c & ~on_ab
    on_bc = ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
             & ~in_b & ~in_c & ~on_ab & ~on_ac)

    v = where(in_a | in_c, zero,
              where(in_b, one,
                    where(on_ab, v_ab,
                          where(on_ac, zero,
                                where(on_bc, 1.0 - w_bc, v_in)))))
    w = where(in_a | in_b, zero,
              where(in_c, one,
                    where(on_ab, zero,
                          where(on_ac, w_ac,
                                where(on_bc, w_bc, w_in)))))
    return a + v[..., None] * ab + w[..., None] * ac


def point_triangle_distance(p, a, b, c):
    return norm3(p - closest_point_on_triangle(p, a, b, c))


def aabb_distance(p, lo, hi):
    """Distance from point(s) to AABB(s) (0 inside)."""
    return norm3(torch.clamp(torch.maximum(lo - p, p - hi), min=0.0))


def tri_aabb(a, b, c):
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    return lo, hi
