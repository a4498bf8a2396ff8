// Per-slot terms and per-(pixel, slot) math shared by the raster kernels
// (raster_tiles.cu, raster_ranged.cu).  Every tier evaluates a pixel
// against a slot with these functions, so a pixel sees bit-identical depth keys and (u, v)
// whichever tier walks it; the plain PyTorch versions in
// vri_tpu_torch/ops/rasterize.py (_edge, _covers, _field) follow the same
// operation order.  The library is built with -fmad=false, so every
// product and sum rounds on its own, as PyTorch's eager ops do.

#pragma once

#include <cuda_runtime.h>

namespace vri {

// slot record (slot_coefficients): x0 y0 x1 y1 x2 y2 (global pixels),
// area sign, live flag, depth (a b c), un (a b c), vn (a b c), den (a b c),
// frame origin ox oy, pad, pad
constexpr int kCoef = 24;
constexpr int kMissKey = 0x40000000;  // bit pattern of 2.0f

// A slot's pixel-independent terms.  Per edge, its endpoints in
// canonical (x, then y) order -- bit-identical for both triangles of an
// edge, so a pixel center on a shared edge is never lost to rounding --
// as (x0, y0, x1 - x0, y1 - y0), and the area sign, negated where the
// endpoints were swapped; the slot frame's origin and its depth field.
struct Slot {
  float4 e0, e1, e2;  // per edge: x0, y0, x1 - x0, y1 - y0
  float4 sg;          // per edge: signed area sign; w: frame origin x
  float4 depth;       // x: frame origin y; y, z, w: depth a, b, c
};

__device__ __forceinline__ float4 canonical_edge(float ax, float ay,
                                                 float bx, float by,
                                                 float sign, float* sg) {
  const bool swap = bx < ax || (bx == ax && by < ay);
  const float x0 = swap ? bx : ax, y0 = swap ? by : ay;
  const float x1 = swap ? ax : bx, y1 = swap ? ay : by;
  *sg = swap ? -sign : sign;
  return make_float4(x0, y0, x1 - x0, y1 - y0);
}

// The pixel-independent terms of slot record c (read through the
// read-only data cache).
__device__ __forceinline__ Slot make_slot(const float* c) {
  const float x0 = __ldg(c), y0 = __ldg(c + 1), x1 = __ldg(c + 2),
              y1 = __ldg(c + 3), x2 = __ldg(c + 4), y2 = __ldg(c + 5);
  const float sign = __ldg(c + 6);
  Slot s;
  s.e0 = canonical_edge(x0, y0, x1, y1, sign, &s.sg.x);
  s.e1 = canonical_edge(x1, y1, x2, y2, sign, &s.sg.y);
  s.e2 = canonical_edge(x2, y2, x0, y0, sign, &s.sg.z);
  s.sg.w = __ldg(c + 20);
  s.depth = make_float4(__ldg(c + 21), __ldg(c + 8), __ldg(c + 9),
                        __ldg(c + 10));
  return s;
}

// The edge test at global pixel center (gx, gy): the edge function
// (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0) times the area sign is
// >= 0.  Negating the sign where the endpoints were swapped, instead of
// the edge function, rounds alike: (-e) * s and e * (-s) are one value.
__device__ __forceinline__ bool edge_in(const float4& e, float sg, float gx,
                                        float gy) {
  return (e.z * (gy - e.y) - e.w * (gx - e.x)) * sg >= 0.0f;
}

// Depth key of slot s at global pixel center (gx, gy): z (the depth field
// at the center's offset from the slot frame's origin) with its 7 low
// mantissa bits cleared where the center passes the three edge tests and
// 0 <= z <= 1, kMissKey elsewhere.
__device__ __forceinline__ int slot_key(const Slot& s, float gx, float gy) {
  const float lx = gx - s.sg.w;
  const float ly = gy - s.depth.x;
  const float z = (s.depth.y * lx + s.depth.z * ly) + s.depth.w;
  const bool ok = edge_in(s.e0, s.sg.x, gx, gy) &&
                  edge_in(s.e1, s.sg.y, gx, gy) &&
                  edge_in(s.e2, s.sg.z, gx, gy) && z >= 0.0f && z <= 1.0f;
  return __float_as_int(ok ? z : 2.0f) & ~127;
}

// Affine field (a*lx + b*ly) + c of the triple at column k, at the pixel
// center's offset (lx, ly) from the slot frame's origin.
__device__ __forceinline__ float field(const float* c, int k, float lx,
                                       float ly) {
  return (__ldg(c + k) * lx + __ldg(c + k + 1) * ly) + __ldg(c + k + 2);
}

// The winner's perspective-correct source barycentrics at (gx, gy) from
// its rational-affine fields un, vn, den.
__device__ __forceinline__ void slot_uv(const float* c, float gx, float gy,
                                        float* u, float* v) {
  const float lx = gx - __ldg(c + 20);
  const float ly = gy - __ldg(c + 21);
  const float un = field(c, 11, lx, ly);
  const float vn = field(c, 14, lx, ly);
  const float dn = field(c, 17, lx, ly);
  const float rcp = 1.0f / (fabsf(dn) > 1e-20f ? dn : 1.0f);
  *u = un * rcp;
  *v = vn * rcp;
}

}  // namespace vri
