// Per-(pixel, slot) math shared by the raster kernels (raster_tiles.cu,
// raster_ranged.cu).  Every tier evaluates a pixel against a slot with
// these functions, so a pixel sees bit-identical depth keys and (u, v)
// whichever tier walks it; the plain PyTorch versions in
// vri_tpu_torch/ops/rasterize.py (_edge, _covers, _field) follow the same
// operation order.  The library is built with -fmad=false, so every
// product and sum rounds on its own, as PyTorch's eager ops do.

#pragma once

#include <cuda_runtime.h>

namespace vri {

// slot record (slot_coefficients): x0 y0 x1 y1 x2 y2 (global pixels),
// area sign, pad, depth (a b c), un (a b c), vn (a b c), den (a b c),
// frame origin ox oy, pad, pad
constexpr int kCoef = 24;
constexpr int kMissKey = 0x40000000;  // bit pattern of 2.0f

// Loads from the read-only data cache (device-memory slot tables).
struct GlobalLoad {
  __device__ __forceinline__ static float at(const float* p, int i) {
    return __ldg(p + i);
  }
};

// Plain loads (slot rows staged in shared memory).
struct PlainLoad {
  __device__ __forceinline__ static float at(const float* p, int i) {
    return p[i];
  }
};

// cross(B - A, P - A) with the endpoints in canonical (x, then y) order
// and the sign restored: bit-identical for both triangles of an edge, so
// a pixel center on a shared edge is never lost to rounding.
__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  const bool swap = bx < ax || (bx == ax && by < ay);
  const float x0 = swap ? bx : ax, y0 = swap ? by : ay;
  const float x1 = swap ? ax : bx, y1 = swap ? ay : by;
  const float e = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
  return swap ? -e : e;
}

// Affine field (a*lx + b*ly) + c of the triple at column k, at the pixel
// center's offset (lx, ly) from the slot frame's origin.
template <class L>
__device__ __forceinline__ float field(const float* c, int k, float lx,
                                       float ly) {
  return (L::at(c, k) * lx + L::at(c, k + 1) * ly) + L::at(c, k + 2);
}

// Depth key of slot record c at global pixel center (gx, gy): z with its
// 7 low mantissa bits cleared where the center passes the three edge
// tests and 0 <= z <= 1, kMissKey elsewhere.
template <class L>
__device__ __forceinline__ int slot_key(const float* c, float gx, float gy) {
  const float lx = gx - L::at(c, 20);
  const float ly = gy - L::at(c, 21);
  const float z = field<L>(c, 8, lx, ly);
  const float x0 = L::at(c, 0), y0 = L::at(c, 1), x1 = L::at(c, 2),
              y1 = L::at(c, 3), x2 = L::at(c, 4), y2 = L::at(c, 5);
  const float sg = L::at(c, 6);
  const bool ok = edge(x0, y0, x1, y1, gx, gy) * sg >= 0.0f &&
                  edge(x1, y1, x2, y2, gx, gy) * sg >= 0.0f &&
                  edge(x2, y2, x0, y0, gx, gy) * sg >= 0.0f && z >= 0.0f &&
                  z <= 1.0f;
  return __float_as_int(ok ? z : 2.0f) & ~127;
}

// The winner's perspective-correct source barycentrics at (gx, gy) from
// its rational-affine fields un, vn, den.
__device__ __forceinline__ void slot_uv(const float* c, float gx, float gy,
                                        float* u, float* v) {
  const float lx = gx - __ldg(c + 20);
  const float ly = gy - __ldg(c + 21);
  const float un = field<GlobalLoad>(c, 11, lx, ly);
  const float vn = field<GlobalLoad>(c, 14, lx, ly);
  const float dn = field<GlobalLoad>(c, 17, lx, ly);
  const float rcp = 1.0f / (fabsf(dn) > 1e-20f ? dn : 1.0f);
  *u = un * rcp;
  *v = vn * rcp;
}

}  // namespace vri
