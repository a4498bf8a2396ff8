// Kernel R: per-tile visibility walk over sorted per-tile slot lists.
//
// Replaces the two TPU visibility kernels of the sorted raster path:
//   vri_tpu/ops/rasterize.py:_pass1_kernel   (K1, work-list walk)
//   vri_tpu/ops/rasterize.py:_grouped_kernel (K2, grouped short lists)
// On the TPU, K2 exists to dodge the per-grid-step cost for tiles with
// short lists; a GPU has no such floor, so a short list is just a short
// loop here and one kernel serves both.
//
// Layout: one thread block per tile_h x tile_w pixel tile (8 x 128 =
// 1024 threads), one thread per pixel.  Each thread walks the tile's own
// segment of the sorted pair stream, list[start[t] .. start[t] + n).  Per
// slot it runs the inside test on three edge functions in global pixel
// coordinates and evaluates depth from an affine field stored in the
// slot's local frame (origin = its screen-bbox min, held on the screen),
// at the pixel center's exact offset from that origin.  K1 instead moved
// the constant term to the tile origin and evaluated at the tile-local
// pixel center, a sum of terms up to 128x the field's own slope that
// cancels on slivers.
//
// Edge precision (trap 1): every edge function is evaluated with its two
// endpoints in a canonical order and the sign restored afterwards, so two
// triangles sharing an edge compute it bit for bit alike and a pixel
// center on the shared edge always lands in at least one of them -- the
// raster is watertight.  K1 instead tested l1, l2 >= 0 and l1 + l2 <= 1
// from per-slot affine coefficients evaluated through a three-term bf16
// split on the matrix unit; the two tests agree except on pixel centers
// within rounding of an edge.  All arithmetic is scalar FP32; the library
// is built with -fmad=false so every product and sum rounds separately,
// exactly as the plain PyTorch version (raster_tiles_reference) does, and
// the two agree bit for bit.  A TF32 or bf16 product here would reopen
// the cracks the reference's split closed.
//
// Winner rule: minimum of (z with its 7 low mantissa bits cleared,
// position in the tile's list) -- a strict "<" over increasing positions.
// K1 instead used the GLOBAL stream position mod 128 as its lane
// tiebreak, compared steps with "<", and also visited foreign slots at
// the ends of its 128-slot chunks; K2 picked the lowest position within
// the tile list.  The two rules differ only between slots of equal
// quantized depth, so a few tie pixels may pick another triangle.
//
// Bound on the H100: every thread of a block reads the same slot
// record (24 floats) per step, a broadcast served from L1, and
// does ~30 FP32 operations per (pixel, slot) test.  At 1080p the frame is
// 2025 blocks, so the walk is bound by the longest tile lists and by the
// L1 broadcast latency per step, not by device-memory bandwidth.  Staging
// a tile's coefficients in shared memory is left for later work.

#include <cuda_runtime.h>

namespace {

// slot record: x0 y0 x1 y1 x2 y2 (global pixels), area sign, pad,
// depth (a b c), un (a b c), vn (a b c), den (a b c), ox, oy, pad, pad
constexpr int kCoef = 24;
constexpr int kMissKey = 0x40000000;  // bit pattern of 2.0f

// Affine field (a*lx + b*ly) + c at the pixel center's offset (lx, ly)
// from the slot frame's origin (exact in FP32: integers plus one half).
__device__ __forceinline__ float field(const float* __restrict__ c,
                                       float lx, float ly) {
  const float a = __ldg(c), b = __ldg(c + 1), k = __ldg(c + 2);
  return (a * lx + b * ly) + k;
}

// cross(B - A, P - A) with the endpoints in canonical (x, then y) order
// and the sign restored: bit-identical for both triangles of an edge.
__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  const bool swap = bx < ax || (bx == ax && by < ay);
  const float x0 = swap ? bx : ax, y0 = swap ? by : ay;
  const float x1 = swap ? ax : bx, y1 = swap ? ay : by;
  const float e = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
  return swap ? -e : e;
}

__device__ __forceinline__ bool covers(const float* __restrict__ c,
                                       float gx, float gy) {
  const float x0 = __ldg(c), y0 = __ldg(c + 1), x1 = __ldg(c + 2),
              y1 = __ldg(c + 3), x2 = __ldg(c + 4), y2 = __ldg(c + 5);
  const float sg = __ldg(c + 6);
  return edge(x0, y0, x1, y1, gx, gy) * sg >= 0.0f &&
         edge(x1, y1, x2, y2, gx, gy) * sg >= 0.0f &&
         edge(x2, y2, x0, y0, gx, gy) * sg >= 0.0f;
}

__global__ void raster_tiles_kernel(const float* __restrict__ coef,
                                    const int* __restrict__ list,
                                    const int* __restrict__ start,
                                    const int* __restrict__ count,
                                    int num_tx, int tile_h, int tile_w,
                                    int cap, float* __restrict__ z_out,
                                    int* __restrict__ slot_out,
                                    float* __restrict__ u_out,
                                    float* __restrict__ v_out) {
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = 0.5f + (float)(p % tile_w);
  const float py = 0.5f + (float)(p / tile_w);
  const float fx0 = (float)((tile % num_tx) * tile_w);
  const float fy0 = (float)((tile / num_tx) * tile_h);
  const int s0 = start[tile];
  const int n = min(count[tile], cap);

  const float gx = fx0 + px;
  const float gy = fy0 + py;
  int best = kMissKey;
  int win = -1;
  for (int i = 0; i < n; ++i) {
    const float* c = coef + (size_t)__ldg(list + s0 + i) * kCoef;
    const float lx = gx - __ldg(c + 20);
    const float ly = gy - __ldg(c + 21);
    const float z = field(c + 8, lx, ly);
    const bool ok = covers(c, gx, gy) && z >= 0.0f && z <= 1.0f;
    const int key = __float_as_int(ok ? z : 2.0f) & ~127;
    if (key < best) {
      best = key;
      win = i;
    }
  }

  const int o = tile * (tile_h * tile_w) + p;
  if (win >= 0) {
    const int slot = list[s0 + win];
    const float* c = coef + (size_t)slot * kCoef;
    const float lx = gx - c[20];
    const float ly = gy - c[21];
    const float un = field(c + 11, lx, ly);
    const float vn = field(c + 14, lx, ly);
    const float dn = field(c + 17, lx, ly);
    const float rcp = 1.0f / (fabsf(dn) > 1e-20f ? dn : 1.0f);
    z_out[o] = __int_as_float(best);
    slot_out[o] = slot;
    u_out[o] = un * rcp;
    v_out[o] = vn * rcp;
  } else {
    z_out[o] = 3.0e38f;
    slot_out[o] = -1;
    u_out[o] = 0.0f;
    v_out[o] = 0.0f;
  }
}

}  // namespace

extern "C" int vri_raster_tiles(const float* coef, const int* list,
                                const int* start, const int* count,
                                int num_tiles, int num_tx, int tile_h,
                                int tile_w, int cap, float* z_out,
                                int* slot_out, float* u_out, float* v_out,
                                void* stream) {
  if (num_tiles > 0) {
    raster_tiles_kernel<<<num_tiles, tile_h * tile_w, 0,
                          (cudaStream_t)stream>>>(
        coef, list, start, count, num_tx, tile_h, tile_w, cap, z_out,
        slot_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
