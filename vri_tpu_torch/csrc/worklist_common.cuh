// Per-step staging and per-(pixel, lane) evaluation shared by the
// work-list kernels (worklist.cu, worklist_grouped.cu).  The plain PyTorch
// versions in vri_tpu_torch/ops/worklist.py (_template_terms, _evaluate,
// _covered_depth) follow the same operation order; the library is built
// with -fmad=false, so every product and sum rounds on its own, as
// PyTorch's eager ops do, and kernel and plain version agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vri_wl {

constexpr int kTileW = 128;            // pixel columns of a tile
constexpr int kNumTx = 15;             // tiles a row, in every tool
constexpr int kMissKey = 0x40000000;   // bit pattern of 2.0f
constexpr float kMissZ = 3.0e38f;

// How a field's two products are rounded (worklist.py WALK_KERNELS):
// FP32 as it is; the bf16 two- and three-pass splits of the slopes; the
// K=6 pass over a pre-split bf16 operand.
enum Eval { kF32 = 0, kBf16x2 = 1, kBf16x3 = 2, kK6 = 3 };

// Staged rows per column: the slope factors, then the constant.
template <int EVAL>
__host__ __device__ constexpr int staged_rows() {
  return EVAL == kF32 ? 3 : EVAL == kBf16x2 ? 5 : 7;
}

__host__ __device__ inline int lane_bits(int tc) {
  int b = 0;
  while ((1 << b) < tc) ++b;
  return b;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage one chunk (8, 3 TC) into shared memory: s[k * ncol + c] holds the
// column's factors (a, b for FP32; hi, lo -- or hi, mid, lo -- pairs of
// the bf16 split; the six pre-split K=6 rows), then its constant, moved
// to the tile origin (fx0, fy0) when `translate` is set:
// (a * (fx0 - ox) + b * (fy0 - oy)) + c.  sid[l] = row 5 for l < TC.
template <int EVAL>
__device__ void stage_chunk(const float* __restrict__ rows,
                            const uint16_t* __restrict__ rows_k6, int ncol,
                            int tc, bool translate, float fx0, float fy0,
                            float* s, float* sid) {
  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    const float a = rows[c];
    const float b = rows[ncol + c];
    float k = rows[2 * ncol + c];
    if (translate) {
      const float dx = fx0 - rows[3 * ncol + c];
      const float dy = fy0 - rows[4 * ncol + c];
      k = (a * dx + b * dy) + k;
    }
    if (EVAL == kF32) {
      s[c] = a;
      s[ncol + c] = b;
    } else if (EVAL == kK6) {
      for (int j = 0; j < 6; ++j)
        s[j * ncol + c] =
            __uint_as_float((uint32_t)rows_k6[j * ncol + c] << 16);
    } else {
      const float ha = bf16_round(a), hb = bf16_round(b);
      const float ra = a - ha, rb = b - hb;
      s[c] = ha;
      s[ncol + c] = hb;
      if (EVAL == kBf16x2) {
        s[2 * ncol + c] = bf16_round(ra);
        s[3 * ncol + c] = bf16_round(rb);
      } else {
        const float ma = bf16_round(ra), mb = bf16_round(rb);
        s[2 * ncol + c] = ma;
        s[3 * ncol + c] = mb;
        s[4 * ncol + c] = bf16_round(ra - ma);
        s[5 * ncol + c] = bf16_round(rb - mb);
      }
    }
    s[(staged_rows<EVAL>() - 1) * ncol + c] = k;
    if (c < tc) sid[c] = rows[5 * ncol + c];
  }
}

// Field of staged column q (= s + c) at tile-local pixel (px, py): the
// first PAIRS products' sum, then + the constant.  Each bf16 pass is one
// dot, ((dot + dot) + dot); the K=6 pass one six-term sum from the left.
template <int EVAL, int PAIRS>
__device__ __forceinline__ float field(const float* q, int ncol, float px,
                                       float py) {
  float out = px * q[0] + py * q[ncol];
  if (PAIRS >= 2) {
    if (EVAL == kK6) {
      out = out + px * q[2 * ncol];
      out = out + py * q[3 * ncol];
    } else {
      out = out + (px * q[2 * ncol] + py * q[3 * ncol]);
    }
  }
  if (PAIRS >= 3) {
    if (EVAL == kK6) {
      out = out + px * q[4 * ncol];
      out = out + py * q[5 * ncol];
    } else {
      out = out + (px * q[4 * ncol] + py * q[5 * ncol]);
    }
  }
  return out + q[(staged_rows<EVAL>() - 1) * ncol];
}

template <int EVAL>
__host__ __device__ constexpr int all_pairs() {
  return (staged_rows<EVAL>() - 1) / 2;
}

// z where the fields (l1, l2, z) cover the pixel (min(l1, l2, z) >= 0,
// l1 + l2 <= 1, z <= 1), 2.0 elsewhere.  fminf differs from
// torch.minimum only on NaN, and a NaN field fails l1 + l2 <= 1 or z <= 1
// either way.
__device__ __forceinline__ float cover(float l1, float l2, float z) {
  const bool ok =
      fminf(fminf(l1, l2), z) >= 0.0f && l1 + l2 <= 1.0f && z <= 1.0f;
  return ok ? z : 2.0f;
}

// cover() of staged lane l at tile-local pixel (px, py).
template <int EVAL>
__device__ __forceinline__ float covered_depth(const float* s, int ncol,
                                               int tc, int l, float px,
                                               float py) {
  constexpr int kPairs = all_pairs<EVAL>();
  return cover(field<EVAL, kPairs>(s + l, ncol, px, py),
               field<EVAL, kPairs>(s + tc + l, ncol, px, py),
               field<EVAL, kPairs>(s + 2 * tc + l, ncol, px, py));
}

// The per-lane rule: keep the lexicographic minimum of (z, lane, step),
// walking steps and lanes in order; `id` is what the winner carries (its
// slot id, or micro_pass1's position).
__device__ __forceinline__ void lane_update(float zm, int l, float id,
                                            float& bz, int& bl,
                                            float& bid) {
  if (zm < bz || (zm == bz && l < bl)) {
    bz = zm;
    bl = l;
    bid = id;
  }
}

// One output pixel: the winner's z and id where it covers (z <= 1), the
// miss values elsewhere.
__device__ __forceinline__ void store_pixel(float z, float id, size_t o,
                                            float* __restrict__ z_out,
                                            int* __restrict__ id_out) {
  const bool hit = z <= 1.0f;
  z_out[o] = hit ? z : kMissZ;
  id_out[o] = hit ? (int)id : -1;
}

}  // namespace vri_wl
