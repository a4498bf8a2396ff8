// Staging, thread layout and per-(pixel, lane) evaluation shared by the
// work-list kernels (worklist.cu: the walks; worklist_grouped.cu: the
// grouped step).  Each stages a step's chunk as one record a lane
// (stage_records, from column_terms) and reads it with 16-byte broadcasts
// (load_record); a block of P / kPx threads holds kPx pixels a thread in
// one column of the tile, or in one row (block_shape, pixel_of).  The
// plain PyTorch versions in vri_tpu_torch/ops/worklist.py
// (_template_terms, _evaluate, _covered_depth) follow the same operation
// order; the library is built with -fmad=false, so every product and sum
// rounds on its own, as PyTorch's eager ops do, except where a product is
// exact and record_field fuses it into its add, which rounds the same
// way; kernel and plain version agree bit for bit.

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

// The staged terms of column c of a chunk (8, 3 TC) into t[0 ..
// staged_rows - 1]: the column's factors (a, b for FP32; hi, lo -- or hi,
// mid, lo -- pairs of the bf16 split; the six pre-split K=6 rows), then
// its constant, moved to the tile origin (fx0, fy0) when `translate` is
// set: (a * (fx0 - ox) + b * (fy0 - oy)) + c.
template <int EVAL>
__device__ __forceinline__ void column_terms(
    const float* __restrict__ rows, const uint16_t* __restrict__ rows_k6,
    int ncol, int c, bool translate, float fx0, float fy0, float* t) {
  const float a = rows[c];
  const float b = rows[ncol + c];
  float k = rows[2 * ncol + c];
  if (translate) {
    const float dx = fx0 - rows[3 * ncol + c];
    const float dy = fy0 - rows[4 * ncol + c];
    k = (a * dx + b * dy) + k;
  }
  if (EVAL == kF32) {
    t[0] = a;
    t[1] = b;
  } else if (EVAL == kK6) {
    for (int j = 0; j < 6; ++j)
      t[j] = __uint_as_float((uint32_t)rows_k6[j * ncol + c] << 16);
  } else {
    const float ha = bf16_round(a), hb = bf16_round(b);
    const float ra = a - ha, rb = b - hb;
    t[0] = ha;
    t[1] = hb;
    if (EVAL == kBf16x2) {
      t[2] = bf16_round(ra);
      t[3] = bf16_round(rb);
    } else {
      const float ma = bf16_round(ra), mb = bf16_round(rb);
      t[2] = ma;
      t[3] = mb;
      t[4] = bf16_round(ra - ma);
      t[5] = bf16_round(rb - mb);
    }
  }
  t[staged_rows<EVAL>() - 1] = k;
}

template <int EVAL>
__host__ __device__ constexpr int all_pairs() {
  return (staged_rows<EVAL>() - 1) / 2;
}

enum Layout { kColumn = 0, kRow = 1 };

// Floats of a lane's staged record: three fields' factors and constant,
// padded to a multiple of 4.
template <int EVAL>
__host__ __device__ constexpr int record_floats() {
  return (3 * staged_rows<EVAL>() + 3) / 4 * 4;
}

// Pixel k of thread t in a block of T threads holding PPT pixels each.
template <int LAYOUT, int PPT>
__device__ __forceinline__ int pixel_of(int t, int T, int k) {
  return LAYOUT == kRow ? t * PPT + k : t + k * T;
}

// Pixel centers of thread t on a `width`-wide tile; in the column layout
// every px[k] is one value, in the row layout every py[k].
template <int LAYOUT, int PPT>
__device__ __forceinline__ void pixel_centers(int width, float* px,
                                              float* py) {
  const int t = threadIdx.x, T = blockDim.x;
  const int p0 = pixel_of<LAYOUT, PPT>(t, T, 0);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pixel_of<LAYOUT, PPT>(t, T, k);
    px[k] = 0.5f + (float)((LAYOUT == kColumn ? p0 : p) % width);
    py[k] = 0.5f + (float)((LAYOUT == kRow ? p0 : p) / width);
  }
}

// Copy the chunk's lanes into records: rec[l * RW + f * S + j] is term j
// of field f of lane l (column_terms), sid[l] its slot id.
template <int EVAL>
__device__ void stage_records(const float* __restrict__ rows,
                              const uint16_t* __restrict__ rows_k6, int tc,
                              bool translate, float fx0, float fy0,
                              float* rec, float* sid) {
  constexpr int S = staged_rows<EVAL>(), RW = record_floats<EVAL>();
  const int ncol = 3 * tc;
  for (int l = threadIdx.x; l < tc; l += blockDim.x) {
    float r[RW];
#pragma unroll
    for (int f = 0; f < 3; ++f)
      column_terms<EVAL>(rows, rows_k6, ncol, f * tc + l, translate, fx0,
                         fy0, r + f * S);
#pragma unroll
    for (int j = 3 * S; j < RW; ++j) r[j] = 0.0f;
    float4* dst = reinterpret_cast<float4*>(rec + l * RW);
#pragma unroll
    for (int i = 0; i < RW / 4; ++i)
      dst[i] = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2],
                           r[4 * i + 3]);
    sid[l] = rows[5 * ncol + l];
  }
}

// One lane's record into registers, 16 bytes a load (the same address
// for every thread: a broadcast).
template <int RW>
__device__ __forceinline__ void load_record(const float* src, float* r) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < RW / 4; ++i) {
    const float4 v = s4[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

// px * a + py * b of exact products (a, b bf16): one product and one
// fused add, which rounds as the separate add does.  The product of the
// coordinate the thread's pixels share stays unfused, so it is computed
// once for all of them.
template <int LAYOUT>
__device__ __forceinline__ float exact_pair(float px, float py, float a,
                                            float b) {
  return LAYOUT == kRow ? __fmaf_rn(px, a, py * b)
                        : __fmaf_rn(py, b, px * a);
}

// Field of one lane's staged terms r (factor pairs, then the constant) at
// tile-local pixel (px, py): the first PAIRS pairs' sum, then + the
// constant.  Each bf16 pass is one dot, ((dot + dot) + dot); the K=6
// pass one six-term sum from the left; FP32 rounds both products.
template <int EVAL, int PAIRS, int LAYOUT>
__device__ __forceinline__ float record_field(const float* r, float px,
                                              float py) {
  constexpr int C = staged_rows<EVAL>() - 1;
  if (EVAL == kF32) return (px * r[0] + py * r[1]) + r[C];
  float out = exact_pair<LAYOUT>(px, py, r[0], r[1]);
#pragma unroll
  for (int j = 1; j < PAIRS; ++j) {
    const float a = r[2 * j], b = r[2 * j + 1];
    if (EVAL == kK6) {
      out = LAYOUT == kColumn ? out + px * a : __fmaf_rn(px, a, out);
      out = LAYOUT == kRow ? out + py * b : __fmaf_rn(py, b, out);
    } else {
      out = out + exact_pair<LAYOUT>(px, py, a, b);
    }
  }
  return out + r[C];
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

// The per-lane rule: keep the lexicographic minimum of (z, lane, step),
// walking steps and lanes in order.  The walks apply it once a step, to
// the step's own minimum (z, lane) -- the first lane of the step's least
// z, which a strict "<" over ascending lanes keeps -- and that gives the
// minimum over every (lane, step) as well.  True where (zm, l) wins; the
// caller then sets what the winner carries (its slot id, or
// micro_pass1's position).
__device__ __forceinline__ bool lane_update(float zm, int l, float& bz,
                                            int& bl) {
  if (zm < bz || (zm == bz && l < bl)) {
    bz = zm;
    bl = l;
    return true;
  }
  return false;
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

// A block of P / px threads (at most cap), ppt = P / threads pixels each
// -- px, or more where the cap binds -- in one column where the block
// width is a multiple of the tile's `width`, or in one row where ppt
// divides it; layout -1 where neither holds.
struct Shape {
  int threads, ppt, layout;
};

inline Shape block_shape(int P, int width, int px, int cap,
                         bool column_first) {
  Shape s;
  s.threads = P / px < cap ? P / px : cap;
  s.ppt = P / s.threads;
  const bool column = s.threads % width == 0, row = width % s.ppt == 0;
  s.layout = column && (column_first || !row) ? kColumn : row ? kRow : -1;
  return s;
}

// One launch of `kernel` (null: a shape without an instance) with s's
// threads, n_blocks blocks and `smem` bytes of shared memory.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int n_blocks, const Shape& s, size_t smem,
           cudaStream_t st, A... args) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_blocks, s.threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace vri_wl
