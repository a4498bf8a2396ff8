// Kernel K6: the capacity-free ranged visibility walk, the last rung of
// the renderer's raster overflow ladder.
//
// Replaces vri_tpu/ops/rasterize.py:_raster_kernel (K6).  Slots are
// sorted by the screen-Morton code of their bbox centers and packed in
// chunks of 128 (``order`` holds each Morton position's slot id in setup
// order); slots spanning more than 160 pixels sort to a front block of
// ``n_global`` chunks that every tile walks.  Per tile the host builds the
// local Morton chunk range [lo, hi) and a (tiles, n_words) bitmask of the
// chunks whose bbox overlaps the tile.  No list is built, so nothing can
// overflow.
//
// Layout: one thread block per tile_h x tile_w tile, one thread per
// pixel.  The block walks the global chunks, then the tile's local
// range, and skips a chunk whose overlap bit is clear (the test is
// uniform over the block).  For each live chunk, 128 threads stage one
// slot's pixel-independent terms each in shared memory (10 KB; kernel R's
// raster_common.cuh:make_slot: canonical edges, frame origin, depth
// field), then every thread tests its pixel against the 128 slots with
// kernel R's slot_key: canonical edge functions and the depth field at
// the pixel's offset from the slot's on-screen origin.  A pixel therefore
// sees bit-identical keys in every tier.
//
// Winner rule: minimum of (z with its 7 low mantissa bits cleared, slot
// index in setup order) -- kernel R's rule, keyed on the setup index
// because the walk here runs in Morton order.  K6 differs on purpose in
// two ways.  It evaluates l1 = e1 / area at global 1080p magnitudes, where
// the affine form cancels on slivers; the port evaluates fields at the
// offset from the slot's own origin.  And it ties on exact z by the
// lowest Morton index, so its winner among coplanar slots depends on the
// sort; the port's does not, and equals the sorted and binned tiers'.
//
// Bound on the H100: per live (tile, chunk) pair the block reads 128 slot
// records (through the read-only cache) and runs 128 x 1024
// (pixel, slot) tests of ~30 FP32 operations from shared-memory
// broadcasts, so the walk is compute-bound on the tests of overlapping
// chunks; the overlap bits keep it from walking the rest.  Every step is
// scalar FP32 and the library is built with -fmad=false, so the plain
// version (raster_ranged_reference) agrees bit for bit.

#include "raster_common.cuh"

namespace {

using vri::kCoef;
using vri::kMissKey;
using vri::Slot;

constexpr int kChunk = 128;

// A block of 1024 threads leaves each thread at most 64 registers.
__global__ void __launch_bounds__(1024)
    raster_ranged_kernel(const float* __restrict__ coef,
                         const int* __restrict__ order,
                         const int* __restrict__ ranges,
                         const unsigned* __restrict__ words, int n_global,
                         int n_words, int num_tx, int tile_h, int tile_w,
                         float* __restrict__ z_out,
                         int* __restrict__ slot_out,
                         float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  __shared__ float4 s_e0[kChunk], s_e1[kChunk], s_e2[kChunk], s_sg[kChunk],
      s_depth[kChunk];
  __shared__ int s_sid[kChunk];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int nthreads = blockDim.x;
  const float px = 0.5f + (float)(p % tile_w);
  const float py = 0.5f + (float)(p / tile_w);
  const float gx = (float)((tile % num_tx) * tile_w) + px;
  const float gy = (float)((tile / num_tx) * tile_h) + py;
  const int lo = ranges[2 * tile];
  const int hi = ranges[2 * tile + 1];
  const int steps = n_global + max(hi - lo, 0);
  const unsigned* tile_words = words + (size_t)tile * n_words;

  int best = kMissKey;
  int best_sid = 0x7fffffff;
  for (int k = 0; k < steps; ++k) {
    const int c = k < n_global ? k : lo + (k - n_global);
    if (!((__ldg(tile_words + (c >> 5)) >> (c & 31)) & 1u)) continue;
    __syncthreads();  // the previous chunk's slots are read
    const int* chunk = order + (size_t)c * kChunk;
    for (int j = p; j < kChunk; j += nthreads) {
      const int sid = __ldg(chunk + j);
      const Slot s = vri::make_slot(coef + (size_t)sid * kCoef);
      s_e0[j] = s.e0;
      s_e1[j] = s.e1;
      s_e2[j] = s.e2;
      s_sg[j] = s.sg;
      s_depth[j] = s.depth;
      s_sid[j] = sid;
    }
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      const int key = vri::slot_key(
          Slot{s_e0[j], s_e1[j], s_e2[j], s_sg[j], s_depth[j]}, gx, gy);
      const int sid = s_sid[j];
      if (key < best || (key == best && key != kMissKey && sid < best_sid)) {
        best = key;
        best_sid = sid;
      }
    }
  }

  const int o = tile * (tile_h * tile_w) + p;
  if (best != kMissKey) {
    z_out[o] = __int_as_float(best);
    slot_out[o] = best_sid;
    vri::slot_uv(coef + (size_t)best_sid * kCoef, gx, gy, u_out + o,
                 v_out + o);
  } else {
    z_out[o] = 3.0e38f;
    slot_out[o] = -1;
    u_out[o] = 0.0f;
    v_out[o] = 0.0f;
  }
}

}  // namespace

extern "C" int vri_raster_ranged(const float* coef, const int* order,
                                 const int* ranges, const int* words,
                                 int num_tiles, int n_global, int n_words,
                                 int num_tx, int tile_h, int tile_w,
                                 float* z_out, int* slot_out, float* u_out,
                                 float* v_out, void* stream) {
  if (num_tiles > 0) {
    raster_ranged_kernel<<<num_tiles, tile_h * tile_w, 0,
                           (cudaStream_t)stream>>>(
        coef, order, ranges, (const unsigned*)words, n_global, n_words,
        num_tx, tile_h, tile_w, z_out, slot_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
