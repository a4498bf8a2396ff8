// The grouped work-list step: one stateless step serves TC / W tiles.
//
// Replaces the TPU kernel of tools/micro_grouped.py:kernel_grouped (T2).
// Each step's chunk holds templates whose constant term is already at the
// tile origin; the step evaluates them (bf16 two-pass products) at the P
// pixels of a tile and, for each W-lane block g, keeps the block's nearest
// covering lane by packed key (z bits with lane_bits(TC) low bits cleared
// | lane), writing that lane's unquantized z and slot id to row g of the
// step's (G, P) output.  The TPU finds the block winner with a suffix
// minimum over rolled lanes and extracts it with two one-hot matrix
// products; here a thread walks each block's W lanes in order and keeps,
// per pixel, the least key under a strict signed "<" (the plain version's
// int32 minimum) and beside it the z of the lane that holds that key.
// Keys tie where two lanes' z differ only in the cleared bits; the lower
// lane keeps the block then, though its z may be the larger, so the z is
// carried with the key, never taken as a minimum of its own.  At the end
// of a block the pixel reads its winner's slot id once, by the key's lane
// bits, and stores the pair (store_pixel).
//
// Layout (worklist_common.cuh, as the walks in worklist.cu): one block
// per step, P / kGroupPx threads, kGroupPx pixels a thread in one column
// of the tile where the block spans whole tile rows (P = 512, 1024), else
// in one row, so a warp's stores to a group row stay in one span of 128
// or 512 bytes.  The step's chunk is staged once as one record a lane
// (its three fields' bf16 factor pairs and constant, 16 floats), read
// with 16-byte broadcasts once for all of a thread's pixels; the slot ids
// sit apart.  Every product of a pixel coordinate (k + 0.5, k < 128: 8
// significant bits) and a bf16 factor (8 bits) is exact in FP32, so
// record_field fuses it into its add and computes the product of the
// thread's shared coordinate once; the sums keep the plain version's
// order ((dot_hi + dot_lo) + c).
//
// Bound on the H100: each (pixel, lane) test is ~20 FP32 operations (three
// fields, the coverage chain, the key and the compare), and at W = 8 the
// (n, G, P) outputs are 8 bytes a pixel a group: at 2,048 steps of P =
// 1024 and TC = 128, 5.4 GFLOP (0.080 ms at 67 TFLOP/s) against 294 MB
// (0.088 ms at 3.35 TB/s).  The first port ran one pixel a thread and
// re-read a lane's 15 staged floats from shared memory for every pixel, so
// it was bound by shared-memory issue at 7.3x its bound.

#include "worklist_common.cuh"

namespace {

using namespace vri_wl;

// Pixels a thread (kernel_turns times 2 and 8 as variants).
constexpr int kGroupPx = 4;
// A thread's pixels in one column of the tile where the block allows it,
// else in one row (kernel_turns times rows first as a variant).
constexpr bool kGroupColumnFirst = true;
// Lanes a block's loop unrolls (kernel_turns times 1 and 2 as variants).
constexpr int kGroupLaneUnroll = 4;
// Threads a block at most: P <= 1024 pixels at kGroupPx a thread, so
// the cap never binds and every P the wrapper admits (a multiple of 128)
// runs kGroupPx pixels a thread, in one column or, as kGroupPx divides
// the tile's width, in one row.
constexpr int kGroupThreads = 1024 / kGroupPx;
static_assert(kTileW % kGroupPx == 0, "a thread's pixels fit in one row");

template <int LAYOUT>
__global__ void __launch_bounds__(kGroupThreads)
    grouped_kernel(const int* __restrict__ wc,
                   const float* __restrict__ chunks, int P, int tc, int w,
                   float* __restrict__ z_out, int* __restrict__ slot_out) {
  constexpr int S = staged_rows<kBf16x2>(), RW = record_floats<kBf16x2>();
  constexpr int kPairs = all_pairs<kBf16x2>();
  extern __shared__ float4 wl_smem[];
  float* rec = reinterpret_cast<float*>(wl_smem);
  float* sid = rec + RW * tc;
  const int step = blockIdx.x;
  const int mask = ~((1 << lane_bits(tc)) - 1);
  float px[kGroupPx], py[kGroupPx];
  pixel_centers<LAYOUT, kGroupPx>(kTileW, px, py);
  stage_records<kBf16x2>(chunks + (size_t)wc[step] * 8 * 3 * tc, nullptr,
                         tc, false, 0.0f, 0.0f, rec, sid);
  __syncthreads();

  const int groups = tc / w;
  for (int g = 0; g < groups; ++g) {
    // every key is below INT_MAX (z is at most 2.0), so the block's first
    // lane sets (bk, bz) at each pixel
    int bk[kGroupPx];
    float bz[kGroupPx];
#pragma unroll
    for (int q = 0; q < kGroupPx; ++q) {
      bk[q] = 0x7fffffff;
      bz[q] = 2.0f;
    }
    const int l0 = g * w;
#pragma unroll (kGroupLaneUnroll)
    for (int l = l0; l < l0 + w; ++l) {
      float r[RW];
      load_record<RW>(rec + l * RW, r);
#pragma unroll
      for (int q = 0; q < kGroupPx; ++q) {
        const float zm = cover(
            record_field<kBf16x2, kPairs, LAYOUT>(r, px[q], py[q]),
            record_field<kBf16x2, kPairs, LAYOUT>(r + S, px[q], py[q]),
            record_field<kBf16x2, kPairs, LAYOUT>(r + 2 * S, px[q], py[q]));
        const int key = (__float_as_int(zm) & mask) | l;
        if (key < bk[q]) {
          bk[q] = key;
          bz[q] = zm;
        }
      }
    }
    const size_t row = ((size_t)step * groups + g) * P;
#pragma unroll
    for (int q = 0; q < kGroupPx; ++q)
      store_pixel(bz[q], sid[bk[q] & ~mask],
                  row + pixel_of<LAYOUT, kGroupPx>(threadIdx.x, blockDim.x, q),
                  z_out, slot_out);
  }
}

}  // namespace

extern "C" int vri_worklist_grouped(const int* wc, int n_steps,
                                    const float* chunks, int P, int tc,
                                    int w, float* z_out, int* slot_out,
                                    void* stream) {
  // P a multiple of 128 up to 1024 and W dividing TC: the wrapper's checks
  const Shape s =
      block_shape(P, kTileW, kGroupPx, kGroupThreads, kGroupColumnFirst);
  const auto kernel = s.layout == kColumn ? &grouped_kernel<kColumn>
                                           : &grouped_kernel<kRow>;
  const size_t smem = sizeof(float) * (record_floats<kBf16x2>() + 1) * tc;
  return launch(kernel, n_steps, s, smem, (cudaStream_t)stream, wc, chunks,
                P, tc, w, z_out, slot_out);
}
