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
// products; here one thread per pixel walks each block's W lanes in
// order with a strict "<" on the key, which picks the same lane.
//
// Layout: one block per step, one thread per pixel (P <= 1024); the
// step's chunk is staged in shared memory (worklist_common.cuh).  Bound
// on the H100: every (pixel, lane) test is ~20 FP32 operations and the
// chunk and output bytes are small beside them, so the step is bound by
// operations; the shared-memory reads are broadcasts.

#include "worklist_common.cuh"

namespace {

using namespace vri_wl;

__global__ void __launch_bounds__(1024)
    grouped_kernel(const int* __restrict__ wc,
                   const float* __restrict__ chunks, int P, int tc, int w,
                   float* __restrict__ z_out, int* __restrict__ slot_out) {
  extern __shared__ float smem[];
  const int ncol = 3 * tc;
  float* s = smem;
  float* sid = smem + staged_rows<kBf16x2>() * ncol;
  const int step = blockIdx.x;
  const int p = threadIdx.x;
  const float px = 0.5f + (float)(p % kTileW);
  const float py = 0.5f + (float)(p / kTileW);
  const int mask = ~((1 << lane_bits(tc)) - 1);

  stage_chunk<kBf16x2>(chunks + (size_t)wc[step] * 8 * ncol, nullptr, ncol,
                       tc, false, 0.0f, 0.0f, s, sid);
  __syncthreads();

  const int groups = tc / w;
  for (int g = 0; g < groups; ++g) {
    int best = 0x7fffffff;
    float bz = 2.0f, bs = 0.0f;
    for (int j = 0; j < w; ++j) {
      const int l = g * w + j;
      const float zm = covered_depth<kBf16x2>(s, ncol, tc, l, px, py);
      const int key = (__float_as_int(zm) & mask) | l;
      if (key < best) {
        best = key;
        bz = zm;
        bs = sid[l];
      }
    }
    store_pixel(bz, bs, ((size_t)step * groups + g) * P + p, z_out,
                slot_out);
  }
}

}  // namespace

extern "C" int vri_worklist_grouped(const int* wc, int n_steps,
                                    const float* chunks, int P, int tc,
                                    int w, float* z_out, int* slot_out,
                                    void* stream) {
  // P <= 1024 and W dividing TC: the wrapper's checks
  const size_t smem =
      sizeof(float) * (staged_rows<kBf16x2>() * 3 * tc + tc);
  if (n_steps > 0) {
    grouped_kernel<<<n_steps, P, smem, (cudaStream_t)stream>>>(
        wc, chunks, P, tc, w, z_out, slot_out);
  }
  return (int)cudaGetLastError();
}
