// Kernel R: per-tile visibility walk over per-tile slot lists.
//
// Replaces the TPU visibility kernels of the sorted and binned raster
// tiers:
//   vri_tpu/ops/rasterize.py:_pass1_kernel   (K1, work-list walk)
//   vri_tpu/ops/rasterize.py:_grouped_kernel (K2, grouped short lists)
//   vri_tpu/ops/rasterize.py:_tileloop_kernel (K7, K1 with one grid step
//                                              per tile)
//   vri_tpu/ops/rasterize.py:_raster_binned_kernel (K5, group-binned lists)
// On the TPU, K2 exists to dodge the per-grid-step cost for tiles with
// short lists; a GPU has no such floor, so a short list is just a short
// loop here and one kernel serves both.  K7 is K1's contract with one
// grid step per tile -- exactly this kernel's schedule.  K5's contract is
// the nearest covering slot over one tile's list, as (z, winner): this
// kernel's without the fused (u, v).  Its TPU layers (the bf16 split on
// the matrix unit, statically unrolled subs, activity masks) have no
// counterpart here, so the binned tier hands its per-tile lists, sorted
// to setup order, to this kernel.
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
// Every tier's lists hold slot ids in ascending setup order, so the
// position order is the setup order, the key raster_ranged.cu ties on.
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

#include "raster_common.cuh"

namespace {

using vri::GlobalLoad;
using vri::kCoef;
using vri::kMissKey;

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
    const int key = vri::slot_key<GlobalLoad>(c, gx, gy);
    if (key < best) {
      best = key;
      win = i;
    }
  }

  const int o = tile * (tile_h * tile_w) + p;
  if (win >= 0) {
    const int slot = list[s0 + win];
    z_out[o] = __int_as_float(best);
    slot_out[o] = slot;
    vri::slot_uv(coef + (size_t)slot * kCoef, gx, gy, u_out + o, v_out + o);
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
