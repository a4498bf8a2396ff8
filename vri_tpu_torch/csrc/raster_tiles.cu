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
// Layout: one 256-thread block per tile_h x tile_w pixel tile (8 x 128),
// each thread holding kPx = 4 pixels of the tile (pixel p = thread +
// 256 k: every other row of one column of the 8 x 128 tile).  The block
// walks the tile's own segment of the sorted pair stream, list[start[t]
// .. start[t] + n), in chunks of kChunk slots: each thread stages one
// slot's pixel-independent terms in shared memory (raster_common.cuh:
// make_slot -- the canonical endpoint swap, x1 - x0 and y1 - y0 of each
// edge, the frame origin and the depth field), then every thread reads
// each staged slot once and applies it to its 4 pixels, keeping a (key,
// position) best for each.
// Per (pixel, slot) it runs the inside test on three edge functions in
// global pixel coordinates and evaluates depth from an affine field stored
// in the slot's local frame (origin = its screen-bbox min, held on the
// screen), at the pixel center's exact offset from that origin.  K1
// instead moved the constant term to the tile origin and evaluated at the
// tile-local pixel center, a sum of terms up to 128x the field's own
// slope that cancels on slivers.
//
// Edge precision (trap 1): every edge function is evaluated with its two
// endpoints in a canonical order, so two triangles sharing an edge
// compute it bit for bit alike and a pixel center on the shared edge
// always lands in at least one of them -- the raster is watertight.  K1
// instead tested l1, l2 >= 0 and l1 + l2 <= 1 from per-slot affine
// coefficients evaluated through a three-term bf16 split on the matrix
// unit; the two tests agree except on pixel centers within rounding of an
// edge.  All arithmetic is scalar FP32; the library is built with
// -fmad=false so every product and sum rounds separately, exactly as the
// plain PyTorch version (raster_tiles_reference) does, and the two agree
// bit for bit: the staged terms are the same expressions on the same
// operands.  A TF32 or bf16 product here would reopen the cracks the
// reference's split closed.
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
// Bound on the H100: ~30 FP32 operations per (pixel, slot) test, so the
// walk is bound by operations, not device-memory bytes.  The first port
// ran one pixel a thread in 1024-thread blocks: every (pixel, slot) test
// re-read the slot's dozen fields through L1 in each of the block's 32
// warps, and at most two blocks fit an SM.  Here a slot's fields are read
// once a thread from shared memory for 4 pixels, the per-slot terms are
// computed once a block, and an SM holds several 256-thread blocks.  A
// tile's time grows with its list: the longest lists set the tail.

#include "raster_common.cuh"

namespace {

using vri::kCoef;
using vri::kMissKey;
using vri::Slot;

// Pixels a thread: on the kitchen's 1080p lists (H100) 4 was the fastest
// of 2, 4 and 8.
constexpr int kPx = 4;
constexpr int kThreads = 1024 / kPx;  // a block: one tile of <= 1024 pixels
constexpr int kChunk = 128;           // slots staged a round

// kColumn: tile_w divides kThreads, so a thread's pixels share one column
// (one gx, and the compiler shares the terms that depend on gx alone).
template <bool kColumn>
__global__ void __launch_bounds__(kThreads)
    raster_tiles_kernel(const float* __restrict__ coef,
                        const int* __restrict__ list,
                        const int* __restrict__ start,
                        const int* __restrict__ count, int num_tx,
                        int tile_h, int tile_w, int cap,
                        float* __restrict__ z_out, int* __restrict__ slot_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 s_e0[kChunk], s_e1[kChunk], s_e2[kChunk], s_sg[kChunk],
      s_depth[kChunk];
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int npix = tile_h * tile_w;
  const float fx0 = (float)((tile % num_tx) * tile_w);
  const float fy0 = (float)((tile / num_tx) * tile_h);
  const float gx_col = fx0 + (0.5f + (float)(t % tile_w));
  float gx[kPx], gy[kPx];
  int best[kPx], win[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int p = t + k * kThreads;
    gx[k] = kColumn ? gx_col : fx0 + (0.5f + (float)(p % tile_w));
    gy[k] = fy0 + (0.5f + (float)(p / tile_w));
    best[k] = kMissKey;
    win[k] = -1;
  }
  const int s0 = start[tile];
  const int n = min(count[tile], cap);

  for (int base = 0; base < n; base += kChunk) {
    const int cnt = min(kChunk, n - base);
    __syncthreads();  // the previous chunk's slots are read
    for (int j = t; j < cnt; j += kThreads) {
      const Slot s = vri::make_slot(
          coef + (size_t)__ldg(list + s0 + base + j) * kCoef);
      s_e0[j] = s.e0;
      s_e1[j] = s.e1;
      s_e2[j] = s.e2;
      s_sg[j] = s.sg;
      s_depth[j] = s.depth;
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const Slot s{s_e0[j], s_e1[j], s_e2[j], s_sg[j], s_depth[j]};
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const int key = vri::slot_key(s, gx[k], gy[k]);
        if (key < best[k]) {
          best[k] = key;
          win[k] = base + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int p = t + k * kThreads;
    const int o = tile * npix + p;
    if (p >= npix) {
      // past a tile smaller than the block's 1024 pixels
    } else if (win[k] >= 0) {
      const int slot = list[s0 + win[k]];
      z_out[o] = __int_as_float(best[k]);
      slot_out[o] = slot;
      vri::slot_uv(coef + (size_t)slot * kCoef, gx[k], gy[k], u_out + o,
                   v_out + o);
    } else {
      z_out[o] = 3.0e38f;
      slot_out[o] = -1;
      u_out[o] = 0.0f;
      v_out[o] = 0.0f;
    }
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
    auto kernel = kThreads % tile_w == 0 ? raster_tiles_kernel<true>
                                         : raster_tiles_kernel<false>;
    kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        coef, list, start, count, num_tx, tile_h, tile_w, cap, z_out,
        slot_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
