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
// What bounds it on the H100.  The function is the sorted tier's: per
// pixel the nearest of the slots whose tile span holds the pixel's tile,
// ~35 FP32 operations a (pixel, slot) test.  A chunk's bbox is the union
// of 128 slots', so a tile that overlaps it overlaps few of its slots:
// on the 49k kitchen at 1080p the tiles' live chunks hold 2,021,760
// (tile, slot) pairs for 126,385 that the sorted tier lists (16.0x).
// The first port tested every slot of a live chunk against every pixel,
// one pixel a 1024-thread block's thread, and ran 51x its bound.
//
// Layout (kernel R's, raster_tiles.cu): one block of kThreads = 1024 /
// kPx threads per tile_h x tile_w tile, each thread holding kPx pixels
// (pixel p = thread + kThreads k; where tile_w divides kThreads a
// thread's pixels share one column and its terms).  The block walks the
// global chunks, then the tile's local range, one 32-bit overlap word at
// a time: it reads a word once and visits its set bits in ascending
// order, the walk order of the plain version.  For each live chunk:
//
// * The cull.  128 threads read one slot each: its six corner floats
//   (coef columns 0-5) and its live flag (column 7).  A slot survives
//   when it is live and the tile lies in its inclusive tile span,
//   floor(min x / tile_w) <= col <= floor(max x / tile_w) and the same
//   in y: the sorted tier's emission predicate
//   (ops/rasterize.py:_tile_span) on the same floats, so the block tests
//   exactly the (tile, slot) pairs that the sorted tier lists.
// * Compaction.  Survivors rank themselves with __ballot_sync / __popc
//   (per-warp counts in shared memory, double-buffered by chunk parity
//   so a block that skips an empty chunk needs one barrier), build their
//   pixel-independent terms (raster_common.cuh:make_slot: canonical
//   edges, frame origin, depth field) and stage them in shared memory.
//   A chunk without survivors skips its pixel loop: the count is read
//   from shared memory, so the test is uniform over the block.
// * The pixel loop: every thread applies each staged slot to its kPx
//   pixels with kernel R's slot_key.  A pixel therefore sees
//   bit-identical keys in every tier.
//
// Winner rule: minimum of (z with its 7 low mantissa bits cleared, slot
// index in setup order) -- kernel R's rule, keyed on the setup index
// because the walk here runs in Morton order.  It does not depend on the
// order in which slots are tested, so the compaction changes no bit.  The
// cull changes a pixel only where a live slot covers a pixel center
// outside its own tile span (rounding on a near-degenerate sliver, 0.5
// px beyond its bbox); the sorted tier never tests that pair either, and
// the plain version applies the same predicate, so the tiers agree by
// construction.  K6 differs on purpose in two ways.  It evaluates l1 = e1 /
// area at global 1080p magnitudes, where the affine form cancels on
// slivers; the port evaluates fields at the offset from the slot's own
// origin.  And it ties on exact z by the lowest Morton index, so its
// winner among coplanar slots depends on the sort; the port's does not,
// and equals the sorted and binned tiers'.
//
// Every step is scalar FP32 and the library is built with -fmad=false,
// so the plain version (raster_ranged_reference) agrees bit for bit.
// ``pairs``, when not null, receives each tile's count of tested
// (tile, slot) pairs.

#include "raster_common.cuh"

namespace {

using vri::kCoef;
using vri::kMissKey;
using vri::Slot;

// Pixels a thread, as kernel R (raster_tiles.cu): on the kitchen's 1080p
// chunks (H100) 4 was the fastest of 1, 4 and 8.
constexpr int kPx = 4;
constexpr int kThreads = 1024 / kPx;  // a block: one tile of <= 1024 pixels
constexpr int kChunk = 128;           // slots a chunk, one staging thread each
constexpr int kChunkWarps = kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads >= kChunk, "a chunk needs one staging thread a slot");

// The sorted tier's emission predicate for slot record c and the tile at
// (col, row): the slot is live and the tile lies in its inclusive tile
// span (ops/rasterize.py:_tile_span; floor of an exact quotient).
__device__ __forceinline__ bool in_span(const float* c, float col, float row,
                                        float tile_w, float tile_h) {
  const float x0 = __ldg(c), y0 = __ldg(c + 1), x1 = __ldg(c + 2),
              y1 = __ldg(c + 3), x2 = __ldg(c + 4), y2 = __ldg(c + 5);
  const float lox = fminf(fminf(x0, x1), x2), hix = fmaxf(fmaxf(x0, x1), x2);
  const float loy = fminf(fminf(y0, y1), y2), hiy = fmaxf(fmaxf(y0, y1), y2);
  return __ldg(c + 7) > 0.5f && floorf(__fdiv_rn(lox, tile_w)) <= col &&
         col <= floorf(__fdiv_rn(hix, tile_w)) &&
         floorf(__fdiv_rn(loy, tile_h)) <= row &&
         row <= floorf(__fdiv_rn(hiy, tile_h));
}

// kColumn: tile_w divides kThreads, so a thread's pixels share one column.
template <bool kColumn>
__global__ void __launch_bounds__(kThreads)
    raster_ranged_kernel(const float* __restrict__ coef,
                         const int* __restrict__ order,
                         const int* __restrict__ ranges,
                         const unsigned* __restrict__ words, int n_global,
                         int n_words, int num_tx, int tile_h, int tile_w,
                         float* __restrict__ z_out,
                         int* __restrict__ slot_out,
                         float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ pairs) {
  __shared__ float4 s_e0[kChunk], s_e1[kChunk], s_e2[kChunk], s_sg[kChunk],
      s_depth[kChunk];
  __shared__ int s_sid[kChunk];
  __shared__ int s_warp_n[2][kChunkWarps];
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int npix = tile_h * tile_w;
  const int col = tile % num_tx, row = tile / num_tx;
  const float fx0 = (float)(col * tile_w);
  const float fy0 = (float)(row * tile_h);
  const float gx_col = fx0 + (0.5f + (float)(t % tile_w));
  float gx[kPx], gy[kPx];
  int best[kPx], best_sid[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int p = t + k * kThreads;
    gx[k] = kColumn ? gx_col : fx0 + (0.5f + (float)(p % tile_w));
    gy[k] = fy0 + (0.5f + (float)(p / tile_w));
    best[k] = kMissKey;
    best_sid[k] = 0x7fffffff;
  }
  const unsigned* tile_words = words + (size_t)tile * n_words;
  const int lane = t & 31, warp = t >> 5;
  int parity = 0, tested = 0;

  auto visit = [&](int c) {
    // the cull: one slot a staging thread
    bool keep = false;
    int sid = 0, rank = 0;
    if (t < kChunk) {
      sid = __ldg(order + (size_t)c * kChunk + t);
      keep = in_span(coef + (size_t)sid * kCoef, (float)col, (float)row,
                     (float)tile_w, (float)tile_h);
      const unsigned m = __ballot_sync(kFull, keep);
      rank = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) s_warp_n[parity][warp] = __popc(m);
    }
    __syncthreads();
    int n = 0;
#pragma unroll
    for (int w = 0; w < kChunkWarps; ++w) {
      const int cnt = s_warp_n[parity][w];
      if (w < warp) rank += cnt;
      n += cnt;
    }
    parity ^= 1;
    if (n == 0) return;  // uniform: every thread read the same counts
    if (keep) {
      const Slot s = vri::make_slot(coef + (size_t)sid * kCoef);
      s_e0[rank] = s.e0;
      s_e1[rank] = s.e1;
      s_e2[rank] = s.e2;
      s_sg[rank] = s.sg;
      s_depth[rank] = s.depth;
      s_sid[rank] = sid;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const Slot s{s_e0[j], s_e1[j], s_e2[j], s_sg[j], s_depth[j]};
      const int id = s_sid[j];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const int key = vri::slot_key(s, gx[k], gy[k]);
        if (key < best[k] ||
            (key == best[k] && key != kMissKey && id < best_sid[k])) {
          best[k] = key;
          best_sid[k] = id;
        }
      }
    }
    tested += n;
    // the next chunk stages only after its own count barrier, which no
    // thread passes before every thread has left this loop
  };
  // chunks a .. b-1 whose overlap bit is set, in ascending order
  auto walk = [&](int a, int b) {
    for (int base = a & ~31; base < b; base += 32) {
      unsigned bits = __ldg(tile_words + (base >> 5));
      if (a > base) bits &= kFull << (a - base);
      if (b - base < 32) bits &= (1u << (b - base)) - 1u;
      while (bits) {
        visit(base + __ffs(bits) - 1);
        bits &= bits - 1u;
      }
    }
  };
  walk(0, n_global);
  walk(ranges[2 * tile], ranges[2 * tile + 1]);

  if (pairs != nullptr && t == 0) pairs[tile] = tested;
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int p = t + k * kThreads;
    const int o = tile * npix + p;
    if (p >= npix) {
      // past a tile smaller than the block's 1024 pixels
    } else if (best[k] != kMissKey) {
      z_out[o] = __int_as_float(best[k]);
      slot_out[o] = best_sid[k];
      vri::slot_uv(coef + (size_t)best_sid[k] * kCoef, gx[k], gy[k],
                   u_out + o, v_out + o);
    } else {
      z_out[o] = 3.0e38f;
      slot_out[o] = -1;
      u_out[o] = 0.0f;
      v_out[o] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int vri_raster_ranged(const float* coef, const int* order,
                                 const int* ranges, const int* words,
                                 int num_tiles, int n_global, int n_words,
                                 int num_tx, int tile_h, int tile_w,
                                 float* z_out, int* slot_out, float* u_out,
                                 float* v_out, int* pairs, void* stream) {
  if (num_tiles > 0) {
    auto kernel = kThreads % tile_w == 0 ? raster_ranged_kernel<true>
                                         : raster_ranged_kernel<false>;
    kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        coef, order, ranges, (const unsigned*)words, n_global, n_words,
        num_tx, tile_h, tile_w, z_out, slot_out, u_out, v_out, pairs);
  }
  return (int)cudaGetLastError();
}
