// The sorted raster tier's prep (rasterize.prepare_sorted) as a pipeline
// of kernels with no host sync: triangle setup with the near-plane clip,
// the per-slot table, exact (tile, slot) emission into a fixed-size
// stream, a stable sort on the tile key and the per-tile starts, counts
// and overflow flag that kernel R (raster_tiles.cu) reads.
//
// Replaces no TPU kernel: the JAX package's prep is XLA-fused array code
// (vri_tpu/ops/rasterize.py: triangle_setup_clipped, slot coefficients,
// repeat-interleave emission, sort).  Run eagerly in PyTorch it is about
// 380 small operators and three host syncs a frame (the nonzero of the
// second clipped slots, the pair total that sizes the stream, a host
// table copied to the card); the host issuing them, not the card, set
// the frame's time.  This pipeline is one C call of twelve launches at
// 1080p (nine where the tile key fits one 8-bit radix pass).
//
// Bound: launches and latency.  At the 49k-face kitchen at 1080p the
// work is about 52k slots (a 96-byte table row each) and about 126k
// pairs sorted twice: under 20 MB moved, a few microseconds at HBM rate.
// The design keeps each stage one pass over its array:
//   1. prep_faces, one thread a face: clip-space corners, the rotation and
//      Sutherland-Hodgman clip against w = eps with the barycentric carry,
//      the cull test, the first slot's table row, tile span and pair
//      count; each block counts its second-slot crossers.
//   2. prep_extras: each block sums the crosser counts of the blocks
//      before it (no scan launch) and ranks its crossers in face order,
//      exactly nonzero(...)[:extra_cap]; the ranked crossers write their
//      second slots, the unused second slots and the pad slots are
//      written as the plain version pads them; the clip overflow is set
//      on the device.
//   3. prep_slot_sums / prep_slot_scan: an inclusive scan of the slots'
//      pair counts (64-bit), each block summing the block sums before it;
//      block 0 derives the emitted count min(total, pairs_cap) and the
//      emission overflow.
//   4. prep_emit, one thread a stream position: the position's slot by a
//      binary search of the scan, then its tile, row-major in the slot's
//      window -- a screen-spanning slot's pairs spread over the threads of
//      their positions, never one thread's loop.
//   5. An LSD radix sort of the (tile, slot) stream on the tile key's
//      ceil(log2(tiles)) bits, in passes of at most 8 bits (two at 1080p):
//      prep_hist (per-block digit counts), prep_scan_hist (one block),
//      prep_scatter (stable: positions ranked in order within a block by
//      warp match and per-warp prefix counts).  Slots ascend within a
//      tile, kernel R's tie order.
//   6. prep_bounds, one thread a tile: its start by a binary search of the
//      sorted keys, its count, and count > cap into the overflow flag.
//
// Bit equality with the plain version (rasterize.prepare_sorted_reference
// run on the card): every expression keeps PyTorch's order of operations
// and rounding, the library is built with -fmad=false, the float64 slot
// table is built in double and rounded once, and a division of a float
// tensor by a host scalar is, as PyTorch's CUDA kernel computes it, a
// product with the scalar's float reciprocal.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // sort positions a thread
constexpr int kSortTile = kThreads * kItems;  // sort positions a block
constexpr int kSlotTile = kThreads * 8;      // slots a scan block
constexpr int kMaxDigits = 256;
constexpr int kScanThreads = 1024;
constexpr int kNCoef = 24;
constexpr float kEps = 1e-4f;                // rasterize's w_eps

struct Params {
  const float* verts;         // (V, 3)
  const int* tri;             // (F, 3)
  const int* num_faces_dev;   // () on the card, or null
  long long num_faces;        // the host's count when num_faces_dev is null
  const float* view_proj;     // (4, 4) row-major
  const float* cull;          // (F,) or null
  const int* src_map;         // (F,) or null
  const unsigned char* face_mask;  // (F,) bool or null
  int F, E, S;                // faces, second-slot capacity, padded slots
  float width, height, y_offset, inv_tw, inv_th;
  int gx, gy;
  // outputs
  float* coef;                // (S, 24)
  int* src;                   // (S,)
  int* overflow;              // ()
  // scratch
  int* blk2;                  // crossers per face block
  unsigned char* cross;       // (F,) crosser flags
  int4* span;                 // (S,) rx0, ry0, cols, pairs
  long long* bsum;            // pair sums per slot block
  long long* ends;            // (S,) inclusive pair scan
  int* n_emit;                // () emitted pairs
};

// torch.clamp / clamp_min on the card: NaN passes, else max then min.
__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_f(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// rasterize._to_i32 of a floor: held inside +-2^30, then truncated.
__device__ __forceinline__ int to_i32(float v) {
  return (int)clamp_f(v, -1073741824.0f, 1073741824.0f);
}

// torch.min / torch.max over three values: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float min3(float a, float b, float c) {
  return min_nan(min_nan(a, b), c);
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return max_nan(max_nan(a, b), c);
}

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One face's clip-space corners rotated to the clip's canonical order,
// each as (x, y, z, w, b1, b2) with its source barycentrics.
struct Face {
  float c[3][6];
  int n_in;
  bool in_range;
};

__device__ void load_face(const Params& q, int i, Face& f) {
  float clip[3][4];
  const float* m = q.view_proj;
  for (int k = 0; k < 3; ++k) {
    const int v = __ldg(q.tri + 3 * i + k);
    const float x = __ldg(q.verts + 3 * v);
    const float y = __ldg(q.verts + 3 * v + 1);
    const float z = __ldg(q.verts + 3 * v + 2);
    // [v, 1] @ view_proj.T, written out as rasterize does
    for (int j = 0; j < 4; ++j)
      clip[k][j] = ((x * __ldg(m + 4 * j) + y * __ldg(m + 4 * j + 1)) +
                    z * __ldg(m + 4 * j + 2)) + __ldg(m + 4 * j + 3);
  }
  bool inside[3];
  int n_in = 0, idx_in = -1, idx_out = -1;
  for (int k = 0; k < 3; ++k) {
    inside[k] = clip[k][3] > kEps;
    n_in += inside[k];
    if (inside[k] && idx_in < 0) idx_in = k;
    if (!inside[k] && idx_out < 0) idx_out = k;
  }
  if (idx_in < 0) idx_in = 0;
  if (idx_out < 0) idx_out = 0;
  const int rot = n_in == 1 ? idx_in : (n_in == 2 ? (idx_out + 1) % 3 : 0);
  // corner k is source vertex (k + rot) % 3; vertex 0, 1, 2 carry the
  // barycentrics (0, 0), (1, 0), (0, 1)
  for (int k = 0; k < 3; ++k) {
    const int s = (k + rot) % 3;
    for (int j = 0; j < 4; ++j) f.c[k][j] = clip[s][j];
    f.c[k][4] = s == 1 ? 1.0f : 0.0f;
    f.c[k][5] = s == 2 ? 1.0f : 0.0f;
  }
  f.n_in = n_in;
  bool ok = (long long)i < (q.num_faces_dev ? (long long)*q.num_faces_dev
                                            : q.num_faces);
  if (q.face_mask) ok = ok && q.face_mask[i];
  if (q.cull) {
    // backface culling from the homogeneous [x y w] determinant of the
    // unrotated corners
    const float(*c)[4] = clip;
    const float dhom =
        (c[0][0] * (c[1][1] * c[2][3] - c[2][1] * c[1][3]) -
         c[0][1] * (c[1][0] * c[2][3] - c[2][0] * c[1][3])) +
        c[0][3] * (c[1][0] * c[2][1] - c[2][0] * c[1][1]);
    const float cs = __ldg(q.cull + i);
    ok = ok && (cs == 0.0f || dhom * cs > 0.0f);
  }
  f.in_range = ok;
}

// Point on segment a -> b where w crosses eps (rasterize's lerp_to_plane).
__device__ void lerp_plane(const float* a, const float* b, float* out) {
  const float dw = b[3] - a[3];
  float t = (kEps - a[3]) / (fabsf(dw) > 1e-20f ? dw : 1.0f);
  t = clamp_f(t, 0.0f, 1.0f);
  for (int j = 0; j < 6; ++j) out[j] = a[j] + (b[j] - a[j]) * t;
}

__device__ void first_slot(const Face& f, float out[3][6]) {
  for (int j = 0; j < 6; ++j) out[0][j] = f.c[0][j];
  if (f.n_in == 2) {
    for (int j = 0; j < 6; ++j) out[1][j] = f.c[1][j];
    lerp_plane(f.c[1], f.c[2], out[2]);
  } else if (f.n_in == 1) {
    lerp_plane(f.c[0], f.c[1], out[1]);
    lerp_plane(f.c[0], f.c[2], out[2]);
  } else {
    for (int j = 0; j < 6; ++j) out[1][j] = f.c[1][j];
    for (int j = 0; j < 6; ++j) out[2][j] = f.c[2][j];
  }
}

__device__ void second_slot(const Face& f, float out[3][6]) {
  for (int j = 0; j < 6; ++j) out[0][j] = f.c[0][j];
  lerp_plane(f.c[1], f.c[2], out[1]);
  lerp_plane(f.c[0], f.c[2], out[2]);
}

// A slot's screen-space corners, as triangle_setup_clipped and
// _padded_setup leave them.
struct Screen {
  float tx[3], ty[3], tz[3], tw[3], b1[3], b2[3];
  bool valid;
};

__device__ void project(const Params& q, const float cn[3][6], bool valid,
                        Screen& s) {
  for (int k = 0; k < 3; ++k) {
    const float iw = 1.0f / clamp_min_f(cn[k][3], kEps);
    const float n0 = cn[k][0] * iw, n1 = cn[k][1] * iw, n2 = cn[k][2] * iw;
    s.tx[k] = (n0 * 0.5f + 0.5f) * q.width;
    s.ty[k] = (0.5f - n1 * 0.5f) * q.height - q.y_offset;
    s.tz[k] = n2;
    s.tw[k] = iw;
    s.b1[k] = cn[k][4];
    s.b2[k] = cn[k][5];
  }
  const float area = (s.tx[1] - s.tx[0]) * (s.ty[2] - s.ty[0]) -
                     (s.ty[1] - s.ty[0]) * (s.tx[2] - s.tx[0]);
  s.valid = valid && fabsf(area) > 1e-12f;
}

__device__ void pad_screen(Screen& s) {
  for (int k = 0; k < 3; ++k)
    s.tx[k] = s.ty[k] = s.tz[k] = s.tw[k] = s.b1[k] = s.b2[k] = 0.0f;
  s.valid = false;
}

// Slot s's row of the slot table (rasterize.slot_coefficients), its
// source face, tile span and pair count.
__device__ void write_slot(const Params& q, int slot, Screen& s, int src) {
  if (!s.valid)
    for (int k = 0; k < 3; ++k) s.tz[k] = 10.0f;
  const float lox = min3(s.tx[0], s.tx[1], s.tx[2]);
  const float loy = min3(s.ty[0], s.ty[1], s.ty[2]);
  const float ox = floorf(clamp_min_f(lox, 0.0f));
  const float oy = floorf(clamp_min_f(loy, 0.0f));
  float gx32[3], gy32[3];
  for (int k = 0; k < 3; ++k) {
    gx32[k] = s.tx[k] - ox;
    gy32[k] = s.ty[k] - oy;
  }
  const float area32 = (gx32[1] - gx32[0]) * (gy32[2] - gy32[0]) -
                       (gy32[1] - gy32[0]) * (gx32[2] - gx32[0]);
  const bool dead = !s.valid || fabsf(area32) <= 1e-12f;
  const double ax = (double)s.tx[0] - (double)ox;
  const double bx = (double)s.tx[1] - (double)ox;
  const double cx = (double)s.tx[2] - (double)ox;
  const double ay = (double)s.ty[0] - (double)oy;
  const double by = (double)s.ty[1] - (double)oy;
  const double cy = (double)s.ty[2] - (double)oy;
  const double az = s.tz[0], bz = s.tz[1], cz = s.tz[2];
  const double area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const double inv = dead ? 0.0 : 1.0 / area;
  const double ka1 = -(ay - cy) * inv;
  const double kb1 = (ax - cx) * inv;
  const double kc1 = (cx * (ay - cy) - cy * (ax - cx)) * inv;
  const double ka2 = -(by - ay) * inv;
  const double kb2 = (bx - ax) * inv;
  const double kc2 = (ax * (by - ay) - ay * (bx - ax)) * inv;
  const double dz1 = bz - az, dz2 = cz - az;
  const double w0 = s.tw[0], w1 = s.tw[1], w2 = s.tw[2];
  const double su0 = s.b1[0], su1 = s.b1[1], su2 = s.b1[2];
  const double sv0 = s.b2[0], sv1 = s.b2[1], sv2 = s.b2[2];
  const double au = w1 * su1 - w0 * su0, bu = w2 * su2 - w0 * su0;
  const double av = w1 * sv1 - w0 * sv0, bv = w2 * sv2 - w0 * sv0;
  const double ad = w1 - w0, bd = w2 - w0;
  const float sa = (s.tx[1] - s.tx[0]) * (s.ty[2] - s.ty[0]) -
                   (s.ty[1] - s.ty[0]) * (s.tx[2] - s.tx[0]);
  float row[kNCoef];
  row[0] = s.tx[0];
  row[1] = s.ty[0];
  row[2] = s.tx[1];
  row[3] = s.ty[1];
  row[4] = s.tx[2];
  row[5] = s.ty[2];
  row[6] = (float)((0.0f < sa) - (sa < 0.0f));
  row[7] = s.valid ? 1.0f : 0.0f;
  row[8] = (float)(dead ? 0.0 : ka1 * dz1 + ka2 * dz2);
  row[9] = (float)(dead ? 0.0 : kb1 * dz1 + kb2 * dz2);
  row[10] = (float)(dead ? 10.0 : (az + kc1 * dz1) + kc2 * dz2);
  row[11] = (float)(ka1 * au + ka2 * bu);
  row[12] = (float)(kb1 * au + kb2 * bu);
  row[13] = (float)((w0 * su0 + kc1 * au) + kc2 * bu);
  row[14] = (float)(ka1 * av + ka2 * bv);
  row[15] = (float)(kb1 * av + kb2 * bv);
  row[16] = (float)((w0 * sv0 + kc1 * av) + kc2 * bv);
  row[17] = (float)(ka1 * ad + ka2 * bd);
  row[18] = (float)(kb1 * ad + kb2 * bd);
  row[19] = (float)(dead ? 1.0 : (w0 + kc1 * ad) + kc2 * bd);
  row[20] = ox;
  row[21] = oy;
  row[22] = 0.0f;
  row[23] = 0.0f;
  float4* dst = reinterpret_cast<float4*>(q.coef + (size_t)slot * kNCoef);
  for (int j = 0; j < kNCoef / 4; ++j)
    dst[j] = make_float4(row[4 * j], row[4 * j + 1], row[4 * j + 2],
                         row[4 * j + 3]);
  q.src[slot] = src;
  // inclusive tile span of the screen bbox; its on-screen window
  const int tx0 = to_i32(floorf(lox * q.inv_tw));
  const int tx1 = to_i32(floorf(max3(s.tx[0], s.tx[1], s.tx[2]) * q.inv_tw));
  const int ty0 = to_i32(floorf(loy * q.inv_th));
  const int ty1 = to_i32(floorf(max3(s.ty[0], s.ty[1], s.ty[2]) * q.inv_th));
  const bool vis = s.valid && tx1 >= 0 && tx0 < q.gx && ty1 >= 0 &&
                   ty0 < q.gy;
  const int rx0 = clamp_i(tx0, 0, q.gx - 1);
  const int ry0 = clamp_i(ty0, 0, q.gy - 1);
  const int cols = vis ? clamp_i(tx1, 0, q.gx - 1) - rx0 + 1 : 0;
  const int rows = vis ? clamp_i(ty1, 0, q.gy - 1) - ry0 + 1 : 0;
  q.span[slot] = make_int4(rx0, ry0, cols, rows * cols);
}

__device__ __forceinline__ int face_id(const Params& q, int i) {
  return q.src_map ? __ldg(q.src_map + i) : i;
}

// Block-wide exclusive scan of one value a thread (kThreads threads);
// *total gets the block's sum.
template <typename T>
__device__ T block_exclusive(T x, T* total) {
  __shared__ T warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  T before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sum[w];
    all += warp_sum[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

// Sums of vals[0 .. b) and of vals[0 .. n), over the whole block.
template <typename T>
__device__ void block_prefix_of(const T* vals, int n, int b, T* before,
                                T* all) {
  T x = 0, y = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const T v = vals[j];
    y += v;
    if (j < b) x += v;
  }
  T tx, ty;
  block_exclusive<T>(x, &tx);
  block_exclusive<T>(y, &ty);
  *before = tx;
  *all = ty;
}

__global__ void __launch_bounds__(kThreads) prep_faces(Params q) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) *q.overflow = 0;
  int cross = 0;
  if (i < q.F) {
    Face f;
    load_face(q, i, f);
    float cn[3][6];
    first_slot(f, cn);
    Screen s;
    project(q, cn, f.n_in >= 1 && f.in_range, s);
    write_slot(q, i, s, face_id(q, i));
    cross = f.n_in == 2 && f.in_range;
    q.cross[i] = (unsigned char)cross;
  }
  int total;
  block_exclusive<int>(cross, &total);
  if (threadIdx.x == 0) q.blk2[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) prep_extras(Params q, int nbf) {
  const int b = blockIdx.x;
  int before, n2;
  block_prefix_of<int>(q.blk2, nbf, b, &before, &n2);
  if (b == 0 && threadIdx.x == 0 && n2 > q.E) *q.overflow = 1;
  // the crossers of this block's faces, ranked in face order
  if (b < nbf) {
    const int i = b * kThreads + threadIdx.x;
    const int cross = i < q.F ? q.cross[i] : 0;
    int unused;
    const int rank = before + block_exclusive<int>(cross, &unused);
    if (cross && rank < q.E) {
      Face f;
      load_face(q, i, f);
      float cn[3][6];
      second_slot(f, cn);
      Screen s;
      project(q, cn, true, s);
      write_slot(q, q.F + rank, s, face_id(q, i));
    }
  }
  // second slots no crosser took (face F - 1's, dead) and the pad slots
  const int g = b * kThreads + threadIdx.x;
  if (g < q.S - q.F && (g >= q.E || g >= n2)) {
    Screen s;
    int src = 0;
    if (g < q.E && q.F > 0) {
      Face f;
      load_face(q, q.F - 1, f);
      float cn[3][6];
      second_slot(f, cn);
      project(q, cn, false, s);
      src = face_id(q, q.F - 1);
    } else {
      pad_screen(s);
    }
    write_slot(q, q.F + g, s, src);
  }
}

__global__ void __launch_bounds__(kThreads) prep_slot_sums(Params q) {
  const int s0 = blockIdx.x * kSlotTile + threadIdx.x * 8;
  long long x = 0;
  for (int k = 0; k < 8; ++k)
    if (s0 + k < q.S) x += q.span[s0 + k].w;
  long long total;
  block_exclusive<long long>(x, &total);
  if (threadIdx.x == 0) q.bsum[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) prep_slot_scan(
    Params q, int nbs, long long pairs_cap) {
  const int b = blockIdx.x;
  long long before, all;
  block_prefix_of<long long>(q.bsum, nbs, b, &before, &all);
  const int s0 = b * kSlotTile + threadIdx.x * 8;
  int n[8];
  long long x = 0;
  for (int k = 0; k < 8; ++k) {
    n[k] = s0 + k < q.S ? q.span[s0 + k].w : 0;
    x += n[k];
  }
  long long unused;
  long long run = before + block_exclusive<long long>(x, &unused);
  for (int k = 0; k < 8; ++k) {
    run += n[k];
    if (s0 + k < q.S) q.ends[s0 + k] = run;
  }
  if (b == 0 && threadIdx.x == 0) {
    *q.n_emit = (int)(all < pairs_cap ? all : pairs_cap);
    if (all > pairs_cap) *q.overflow = 1;
  }
}

__global__ void __launch_bounds__(kThreads) prep_emit(
    Params q, unsigned* keys, int* vals) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= *q.n_emit) return;
  // the slot whose pairs hold position p: the first with ends > p
  int lo = 0, hi = q.S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (q.ends[mid] > p) hi = mid;
    else lo = mid + 1;
  }
  const int4 sp = q.span[lo];
  const int k = (int)(p - (q.ends[lo] - sp.w));
  const int dy = k / sp.z;
  const int dx = k - dy * sp.z;
  keys[p] = (unsigned)((sp.y + dy) * q.gx + sp.x + dx);
  vals[p] = lo;
}

__device__ __forceinline__ long long sort_pos(int b, int r) {
  return (long long)b * kSortTile + r * kThreads + threadIdx.x;
}

// Digit counts of each block's positions, digit-major: hist[d * nb + b].
__global__ void __launch_bounds__(kThreads) prep_hist(
    const unsigned* keys, const int* n_emit, int* hist, int nb, int shift,
    int ndig) {
  __shared__ int h[kMaxDigits];
  for (int d = threadIdx.x; d < ndig; d += kThreads) h[d] = 0;
  __syncthreads();
  const int n = *n_emit;
  for (int r = 0; r < kItems; ++r) {
    const long long p = sort_pos(blockIdx.x, r);
    if (p < n) atomicAdd(&h[(keys[p] >> shift) & (ndig - 1)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < ndig; d += kThreads)
    hist[d * nb + blockIdx.x] = h[d];
}

// Exclusive scan of hist[0 .. len) in place, one block.
__global__ void __launch_bounds__(kScanThreads) prep_scan_hist(int* hist,
                                                               int len) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < len; base += kScanThreads * 4) {
    const int i0 = base + threadIdx.x * 4;
    int v[4], x = 0;
    for (int k = 0; k < 4; ++k) {
      v[k] = i0 + k < len ? hist[i0 + k] : 0;
      x += v[k];
    }
    int inc = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    int before = carry, all = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      if (w < warp) before += warp_sum[w];
      all += warp_sum[w];
    }
    int run = before + inc - x;
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < len) hist[i0 + k] = run;
      run += v[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += all;
    __syncthreads();
  }
}

// One stable pass: each block's positions in order, round by round (a
// round is kThreads consecutive positions); a position's destination is
// its block's base for its digit, plus the digit's positions in earlier
// rounds and warps, plus its rank among its warp's peers.
__global__ void __launch_bounds__(kThreads) prep_scatter(
    const unsigned* keys_in, const int* vals_in, unsigned* keys_out,
    int* vals_out, const int* hist, const int* n_emit, int nb, int shift,
    int ndig) {
  __shared__ int cnt[kWarps][kMaxDigits];
  __shared__ int base[kMaxDigits];
  const int n = *n_emit;
  if ((long long)blockIdx.x * kSortTile >= n) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < ndig; d += kThreads) {
    base[d] = hist[d * nb + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) cnt[w][d] = 0;
  }
  __syncthreads();
  for (int r = 0; r < kItems; ++r) {
    const long long p = sort_pos(blockIdx.x, r);
    const bool live = p < n;
    unsigned key = 0;
    int val = 0, d = 0;
    if (live) {
      key = keys_in[p];
      val = vals_in[p];
      d = (int)((key >> shift) & (unsigned)(ndig - 1));
    }
    // the warp's lanes with this digit (a lane past the stream matches
    // none); the lowest of them counts them
    const unsigned peers = __match_any_sync(0xffffffffu, live ? d : -1 - lane);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && rank == 0) cnt[warp][d] = __popc(peers);
    __syncthreads();
    for (int dd = threadIdx.x; dd < ndig; dd += kThreads) {
      int run = base[dd];
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w][dd];
        cnt[w][dd] = run;
        run += c;
      }
      base[dd] = run;
    }
    __syncthreads();
    if (live) {
      const int dst = cnt[warp][d] + rank;
      keys_out[dst] = key;
      vals_out[dst] = val;
    }
    __syncthreads();
    for (int dd = threadIdx.x; dd < ndig; dd += kThreads)
      for (int w = 0; w < kWarps; ++w) cnt[w][dd] = 0;
    __syncthreads();
  }
}

__device__ __forceinline__ int lower_bound(const unsigned* keys, int n,
                                           unsigned t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < t) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) prep_bounds(
    const unsigned* keys, const int* n_emit, int num_tiles, int cap,
    int* starts, int* counts, int* overflow) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t > num_tiles) return;
  const int n = *n_emit;
  const int lo = lower_bound(keys, n, (unsigned)t);
  starts[t] = lo;
  if (t < num_tiles) {
    const int c = lower_bound(keys, n, (unsigned)t + 1u) - lo;
    counts[t] = c;
    if (c > cap) *overflow = 1;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Layout {
  size_t blk2, cross, span, bsum, ends, n_emit, keys0, vals0, keys1, vals1,
      hist, total;
  int nbf, nb2, nbs, nbp, passes, dbits;
};

Layout layout(int F, int S, long long P, int num_tiles) {
  Layout l;
  l.nbf = cdiv(F > 0 ? F : 1, kThreads);
  l.nb2 = l.nbf > cdiv(S - F, kThreads) ? l.nbf : cdiv(S - F, kThreads);
  l.nbs = cdiv(S, kSlotTile);
  l.nbp = cdiv(P > 0 ? P : 1, kSortTile);
  int bits = 1;  // of the largest tile key, num_tiles - 1
  while ((1LL << bits) < num_tiles) ++bits;
  l.passes = (bits + 7) / 8;
  l.dbits = (bits + l.passes - 1) / l.passes;
  size_t o = 0;
  l.blk2 = o;  o = align16(o + sizeof(int) * l.nbf);
  l.cross = o; o = align16(o + (size_t)(F > 0 ? F : 1));
  l.span = o;  o = align16(o + sizeof(int4) * S);
  l.bsum = o;  o = align16(o + sizeof(long long) * l.nbs);
  l.ends = o;  o = align16(o + sizeof(long long) * S);
  l.n_emit = o; o = align16(o + sizeof(int));
  l.keys0 = o; o = align16(o + sizeof(int) * P);
  l.vals0 = o; o = align16(o + sizeof(int) * P);
  l.keys1 = o; o = align16(o + sizeof(int) * P);
  l.vals1 = o; o = align16(o + sizeof(int) * P);
  l.hist = o;  o = align16(o + sizeof(int) * (size_t)(1 << l.dbits) * l.nbp);
  l.total = o;
  return l;
}

}  // namespace

// Bytes of scratch vri_raster_prep needs (faces F, padded slots S, pair
// capacity P, tiles); -1 past 2 GiB.
extern "C" int vri_raster_prep_scratch(int F, int S, long long P,
                                       int num_tiles) {
  const size_t total = layout(F, S, P, num_tiles).total;
  return total > (size_t)0x7fffffff ? -1 : (int)total;
}

extern "C" int vri_raster_prep(
    const float* verts, const int* tri, const int* num_faces_dev,
    long long num_faces, const float* view_proj, const float* cull,
    const int* src_map, const unsigned char* face_mask, int F, int E, int S,
    float width, float height, float y_offset, int tile_h, int tile_w,
    int gx, int gy, long long pairs_cap, int cap, float* coef, int* src,
    int* lists, int* starts, int* counts, int* overflow, void* scratch,
    void* stream) {
  const int num_tiles = gx * gy;
  const Layout l = layout(F, S, pairs_cap, num_tiles);
  char* base = static_cast<char*>(scratch);
  Params q;
  q.verts = verts;
  q.tri = tri;
  q.num_faces_dev = num_faces_dev;
  q.num_faces = num_faces;
  q.view_proj = view_proj;
  q.cull = cull;
  q.src_map = src_map;
  q.face_mask = face_mask;
  q.F = F;
  q.E = E;
  q.S = S;
  q.width = width;
  q.height = height;
  q.y_offset = y_offset;
  // PyTorch divides a float tensor by a host scalar as a product with the
  // scalar's float reciprocal
  q.inv_tw = 1.0f / (float)tile_w;
  q.inv_th = 1.0f / (float)tile_h;
  q.gx = gx;
  q.gy = gy;
  q.coef = coef;
  q.src = src;
  q.overflow = overflow;
  q.blk2 = reinterpret_cast<int*>(base + l.blk2);
  q.cross = reinterpret_cast<unsigned char*>(base + l.cross);
  q.span = reinterpret_cast<int4*>(base + l.span);
  q.bsum = reinterpret_cast<long long*>(base + l.bsum);
  q.ends = reinterpret_cast<long long*>(base + l.ends);
  q.n_emit = reinterpret_cast<int*>(base + l.n_emit);
  cudaStream_t st = (cudaStream_t)stream;

  prep_faces<<<l.nbf, kThreads, 0, st>>>(q);
  prep_extras<<<l.nb2, kThreads, 0, st>>>(q, l.nbf);
  prep_slot_sums<<<l.nbs, kThreads, 0, st>>>(q);
  prep_slot_scan<<<l.nbs, kThreads, 0, st>>>(q, l.nbs, pairs_cap);
  unsigned* keys[2] = {reinterpret_cast<unsigned*>(base + l.keys0),
                       reinterpret_cast<unsigned*>(base + l.keys1)};
  int* vals[2] = {reinterpret_cast<int*>(base + l.vals0),
                  reinterpret_cast<int*>(base + l.vals1)};
  int* hist = reinterpret_cast<int*>(base + l.hist);
  prep_emit<<<cdiv(pairs_cap > 0 ? pairs_cap : 1, kThreads), kThreads, 0,
              st>>>(q, keys[0], vals[0]);
  const int ndig = 1 << l.dbits;
  int in = 0;
  for (int pass = 0; pass < l.passes; ++pass) {
    const int shift = pass * l.dbits;
    const bool last = pass == l.passes - 1;
    prep_hist<<<l.nbp, kThreads, 0, st>>>(keys[in], q.n_emit, hist, l.nbp,
                                          shift, ndig);
    prep_scan_hist<<<1, kScanThreads, 0, st>>>(hist, ndig * l.nbp);
    prep_scatter<<<l.nbp, kThreads, 0, st>>>(
        keys[in], vals[in], keys[1 - in], last ? lists : vals[1 - in], hist,
        q.n_emit, l.nbp, shift, ndig);
    in = 1 - in;
  }
  prep_bounds<<<cdiv(num_tiles + 1, kThreads), kThreads, 0, st>>>(
      keys[in], q.n_emit, num_tiles, cap, starts, counts, overflow);
  return (int)cudaGetLastError();
}
