// The bounded SDF update (ops/sdf_build.py: update_cascades and
// _apply_dirty_cells) as a pipeline of kernels on fixed capacities, with
// no host sync and no size read back.
//
// Replaces no TPU kernel: the JAX package's update is XLA array code
// (vri_tpu/ops/sdf_build.py: update_cascades) over lists padded to the
// config's caps by nonzero(size=cap).  Run eagerly in PyTorch on live
// lengths, it is about a thousand small operators and a host sync for
// every dynamic shape (the dirty triangles, the dirty cells, the free
// slots, the emit voxels and their bricks); each sync drains the queue,
// so the host issuing the operators set the update's time.  Here every
// list has its cap as its size, a live count and an overflow count on the
// device, and each pass is one launch:
//   1. tri_prep, a thread a triangle: the corners, normal, AABB, table row
//      and dirty flag (_prep_tris, _tri_table), and the cascade origins.
//   2. fixed lists (compact_count / compact_write): the first cap set
//      entries of a mask in index order, their count and the rest, as
//      nonzero(size=cap) keeps and counts them; each block sums the counts
//      of the blocks before it (no scan launch).  The dirty triangles
//      (update_tri_cap), the dirty cells (update_cell_cap) after mark_cells,
//      the free slots, the new voxels' ranks and the emit voxels
//      (update_brick_cap) are such lists.
//   3. rebin_prep / rebin_scan / rebin_count: the dirty subset's cell spans,
//      pair offsets and strata in every cascade, the triangles in stratum
//      order, and each cell's pair count (atomics), which give the re-bin's
//      overflow exactly as _bin_cascades counts it.
//   4. glob_merge, a block a cascade: the global list (old entries not
//      dirty, then the dirty large triangles in order) and its rows.
//   5. cell_merge, a block a dirty cell: the merged list (old entries not
//      dirty, then the re-bin's list: the cell's dirty triangles in stratum
//      order, cut to K), written with its rows straight into the new
//      cell_rows; then the cell's occupancy against its rows and the global
//      rows, the voxels freed (alive cleared), new and to re-emit.
//   6. alloc_scatter: ascending free ids handed to the new voxels in
//      cell-major order, the brick map's scatter.
//   7. esd_pass, one launch an axis: the Chebyshev empty-space distance,
//      capped at 15, as three separable passes (the eager min-pool's fixed
//      point, bit-equal as integers).
//   8. emit_list: the emit voxels' bricks (-1 where a voxel got none) for
//      the sdf_emit kernel, which reads the live count on the device.
//   9. update_finish (after the emit): needs_full, near_drop, num_bricks,
//      the counts; march_fine and march_coarse rebuild the march tables.
//
// The clipmap scroll (scroll_cascades) has its own entry,
// vri_sdf_scroll_lists, and shares the passes from the install on:
//   S1. tri_prep as above (no dirty triangle).
//   S2. shift_cells, shift_map, shift_bricks: each state table written once
//       into its new buffer, a scrolled cascade shifted by its whole cells
//       (lists, counts, rows) or voxels (brick map; the surviving bricks'
//       voxels re-based, the bricks that scrolled out no longer alive),
//       every other cascade copied.
//   S3. mark_scroll: the dirty cells (the entering slab and the surviving
//       cells beside the moved edges), a fixed list at update_cell_cap.
//   S4. glob_scroll, a block a cascade: the fresh bin's global list for a
//       scrolled cascade, the old one otherwise, and the rows.
//   5-9 with cell_merge in its scroll mode (the fresh bin's list and rows
//       installed as they are) and no dirty-box trim of the emit.
// The fresh bin of the scrolled cascades stays in PyTorch (_bin_cascades).
//
// Bound: launches and latency.  At the animated kitchen's update (about
// 200 dirty triangles, a few hundred cells, 4k bricks) every pass but the
// emit moves a few MB; the cell_rows clone (outside, in PyTorch) and the
// emit kernel are the update's device time.  The scroll's one pass over
// cell_rows (3.8 GB at the orbit's K 3,520) is bound by bytes.
//
// Bit equality with the plain update run on the card: every float
// expression keeps PyTorch's order of operations and rounding and the
// library is built with -fmad=false; every list keeps the plain version's
// order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 11;                     // lo3 hi3 n3 nda id
constexpr int kItems = 8;                    // mask entries a thread
constexpr int kCompactPer = kThreads * kItems;
constexpr int kStage = 64;                   // rows staged a round
constexpr int kMaxS3 = 512;                  // voxels a cell
constexpr int kEsdCap = 15;
constexpr float kBig = 3.0e38f;

// torch.minimum / torch.maximum / torch.clamp: NaN wins
__device__ __forceinline__ float t_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float t_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float dot3(float ux, float uy, float uz,
                                      float vx, float vy, float vz) {
  float px = ux * vx, py = uy * vy, pz = uz * vz;
  return (px + py) + pz;
}

__device__ __forceinline__ float pad_row(int col) {
  return col < 3 ? kBig : (col < 6 ? -kBig : (col == 9 ? kBig
                                              : (col == 10 ? -1.0f : 0.0f)));
}

// Exclusive scan of one int a thread over the block (blockDim.x ==
// kThreads); *total gets the block's sum.  Every thread calls it.
__device__ int block_scan(int v, int* sh, int* total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int x = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += x;
    __syncthreads();
  }
  const int incl = sh[t];
  *total = sh[kThreads - 1];
  __syncthreads();
  return incl - v;
}

__device__ long long block_sum_ll(long long v, long long* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) sh[t] += sh[t + off];
    __syncthreads();
  }
  const long long s = sh[0];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// Fixed-capacity lists
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool mask_at(const unsigned char* mask, long long i,
                                        int invert) {
  return (mask[i] != 0) != (invert != 0);
}

__global__ void __launch_bounds__(kThreads)
compact_count(const unsigned char* __restrict__ mask, long long n, int invert,
              int* __restrict__ bcount) {
  __shared__ int sh[kThreads];
  const long long base = (long long)blockIdx.x * kCompactPer
                         + (long long)threadIdx.x * kItems;
  int c = 0;
  for (int k = 0; k < kItems; ++k)
    if (base + k < n && mask_at(mask, base + k, invert)) ++c;
  int tot;
  block_scan(c, sh, &tot);
  if (threadIdx.x == 0) bcount[blockIdx.x] = tot;
}

// idx[0, cap): the set entries' indices in order, -1 past the live count;
// rank (when given): each entry's place among the set ones, -1 where unset;
// counts: {live = min(total, cap), total}.
__global__ void __launch_bounds__(kThreads)
compact_write(const unsigned char* __restrict__ mask, long long n, int invert,
              const int* __restrict__ bcount, int nblocks, int cap,
              int* __restrict__ idx, int* __restrict__ rank,
              int* __restrict__ counts) {
  __shared__ int sh[kThreads];
  int part = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads)
    part += bcount[b];
  int off;
  block_scan(part, sh, &off);
  const long long base = (long long)blockIdx.x * kCompactPer
                         + (long long)threadIdx.x * kItems;
  int c = 0;
  for (int k = 0; k < kItems; ++k)
    if (base + k < n && mask_at(mask, base + k, invert)) ++c;
  int tot;
  int pos = off + block_scan(c, sh, &tot);
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i >= n) break;
    if (mask_at(mask, i, invert)) {
      if (pos < cap) idx[pos] = (int)i;
      if (rank != nullptr) rank[i] = pos;
      ++pos;
    } else if (rank != nullptr) {
      rank[i] = -1;
    }
  }
  if ((int)blockIdx.x == nblocks - 1) {
    const int total = off + tot;
    const int live = total < cap ? total : cap;
    for (int p = live + threadIdx.x; p < cap; p += kThreads) idx[p] = -1;
    if (threadIdx.x == 0) {
      counts[0] = live;
      counts[1] = total;
    }
  }
}

int compact_blocks(long long n) {
  const long long nb = (n + kCompactPer - 1) / kCompactPer;
  return nb < 1 ? 1 : (int)nb;
}

void fixed_list(const unsigned char* mask, long long n, int invert, int cap,
                int* idx, int* rank, int* counts, int* bcount,
                cudaStream_t st) {
  const int nb = compact_blocks(n);
  compact_count<<<nb, kThreads, 0, st>>>(mask, n, invert, bcount);
  compact_write<<<nb, kThreads, 0, st>>>(mask, n, invert, bcount, nb, cap,
                                         idx, rank, counts);
}

// ---------------------------------------------------------------------------
// The update's arguments and scratch
// ---------------------------------------------------------------------------

}  // namespace

// Every field 8 bytes (pointers, long long, double): the ctypes mirror in
// ops/sdf_build.py (_UpdateArgs) lists the same fields in this order.
struct UpdateArgs {
  // inputs
  const float* verts;
  const int* tri_vertices;
  long long F;
  const int* num_faces_dev;      // null: num_faces_host
  long long num_faces_host;
  const unsigned char* dirty_in;
  const float* center;
  const float* vs;
  long long N;
  long long r;
  const float* dlo;
  const float* dhi;
  long long D;
  double trunc;
  double emit_reach;
  long long K;
  long long Kg;
  long long ucap;
  long long ccap;
  long long bcap;
  long long pairs_cap;
  long long max_bricks;
  const int* cell_tris_old;
  const int* glob_old;
  const int* bm_old;
  // per-triangle outputs
  float* tri9;
  unsigned char* valid;
  unsigned char* dirty;
  float* tri_n;
  float* lo;
  float* hi;
  float* table;
  float* origins;
  // the new state and cascades (clones of the old where they are edited)
  int* cell_tris;
  int* cell_count;
  float* cell_rows;
  int* glob_tris;
  float* glob_rows;
  unsigned char* alive;
  int* brick_voxel;
  int* brick_map;
  unsigned char* emit_bricks;
  long long* elist;
  long long elen;
  long long share_lo;
  long long share_hi;
  long long* near_out;
  long long n_near;
  const void* atlas;
  long long atlas_u8;
  long long bsz;
  double surf_thresh;
  double u8_scale;
  long long march_ok;
  int* march_coarse;
  int* march_fine0;
  int* march_fine1;
  long long* out;                // needs_full, near_drop, brick_overflow,
                                 // list_overflow, cells, bricks
  int* num_bricks;
  int* emit_count;               // the emit list's live count
  // the scroll's (null or 0 in the update): bm_old above is then the
  // shifted brick map the dirty cells diff against, cell_tris_old and
  // glob_old the old lists; the fresh bin holds the scrolled cascades in
  // cascade order
  const float* center_old;
  long long scrolled;            // bit n: cascade n scrolls
  const int* cell_count_old;
  const float* cell_rows_old;
  const unsigned char* alive_old;
  const int* brick_voxel_old;
  const int* brick_map_old;
  const int* fresh_tris;         // (S, 4096, K)
  const int* fresh_count;        // (S, 4096)
  const int* fresh_glob;         // (S, Kg)
  const long long* fresh_over;   // (S,)
  long long* entering;           // the entering cells
  void* scratch;
};

namespace {

// Scratch layout: each part 256-byte aligned.
struct Layout {
  size_t counts, accum, dcount, ccount, fcount, ncount, ecount, bcount;
  size_t dlist, clist, rec0, strat, ext, cumb, order, nsmall, total, nlarge,
      gcount, cellm, occm, newm, emitm, rank, freel, epos, g1, g2, cellocc;
  size_t zero_bytes;  // [0, zero_bytes) is zeroed before the pipeline
  size_t size;
};

size_t up(size_t x) { return (x + 255) & ~size_t(255); }

Layout layout(const UpdateArgs& a) {
  const long long s = a.r / 16;
  const long long s3 = s * s * s;
  const long long cv = a.ccap * s3;             // voxels of the cell list
  const long long r3 = a.r * a.r * a.r;
  long long mx = a.F;
  if (a.N * 4096 > mx) mx = a.N * 4096;
  if (a.max_bricks > mx) mx = a.max_bricks;
  if (cv > mx) mx = cv;
  Layout l;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += up(bytes);
    return at;
  };
  l.counts = take(sizeof(int) * a.N * 4096);
  l.accum = take(sizeof(long long) * 4);        // list overflow, glob
                                                // overflow, bricks
  l.zero_bytes = o;
  l.dcount = take(sizeof(int) * 2);
  l.ccount = take(sizeof(int) * 2);
  l.fcount = take(sizeof(int) * 2);
  l.ncount = take(sizeof(int) * 2);
  l.ecount = take(sizeof(int) * 2);
  l.bcount = take(sizeof(int) * compact_blocks(mx));
  l.dlist = take(sizeof(int) * a.ucap);
  l.clist = take(sizeof(int) * a.ccap);
  l.rec0 = take(sizeof(int) * a.N * a.ucap);
  l.strat = take(sizeof(int) * a.N * a.ucap);
  l.ext = take(sizeof(int) * a.N * a.ucap);
  l.cumb = take(sizeof(int) * a.N * a.ucap);
  l.order = take(sizeof(int) * a.N * a.ucap);
  l.nsmall = take(sizeof(int) * a.N);
  l.total = take(sizeof(int) * a.N);
  l.nlarge = take(sizeof(int) * a.N);
  l.gcount = take(sizeof(int) * a.N);
  l.cellm = take(a.N * 4096);
  l.occm = take(cv);
  l.newm = take(cv);
  l.emitm = take(cv);
  l.rank = take(sizeof(int) * cv);
  l.freel = take(sizeof(int) * cv);
  l.epos = take(sizeof(int) * a.bcap);
  l.g1 = take(a.N * r3);
  l.g2 = take(a.N * r3);
  l.cellocc = take(a.N * 4096);
  l.size = o;
  return l;
}

struct Scratch {
  int *counts, *dcount, *ccount, *fcount, *ncount, *ecount, *bcount;
  long long* accum;
  int *dlist, *clist, *rec0, *strat, *ext, *cumb, *order, *nsmall, *total,
      *nlarge, *gcount, *rank, *freel, *epos;
  unsigned char *cellm, *occm, *newm, *emitm, *g1, *g2, *cellocc;
};

Scratch scratch(const UpdateArgs& a) {
  const Layout l = layout(a);
  char* b = static_cast<char*>(a.scratch);
  Scratch s;
  s.counts = reinterpret_cast<int*>(b + l.counts);
  s.accum = reinterpret_cast<long long*>(b + l.accum);
  s.dcount = reinterpret_cast<int*>(b + l.dcount);
  s.ccount = reinterpret_cast<int*>(b + l.ccount);
  s.fcount = reinterpret_cast<int*>(b + l.fcount);
  s.ncount = reinterpret_cast<int*>(b + l.ncount);
  s.ecount = reinterpret_cast<int*>(b + l.ecount);
  s.bcount = reinterpret_cast<int*>(b + l.bcount);
  s.dlist = reinterpret_cast<int*>(b + l.dlist);
  s.clist = reinterpret_cast<int*>(b + l.clist);
  s.rec0 = reinterpret_cast<int*>(b + l.rec0);
  s.strat = reinterpret_cast<int*>(b + l.strat);
  s.ext = reinterpret_cast<int*>(b + l.ext);
  s.cumb = reinterpret_cast<int*>(b + l.cumb);
  s.order = reinterpret_cast<int*>(b + l.order);
  s.nsmall = reinterpret_cast<int*>(b + l.nsmall);
  s.total = reinterpret_cast<int*>(b + l.total);
  s.nlarge = reinterpret_cast<int*>(b + l.nlarge);
  s.gcount = reinterpret_cast<int*>(b + l.gcount);
  s.cellm = reinterpret_cast<unsigned char*>(b + l.cellm);
  s.occm = reinterpret_cast<unsigned char*>(b + l.occm);
  s.newm = reinterpret_cast<unsigned char*>(b + l.newm);
  s.emitm = reinterpret_cast<unsigned char*>(b + l.emitm);
  s.rank = reinterpret_cast<int*>(b + l.rank);
  s.freel = reinterpret_cast<int*>(b + l.freel);
  s.epos = reinterpret_cast<int*>(b + l.epos);
  s.g1 = reinterpret_cast<unsigned char*>(b + l.g1);
  s.g2 = reinterpret_cast<unsigned char*>(b + l.g2);
  s.cellocc = reinterpret_cast<unsigned char*>(b + l.cellocc);
  return s;
}

// Kernels take the argument block by value (it fits the 4 KB of kernel
// parameters) and the scratch pointers.

// ---------------------------------------------------------------------------
// 1. per-triangle data
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
tri_prep(UpdateArgs a) {
  const long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (f < a.N * 3) {
    // cascade_origin: center - (0.5 * r) * vs
    const float half_r = (float)(0.5 * (double)a.r);
    a.origins[f] = a.center[f] - half_r * a.vs[f / 3];
  }
  if (f >= a.F) return;
  const long long nf = a.num_faces_dev != nullptr ? *a.num_faces_dev
                                                  : a.num_faces_host;
  const bool ok = f < nf;
  float p[3][3];
  for (int j = 0; j < 3; ++j) {
    const long long vi = a.tri_vertices[f * 3 + j];
    for (int k = 0; k < 3; ++k) {
      p[j][k] = a.verts[vi * 3 + k];
      a.tri9[f * 9 + j * 3 + k] = p[j][k];
    }
  }
  // _prep_tris: n = cross(b - a, c - a) / clamp(norm3(n), min=1e-20)
  float u[3], v[3];
  for (int k = 0; k < 3; ++k) {
    u[k] = p[1][k] - p[0][k];
    v[k] = p[2][k] - p[0][k];
  }
  const float cr[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                       u[0] * v[1] - u[1] * v[0]};
  const float len = sqrtf(dot3(cr[0], cr[1], cr[2], cr[0], cr[1], cr[2]));
  const float den = len != len ? len : fmaxf(len, 1e-20f);
  float nrm[3], lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    nrm[k] = cr[k] / den;
    lo[k] = t_min(t_min(p[0][k], p[1][k]), p[2][k]);
    hi[k] = t_max(t_max(p[0][k], p[1][k]), p[2][k]);
    a.tri_n[f * 3 + k] = nrm[k];
    a.lo[f * 3 + k] = lo[k];
    a.hi[f * 3 + k] = hi[k];
  }
  // _tri_table: lo3 hi3 n3 nda id, the pad row where not valid
  const float nda = dot3(nrm[0], nrm[1], nrm[2], p[0][0], p[0][1], p[0][2]);
  const float row[kRow] = {lo[0], lo[1], lo[2], hi[0], hi[1], hi[2],
                           nrm[0], nrm[1], nrm[2], nda, (float)f};
  for (int c = 0; c < kRow; ++c)
    a.table[f * kRow + c] = ok ? row[c] : pad_row(c);
  a.valid[f] = ok;
  a.dirty[f] = ok && a.dirty_in != nullptr && a.dirty_in[f];
}

// ---------------------------------------------------------------------------
// 2. dirty cells: each cell whose box meets a dirty box grown by
//    truncation + 1 voxels, in every cascade
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mark_cells(UpdateArgs a, unsigned char* __restrict__ cellm) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.N * 4096) return;
  const int n = (int)(g / 4096), cell = (int)(g % 4096);
  const int c[3] = {cell % 16, (cell / 16) % 16, cell / 256};
  const float v = a.vs[n];
  const float cw = v * (float)(a.r / 16);
  const float e = (float)a.trunc * v + v;
  float ax[3];
  for (int k = 0; k < 3; ++k) ax[k] = a.origins[n * 3 + k] + (float)c[k] * cw;
  bool any = false;
  for (long long d = 0; d < a.D; ++d) {
    bool ok = true;
    for (int k = 0; k < 3; ++k)
      ok = ok && (ax[k] <= a.dhi[d * 3 + k] + e)
           && (ax[k] + cw >= a.dlo[d * 3 + k] - e);
    any = any || ok;
  }
  cellm[g] = any;
}

// ---------------------------------------------------------------------------
// 3. the dirty subset's re-bin (_pair_emission / _bin_cascades over the
//    dirty list padded to update_tri_cap)
// ---------------------------------------------------------------------------

// rec0 bits: clo x, y, z (4 each), span - 1 x, y, z (4 each), small, large
__device__ __forceinline__ int rec_lo(int rec, int k) {
  return (rec >> (4 * k)) & 15;
}
__device__ __forceinline__ int rec_span(int rec, int k) {
  return ((rec >> (12 + 4 * k)) & 15) + 1;
}
__device__ __forceinline__ bool rec_small(int rec) { return (rec >> 24) & 1; }
__device__ __forceinline__ bool rec_large(int rec) { return (rec >> 25) & 1; }

__global__ void __launch_bounds__(kThreads)
rebin_prep(UpdateArgs a, Scratch s) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (t >= a.ucap) return;
  const long long at = n * a.ucap + t;
  const bool ok = t < s.dcount[0];
  const long long gid = ok ? s.dlist[t] : 0;
  const float v = a.vs[n];
  const float cw = (float)(a.r / 16) * v;   // s * vs
  const float e = 1.0f * v;                 // reach_vox * vs
  int clo[3], chi[3];
  float tlo[3], thi[3];
  for (int k = 0; k < 3; ++k) {
    tlo[k] = a.lo[gid * 3 + k];
    thi[k] = a.hi[gid * 3 + k];
    const float org = a.origins[n * 3 + k];
    clo[k] = (int)floorf(((tlo[k] - e) - org) / cw);
    chi[k] = (int)floorf(((thi[k] + e) - org) / cw);
  }
  bool inside = ok, small = true;
  int rec = 0, ext = 1;
  for (int k = 0; k < 3; ++k) {
    inside = inside && chi[k] >= 0 && clo[k] < 16;
    const int lc = clo[k] < 0 ? 0 : (clo[k] > 15 ? 15 : clo[k]);
    const int hc = chi[k] < 0 ? 0 : (chi[k] > 15 ? 15 : chi[k]);
    const int span = hc - lc + 1;
    // the unclipped span, in int32 as PyTorch wraps it
    const int raw = (int)((unsigned)chi[k] - (unsigned)clo[k] + 1u);
    small = small && raw <= 8;
    ext *= span;
    rec |= (lc << (4 * k)) | (((span - 1) & 15) << (12 + 4 * k));
  }
  small = small && inside;
  const bool large = inside && !small;
  rec |= ((int)small << 24) | ((int)large << 25);
  // the stratum: 2 bits an axis of the centroid's place in its cell
  const float cellw = v * (float)(a.r / 16);
  int st3[3];
  for (int k = 0; k < 3; ++k) {
    const float centroid = 0.5f * (tlo[k] + thi[k]);
    const float frac = (centroid - a.origins[n * 3 + k]) / cellw;
    const int q = (int)((frac - floorf(frac)) * 4.0f);
    st3[k] = q < 0 ? 0 : (q > 3 ? 3 : q);
  }
  s.rec0[at] = rec;
  s.strat[at] = (st3[2] << 4) | (st3[1] << 2) | st3[0];
  s.ext[at] = small ? ext : 0;
}

// A block a cascade: pair offsets (an exclusive scan of the pair counts),
// the pair total, the small triangles in (stratum, index) order -- the
// order of a cell's pairs after the stable sort -- and the large count.
__global__ void __launch_bounds__(kThreads)
rebin_scan(UpdateArgs a, Scratch s) {
  __shared__ int sh[kThreads];
  __shared__ int hist[64];
  __shared__ int chunk[kThreads];
  const int n = blockIdx.x;
  const int nd = s.dcount[0];
  const long long row = n * a.ucap;
  int running = 0, large = 0;
  for (int base = 0; base < nd; base += kThreads) {
    const int t = base + threadIdx.x;
    const int e = t < nd ? s.ext[row + t] : 0;
    const int lg = t < nd && rec_large(s.rec0[row + t]);
    int tot, ltot;
    const int pre = block_scan(e, sh, &tot);
    block_scan(lg, sh, &ltot);
    if (t < nd) s.cumb[row + t] = running + pre;
    running += tot;
    large += ltot;
  }
  if (threadIdx.x < 64) hist[threadIdx.x] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < nd; t += kThreads)
    if (rec_small(s.rec0[row + t])) atomicAdd(&hist[s.strat[row + t]], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int b = 0; b < 64; ++b) {
      const int c = hist[b];
      hist[b] = acc;
      acc += c;
    }
    s.nsmall[n] = acc;
    s.total[n] = running;
    s.nlarge[n] = large;
  }
  __syncthreads();
  for (int base = 0; base < nd; base += kThreads) {
    const int t = base + threadIdx.x;
    chunk[threadIdx.x] = (t < nd && rec_small(s.rec0[row + t]))
                             ? s.strat[row + t] : -1;
    __syncthreads();
    if (threadIdx.x < 64) {
      const int b = threadIdx.x;
      const int m = nd - base < kThreads ? nd - base : kThreads;
      int at = hist[b];
      for (int j = 0; j < m; ++j)
        if (chunk[j] == b) s.order[row + at++] = base + j;
      hist[b] = at;
    }
    __syncthreads();
  }
}

// Each live pair of the dirty subset counted in its cell (the cells' list
// demand, whose excess over K is the re-bin's overflow).
__global__ void __launch_bounds__(kThreads)
rebin_count(UpdateArgs a, Scratch s) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (t >= s.dcount[0]) return;
  const long long at = n * a.ucap + t;
  const int rec = s.rec0[at];
  if (!rec_small(rec)) return;
  const long long cb = s.cumb[at];
  const int nx = rec_span(rec, 0), ny = rec_span(rec, 1),
            nz = rec_span(rec, 2);
  const int lx = rec_lo(rec, 0), ly = rec_lo(rec, 1), lz = rec_lo(rec, 2);
  for (int dz = 0; dz < nz; ++dz)
    for (int dy = 0; dy < ny; ++dy)
      for (int dx = 0; dx < nx; ++dx) {
        const long long k = (long long)(dz * ny + dy) * nx + dx;
        if (cb + k >= a.pairs_cap) return;
        const int cell = (lz + dz) * 256 + (ly + dy) * 16 + (lx + dx);
        atomicAdd(&s.counts[n * 4096 + cell], 1);
      }
}

// ---------------------------------------------------------------------------
// 4. the global lists: old entries not dirty, then the dirty large ones
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
glob_merge(UpdateArgs a, Scratch s) {
  __shared__ int sh[kThreads];
  const int n = blockIdx.x;
  const int Kg = (int)a.Kg;
  const int nd = s.dcount[0];
  int* out = a.glob_tris + (long long)n * Kg;
  int kept = 0;
  for (int base = 0; base < Kg; base += kThreads) {
    const int i = base + threadIdx.x;
    const int id = i < Kg ? a.glob_old[(long long)n * Kg + i] : -1;
    const int keep = id >= 0 && !a.dirty[id];
    int tot;
    const int pre = block_scan(keep, sh, &tot);
    if (keep) out[kept + pre] = id;
    kept += tot;
  }
  int added = 0;
  for (int base = 0; base < nd; base += kThreads) {
    const int t = base + threadIdx.x;
    const int lg = t < nd && rec_large(s.rec0[(long long)n * a.ucap + t]);
    int tot;
    const int p = added + block_scan(lg, sh, &tot);
    if (lg && p < Kg && kept + p < Kg) out[kept + p] = s.dlist[t];
    added += tot;
  }
  const int merged = kept + (added < Kg ? added : Kg);
  const int live = merged < Kg ? merged : Kg;
  for (int i = live + threadIdx.x; i < Kg; i += kThreads) out[i] = -1;
  if (threadIdx.x == 0) {
    s.gcount[n] = live;
    if (merged > Kg) atomicAdd((unsigned long long*)&s.accum[1],
                               (unsigned long long)(merged - Kg));
  }
  __syncthreads();
  float* rows = a.glob_rows + (long long)n * Kg * kRow;
  for (long long i = threadIdx.x; i < (long long)Kg * kRow; i += kThreads) {
    const int id = out[i / kRow];
    const int col = (int)(i % kRow);
    rows[i] = id >= 0 ? a.table[(long long)id * kRow + col] : pad_row(col);
  }
}

// ---------------------------------------------------------------------------
// 5. a block a dirty cell: merge, rows, occupancy, the voxels' diff
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cell_coords(int cell, int* c) {
  c[0] = cell % 16;
  c[1] = (cell / 16) % 16;
  c[2] = cell / 256;
}

// voxel v of cell (cascade n, cell coordinates c) at resolution r: its
// flat id and (when q is given) its center (_cell_meta)
__device__ __forceinline__ long long voxel(long long r, const float* vs,
                                           const float* origins, int n,
                                           const int* c, int v, float* q) {
  const int s = (int)(r / 16);
  const int l[3] = {v % s, (v / s) % s, v / (s * s)};
  int w[3];
  for (int k = 0; k < 3; ++k) {
    w[k] = c[k] * s + l[k];
    if (q != nullptr)
      q[k] = origins[n * 3 + k] + ((float)w[k] + 0.5f) * vs[n];
  }
  return (long long)n * r * r * r + ((long long)w[2] * r + w[1]) * r + w[0];
}

// The update's list of a dirty cell: (old minus dirty) ++ the re-bin's
// list, cut to K; returns its live length.
__device__ int merge_list(const UpdateArgs& a, const Scratch& s, int cg,
                          int n, const int* c, int* sh) {
  const int K = (int)a.K;
  const long long lrow = (long long)cg * K;
  const int* old = a.cell_tris_old + lrow;
  int* lst = a.cell_tris + lrow;

  // (old minus dirty) in order
  int kept = 0;
  for (int base = 0; base < K; base += kThreads) {
    const int i = base + threadIdx.x;
    const int id = i < K ? old[i] : -1;
    const int keep = id >= 0 && !a.dirty[id];
    int tot;
    const int pre = block_scan(keep, sh, &tot);
    if (keep) lst[kept + pre] = id;
    kept += tot;
  }
  // ++ the re-bin's list: the cell's live pairs in (stratum, index) order,
  // the first K of them
  const long long row = (long long)n * a.ucap;
  const int ns = s.nsmall[n];
  int added = 0;
  for (int base = 0; base < ns; base += kThreads) {
    const int i = base + threadIdx.x;
    int hit = 0, t = 0;
    if (i < ns) {
      t = s.order[row + i];
      const int rec = s.rec0[row + t];
      bool in = true;
      int d[3];
      for (int k = 0; k < 3; ++k) {
        d[k] = c[k] - rec_lo(rec, k);
        in = in && d[k] >= 0 && d[k] < rec_span(rec, k);
      }
      if (in) {
        const long long kl = (long long)(d[2] * rec_span(rec, 1) + d[1])
                             * rec_span(rec, 0) + d[0];
        hit = (long long)s.cumb[row + t] + kl < a.pairs_cap;
      }
    }
    int tot;
    const int p = added + block_scan(hit, sh, &tot);
    if (hit && p < K && kept + p < K) lst[kept + p] = s.dlist[t];
    added += tot;
  }
  const int merged = kept + (added < K ? added : K);
  const int live = merged < K ? merged : K;
  for (int i = live + threadIdx.x; i < K; i += kThreads) lst[i] = -1;
  if (threadIdx.x == 0 && merged > K)
    atomicAdd((unsigned long long*)&s.accum[0],
              (unsigned long long)(merged - K));
  return live;
}

// Scrolled cascade n's place in the fresh bin (the scrolled cascades in
// cascade order).
__device__ __forceinline__ int fresh_slot(const UpdateArgs& a, int n) {
  return __popcll(a.scrolled & ((1ll << n) - 1));
}

// The scroll's list of a dirty cell: the fresh bin's, as it is; returns
// its live length.
__device__ int fresh_list(const UpdateArgs& a, int cg, int n) {
  const int K = (int)a.K;
  const long long at = (long long)fresh_slot(a, n) * 4096 + cg % 4096;
  const int* src = a.fresh_tris + at * K;
  int* lst = a.cell_tris + (long long)cg * K;
  for (int i = threadIdx.x; i < K; i += kThreads) lst[i] = src[i];
  return a.fresh_count[at];
}

// kScroll: the update's merge and its emit trimmed by the D dirty boxes
// (false), or the scroll's fresh list and every occupied voxel emitted.
template <bool kScroll>
__global__ void __launch_bounds__(kThreads)
cell_merge(UpdateArgs a, Scratch s) {
  __shared__ int sh[kThreads];
  __shared__ float stage[kStage * kRow];
  __shared__ int occf[kMaxS3];
  const int ci = blockIdx.x;
  const int sc = (int)(a.r / 16);
  const int s3 = sc * sc * sc;
  const long long mbase = (long long)ci * s3;
  if (ci >= s.ccount[0]) {
    for (int v = threadIdx.x; v < s3; v += kThreads) {
      s.occm[mbase + v] = 0;
      s.newm[mbase + v] = 0;
      s.emitm[mbase + v] = 0;
    }
    return;
  }
  const int K = (int)a.K;
  const int cg = s.clist[ci];
  const int n = cg / 4096;
  int c[3];
  cell_coords(cg % 4096, c);
  const long long lrow = (long long)cg * K;
  const int* lst = a.cell_tris + lrow;
  int live;
  if constexpr (kScroll)
    live = fresh_list(a, cg, n);
  else
    live = merge_list(a, s, cg, n, c, sh);
  if (threadIdx.x == 0) a.cell_count[cg] = live;
  __syncthreads();
  // the rows, straight into the new cell_rows
  float* rows = a.cell_rows + lrow * kRow;
  for (long long i = threadIdx.x; i < (long long)K * kRow; i += kThreads) {
    const int id = lst[i / kRow];
    const int col = (int)(i % kRow);
    rows[i] = id >= 0 ? a.table[(long long)id * kRow + col] : pad_row(col);
  }
  for (int v = threadIdx.x; v < s3; v += kThreads) occf[v] = 0;
  __syncthreads();

  // occupancy (_occupancy_cells): a voxel center inside a row's AABB grown
  // by one voxel and within voxel + half diagonal of its plane; the cell's
  // live rows, then the cascade's global rows
  const float vsz = a.vs[n];
  const int vt = s3 < kThreads ? s3 : kThreads;   // voxels a round
  const int groups = kThreads / vt;
  const int g = threadIdx.x / vt;
  const int gl = live;
  const int gn = s.gcount[n];
  const float* grows = a.glob_rows + (long long)n * a.Kg * kRow;
  const float reach = 1.8660254f * vsz;
  for (int v0 = 0; v0 < s3; v0 += vt) {
    const int v = v0 + threadIdx.x % vt;
    const bool mine = g < groups && v < s3;
    float q[3] = {0.f, 0.f, 0.f};
    if (mine) voxel(a.r, a.vs, a.origins, n, c, v, q);
    bool hit = false;
    for (int r0 = 0; r0 < gl + gn; r0 += kStage) {
      const int m = gl + gn - r0 < kStage ? gl + gn - r0 : kStage;
      for (int i = threadIdx.x; i < m * kRow; i += kThreads) {
        const int j = r0 + i / kRow;
        stage[i] = j < gl ? rows[(long long)j * kRow + i % kRow]
                          : grows[(long long)(j - gl) * kRow + i % kRow];
      }
      __syncthreads();
      if (mine && !hit) {
        for (int j = g; j < m; j += groups) {
          const float* rw = stage + j * kRow;
          bool box = true;
          for (int k = 0; k < 3; ++k)
            box = box && q[k] >= rw[k] - vsz && q[k] <= rw[3 + k] + vsz;
          const float dd = dot3(q[0], q[1], q[2], rw[6], rw[7], rw[8])
                           - rw[9];
          if (box && fabsf(dd) <= reach) {
            hit = true;
            break;
          }
        }
      }
      __syncthreads();
    }
    if (hit) occf[v] = 1;
  }
  __syncthreads();

  // the voxels: freed (alive cleared), new, to re-emit (the update's
  // within reach of the dirty boxes)
  const float half = 0.5f * vsz;
  const float e = (float)a.emit_reach * vsz;
  for (int v = threadIdx.x; v < s3; v += kThreads) {
    float q[3];
    const long long vox = voxel(a.r, a.vs, a.origins, n, c, v, q);
    const int oid = a.bm_old[vox];
    const bool occ = occf[v] != 0;
    if (oid >= 0 && !occ && oid < a.max_bricks) a.alive[oid] = 0;
    bool near = kScroll;
    if constexpr (!kScroll) {
      for (long long d = 0; d < a.D; ++d) {
        bool ok = true;
        for (int k = 0; k < 3; ++k)
          ok = ok && (q[k] - half <= a.dhi[d * 3 + k] + e)
               && (q[k] + half >= a.dlo[d * 3 + k] - e);
        near = near || ok;
      }
    }
    s.occm[mbase + v] = occ;
    s.newm[mbase + v] = oid < 0 && occ;
    s.emitm[mbase + v] = occ && near;
  }
}

// ---------------------------------------------------------------------------
// 6. allocation and the brick map's scatter
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
alloc_scatter(UpdateArgs a, Scratch s) {
  const int sc = (int)(a.r / 16);
  const int s3 = sc * sc * sc;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.ccap * s3) return;
  const int ci = (int)(p / s3), v = (int)(p % s3);
  if (ci >= s.ccount[0]) return;
  const int cg = s.clist[ci];
  int c[3];
  cell_coords(cg % 4096, c);
  const long long vox = voxel(a.r, a.vs, a.origins, cg / 4096, c, v, nullptr);
  const int oid = a.bm_old[vox];
  int slot = -1;
  if (s.newm[p]) {
    const int rk = s.rank[p];
    if (rk < s.fcount[1]) slot = s.freel[rk];
    if (slot >= 0) {
      a.alive[slot] = 1;
      a.brick_voxel[slot] = (int)vox;
    }
  }
  a.brick_map[vox] = s.occm[p] ? (oid >= 0 ? oid : slot) : -1;
}

// ---------------------------------------------------------------------------
// 7. the empty-space distance: min(15, Chebyshev distance to the nearest
//    occupied voxel) of each cascade, one axis a pass
// ---------------------------------------------------------------------------

// line (n, i, j) along axis: voxel index of element x
__device__ __forceinline__ long long line_at(long long r, int axis, int n,
                                             int i, int j, int x) {
  const long long base = (long long)n * r * r * r;
  if (axis == 0) return base + ((long long)i * r + j) * r + x;   // (z, y)
  if (axis == 1) return base + ((long long)i * r + x) * r + j;   // (z, x)
  return base + ((long long)x * r + i) * r + j;                  // (y, x)
}

// pass 0: distance along x from the occupancy; 1, 2: min over the axis of
// max(|offset|, previous); pass 2 writes -max(esd, 1) into the empty
// voxels of the brick map
__global__ void esd_pass(UpdateArgs a, Scratch s, int axis) {
  extern __shared__ unsigned char line[];
  const int r = (int)a.r;
  const int n = blockIdx.z, i = blockIdx.y, j = blockIdx.x;
  for (int x = threadIdx.x; x < r; x += blockDim.x) {
    const long long at = line_at(r, axis, n, i, j, x);
    line[x] = axis == 0 ? (a.brick_map[at] >= 0 ? 0 : kEsdCap)
                        : (axis == 1 ? s.g1[at] : s.g2[at]);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < r; x += blockDim.x) {
    int d = kEsdCap;
    for (int o = -kEsdCap; o <= kEsdCap; ++o) {
      const int y = x + o;
      if (y < 0 || y >= r) continue;
      const int ao = o < 0 ? -o : o;
      const int m = ao > line[y] ? ao : line[y];
      d = m < d ? m : d;
    }
    const long long at = line_at(r, axis, n, i, j, x);
    if (axis == 0) {
      s.g1[at] = (unsigned char)d;
    } else if (axis == 1) {
      s.g2[at] = (unsigned char)d;
    } else if (a.brick_map[at] < 0) {
      a.brick_map[at] = -(d < 1 ? 1 : d);
    }
  }
}

// ---------------------------------------------------------------------------
// 8. the emit list
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
emit_list(UpdateArgs a, Scratch s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.elen) return;
  const int sc = (int)(a.r / 16);
  const int s3 = sc * sc * sc;
  long long bid = -1;
  if (i < s.ecount[0]) {
    const int p = s.epos[i];
    const int cg = s.clist[p / s3];
    int c[3];
    cell_coords(cg % 4096, c);
    const int b = a.brick_map[voxel(a.r, a.vs, a.origins, cg / 4096, c,
                                    p % s3, nullptr)];
    bid = b >= 0 ? b : -1;
  }
  a.elist[i] = bid;
  if (i == 0) *a.emit_count = s.ecount[0];
  if (bid >= 0) {
    a.emit_bricks[bid] = 1;
    if (i >= a.share_lo && i < a.share_hi)
      atomicAdd((unsigned long long*)&s.accum[2], 1ull);
  }
}

// ---------------------------------------------------------------------------
// 9. the update's scalars and the march tables
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
update_scalars(UpdateArgs a, Scratch s) {
  __shared__ long long sh[kThreads];
  long long over = 0, near = 0;
  for (long long i = threadIdx.x; i < a.N * 4096; i += kThreads) {
    const int c = s.counts[i];
    over += c > a.K ? c - a.K : 0;
  }
  for (long long i = threadIdx.x; i < a.n_near; i += kThreads)
    near += a.near_out[i];
  over = block_sum_ll(over, sh);
  near = block_sum_ll(near, sh);
  if (threadIdx.x != 0) return;
  for (int n = 0; n < a.N; ++n) {
    const long long pt = s.total[n] - a.pairs_cap;
    const long long lg = s.nlarge[n] - a.Kg;
    over += (pt > 0 ? pt : 0) + (lg > 0 ? lg : 0);
  }
  const long long n_new = s.ncount[1], n_free = s.fcount[1];
  a.out[0] = (long long)(s.dcount[1] - s.dcount[0])
             + (s.ccount[1] - s.ccount[0]) + over + s.accum[1]
             + (s.ecount[1] - s.ecount[0]);
  a.out[1] = near;
  a.out[2] = n_new > n_free ? n_new - n_free : 0;
  a.out[3] = s.accum[0];
  a.out[4] = s.ccount[0];
  a.out[5] = s.accum[2];
  a.num_bricks[0] = (int)(a.max_bricks - n_free
                          + (n_new < n_free ? n_new : n_free));
}

// A block a cell (s^3 <= 64 threads): each voxel's surface bit (occupied
// and its brick's least texel under the hit threshold) into the fine words,
// and the cell's occupancy for the coarse table.
template <typename T>
__global__ void march_fine(UpdateArgs a, Scratch s) {
  __shared__ unsigned int w[2];
  const int sc = (int)(a.r / 16);
  const int s3 = sc * sc * sc;
  const int n = blockIdx.x / 4096, cell = blockIdx.x % 4096;
  int c[3];
  cell_coords(cell, c);
  if (threadIdx.x < 2) w[threadIdx.x] = 0u;
  __syncthreads();
  const int v = threadIdx.x;
  if (v < s3) {
    const int b = a.brick_map[voxel(a.r, a.vs, a.origins, n, c, v,
                                    nullptr)];
    bool surf = false;
    if (b >= 0) {
      const long long nt = a.bsz * a.bsz * a.bsz;
      const T* row = static_cast<const T*>(a.atlas) + (long long)b * nt;
      T m = row[0];
      bool nan = false;
      for (long long t = 0; t < nt; ++t) {
        const T x = row[t];
        nan = nan || x != x;
        m = x < m ? x : m;
      }
      float f;
      if (sizeof(T) == 1) {
        f = (float)m * (float)a.u8_scale;
      } else {
        f = nan ? __int_as_float(0x7fc00000) : (float)m;
      }
      surf = f < (float)a.surf_thresh;
    }
    if (surf) atomicOr(&w[v >> 5], 1u << (v & 31));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long at = (long long)n * 4096 + cell;
    a.march_fine0[at] = (int)w[0];
    a.march_fine1[at] = (int)w[1];
    s.cellocc[at] = (w[0] | w[1]) != 0u;
  }
}

// A block a cascade: the coarse cells' Chebyshev distance to an occupied
// cell, capped at 15, packed 8 nibbles a word.
__global__ void __launch_bounds__(1024)
march_coarse(UpdateArgs a, Scratch s) {
  __shared__ unsigned char d0[4096], d1[4096];
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    d0[i] = s.cellocc[(long long)n * 4096 + i] ? 0 : kEsdCap;
  __syncthreads();
  for (int axis = 0; axis < 3; ++axis) {
    unsigned char* src = axis == 1 ? d1 : d0;
    unsigned char* dst = axis == 1 ? d0 : d1;
    const int stride = axis == 0 ? 1 : (axis == 1 ? 16 : 256);
    for (int i = threadIdx.x; i < 4096; i += blockDim.x) {
      const int x = (i / stride) % 16;
      int d = kEsdCap;
      for (int o = -kEsdCap; o <= kEsdCap; ++o) {
        const int y = x + o;
        if (y < 0 || y >= 16) continue;
        const int ao = o < 0 ? -o : o;
        const int l = src[i + o * stride];
        const int m = ao > l ? ao : l;
        d = m < d ? m : d;
      }
      dst[i] = (unsigned char)d;
    }
    __syncthreads();
  }
  // three passes end in d1
  for (int wd = threadIdx.x; wd < 512; wd += blockDim.x) {
    unsigned int word = 0u;
    for (int k = 0; k < 8; ++k)
      word |= (unsigned int)d1[wd * 8 + k] << (4 * k);
    a.march_coarse[(long long)n * 512 + wd] = (int)word;
  }
}

// ---------------------------------------------------------------------------
// S. the scroll: the shifted copy of the state, its dirty cells and global
//    lists
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long floor_div(long long x, long long y) {
  const long long q = x / y;
  return (x % y != 0 && (x < 0) != (y < 0)) ? q - 1 : q;
}

// The whole-voxel shift (xyz) of cascade n, round((new origin - old
// origin) / vs) as scroll_cascades_reference takes it; 0 where the cascade
// does not scroll.
__device__ void shift_of(const UpdateArgs& a, int n, long long* d) {
  const float half_r = (float)(0.5 * (double)a.r);
  const float v = a.vs[n];
  const bool on = (a.scrolled >> n) & 1;
  for (int k = 0; k < 3; ++k) {
    const float no = a.center[n * 3 + k] - half_r * v;
    const float oo = a.center_old[n * 3 + k] - half_r * v;
    d[k] = on ? (long long)(int)rintf((no - oo) / v) : 0;
  }
}

__device__ __forceinline__ bool in_window(long long x, long long y,
                                          long long z, long long w) {
  return x >= 0 && x < w && y >= 0 && y < w && z >= 0 && z < w;
}

// A block a cell of the new tables: the old cell dc = d / s cells on (its
// list, count and rows), or -1, 0 and 0.0 where that lies outside the
// window.
__global__ void __launch_bounds__(kThreads)
shift_cells(UpdateArgs a) {
  const long long g = blockIdx.x;
  const int n = (int)(g / 4096);
  int c[3];
  cell_coords((int)(g % 4096), c);
  long long d[3];
  shift_of(a, n, d);
  const long long s = a.r / 16;
  const long long x = c[0] + floor_div(d[0], s), y = c[1] + floor_div(d[1], s),
                  z = c[2] + floor_div(d[2], s);
  const bool in = in_window(x, y, z, 16);
  const long long from = (long long)n * 4096 + (in ? (z * 16 + y) * 16 + x
                                                   : 0);
  const long long K = a.K;
  for (long long i = threadIdx.x; i < K; i += kThreads)
    a.cell_tris[g * K + i] = in ? a.cell_tris_old[from * K + i] : -1;
  if (threadIdx.x == 0) a.cell_count[g] = in ? a.cell_count_old[from] : 0;
  const long long m = K * kRow;
  float* dst = a.cell_rows + g * m;
  const float* src = a.cell_rows_old + from * m;
  if (m % 4 == 0 && ((uintptr_t)dst | (uintptr_t)src) % 16 == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i = threadIdx.x; i < m / 4; i += kThreads)
      d4[i] = in ? s4[i] : zero;
  } else {
    for (long long i = threadIdx.x; i < m; i += kThreads)
      dst[i] = in ? src[i] : 0.f;
  }
}

// A thread a voxel of the new brick map: the old voxel d on, or -1.
__global__ void __launch_bounds__(kThreads)
shift_map(UpdateArgs a) {
  const long long r = a.r, r3 = r * r * r;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.N * r3) return;
  const int n = (int)(i / r3);
  const long long rem = i % r3;
  long long d[3];
  shift_of(a, n, d);
  const long long x = rem % r + d[0], y = (rem / r) % r + d[1],
                  z = rem / (r * r) + d[2];
  a.brick_map[i] = in_window(x, y, z, r)
                       ? a.brick_map_old[n * r3 + (z * r + y) * r + x] : -1;
}

// A thread a brick: a live brick of a scrolled cascade keeps its atlas row
// at its voxel d back, or is no longer alive where that left the window.
__global__ void __launch_bounds__(kThreads)
shift_bricks(UpdateArgs a) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.max_bricks) return;
  const long long r = a.r, r3 = r * r * r;
  int bv = a.brick_voxel_old[b];
  bool alive = a.alive_old[b] != 0;
  const long long n = floor_div(bv, r3);
  if (alive && n >= 0 && n < a.N && ((a.scrolled >> n) & 1)) {
    long long d[3];
    shift_of(a, (int)n, d);
    const long long rem = bv - n * r3;
    const long long x = rem % r - d[0], y = (rem / r) % r - d[1],
                    z = rem / (r * r) - d[2];
    if (in_window(x, y, z, r))
      bv = (int)(n * r3 + (z * r + y) * r + x);
    else
      alive = false;
  }
  a.brick_voxel[b] = bv;
  a.alive[b] = alive;
}

// A thread a cell: dirty where it entered the window or lies within one
// cell of a position that entered or left it (scroll_cascades_reference's
// _edge_cells); thread 0 counts the entering cells and sets the scalars
// update_scalars reads: no dirty triangle or re-bin, and the fresh bin's
// overflow both a list overflow and a breach.
__global__ void __launch_bounds__(kThreads)
mark_scroll(UpdateArgs a, Scratch s) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long sc = a.r / 16;
  if (g == 0) {
    long long entering = 0, over = 0;
    for (int n = 0; n < a.N; ++n) {
      s.total[n] = 0;
      s.nlarge[n] = 0;
      if (!((a.scrolled >> n) & 1)) continue;
      long long d[3], kept = 1;
      shift_of(a, n, d);
      for (int k = 0; k < 3; ++k) {
        long long m = floor_div(d[k], sc);
        m = m < 0 ? -m : m;
        kept *= 16 - (m < 16 ? m : 16);
      }
      entering += 4096 - kept;
      over += a.fresh_over[fresh_slot(a, n)];
    }
    *a.entering = entering;
    s.dcount[0] = s.dcount[1] = 0;
    s.accum[0] = s.accum[1] = over;
  }
  if (g >= a.N * 4096) return;
  const int n = (int)(g / 4096);
  int c[3];
  cell_coords((int)(g % 4096), c);
  long long d[3];
  shift_of(a, n, d);
  long long dc[3];
  for (int k = 0; k < 3; ++k) dc[k] = floor_div(d[k], sc);
  const bool kept = in_window(c[0] + dc[0], c[1] + dc[1], c[2] + dc[2], 16);
  bool edge = false;
  for (int o = 0; o < 27; ++o) {
    const long long x = c[0] + o % 3 - 1, y = c[1] + (o / 3) % 3 - 1,
                    z = c[2] + o / 9 - 1;
    edge = edge || in_window(x, y, z, 16)
                       != in_window(x + dc[0], y + dc[1], z + dc[2], 16);
  }
  s.cellm[g] = !kept || edge;
}

// A block a cascade: the global list (the fresh bin's for a scrolled
// cascade, the old one otherwise) and its rows; the rows the occupancy
// tests run to the last live entry.
__global__ void __launch_bounds__(kThreads)
glob_scroll(UpdateArgs a, Scratch s) {
  __shared__ int last;
  const int n = blockIdx.x;
  const long long Kg = a.Kg;
  const bool on = (a.scrolled >> n) & 1;
  const int* src = on ? a.fresh_glob + fresh_slot(a, n) * Kg
                      : a.glob_old + n * Kg;
  int* out = a.glob_tris + n * Kg;
  if (threadIdx.x == 0) last = -1;
  __syncthreads();
  for (long long i = threadIdx.x; i < Kg; i += kThreads) {
    out[i] = src[i];
    if (src[i] >= 0) atomicMax(&last, (int)i);
  }
  __syncthreads();
  if (threadIdx.x == 0) s.gcount[n] = last + 1;
  float* rows = a.glob_rows + n * Kg * kRow;
  for (long long i = threadIdx.x; i < Kg * kRow; i += kThreads) {
    const int id = src[i / kRow];
    const int col = (int)(i % kRow);
    rows[i] = id >= 0 ? a.table[(long long)id * kRow + col] : pad_row(col);
  }
}

// The passes after the dirty cells' diff, shared by the update and the
// scroll: allocation, the brick map's scatter, the ESD and the emit list.
void alloc_to_emit_list(const UpdateArgs& a, const Scratch& s,
                        cudaStream_t st) {
  const long long sc = a.r / 16;
  const long long s3 = sc * sc * sc;
  const auto blocks = [](long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : b);
  };
  fixed_list(a.alive, a.max_bricks, 1, (int)(a.ccap * s3), s.freel, nullptr,
             s.fcount, s.bcount, st);
  fixed_list(s.newm, a.ccap * s3, 0, 0, nullptr, s.rank, s.ncount, s.bcount,
             st);
  alloc_scatter<<<blocks(a.ccap * s3), kThreads, 0, st>>>(a, s);
  const int et = a.r < kThreads ? (int)a.r : kThreads;
  const dim3 lines((unsigned)a.r, (unsigned)a.r, (unsigned)a.N);
  for (int axis = 0; axis < 3; ++axis)
    esd_pass<<<lines, et, (size_t)a.r, st>>>(a, s, axis);
  fixed_list(s.emitm, a.ccap * s3, 0, (int)a.bcap, s.epos, nullptr, s.ecount,
             s.bcount, st);
  emit_list<<<blocks(a.elen), kThreads, 0, st>>>(a, s);
}

}  // namespace

extern "C" int vri_sdf_update_args_size() { return (int)sizeof(UpdateArgs); }

// The scratch bytes of an update (-1 past 2 GB).
extern "C" int vri_sdf_update_scratch(const UpdateArgs* a) {
  const size_t n = layout(*a).size;
  return n > (size_t)0x7fffffff ? -1 : (int)n;
}

// Everything up to the emit: the new lists, rows, occupancy, allocation,
// brick map and ESD, and the emit list with its live count.
extern "C" int vri_sdf_update_lists(const UpdateArgs* pa, void* stream) {
  const UpdateArgs a = *pa;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long sc = a.r / 16;
  const long long s3 = sc * sc * sc;
  if (a.r % 16 != 0 || s3 > kMaxS3 || a.r > 1024) return -2;
  if (a.ucap * 4096 + a.pairs_cap >= (1LL << 31)
      || a.ccap * s3 >= (1LL << 31))
    return -3;
  const Layout l = layout(a);
  const Scratch s = scratch(a);
  cudaMemsetAsync(a.scratch, 0, l.zero_bytes, st);
  cudaMemsetAsync(a.emit_bricks, 0, a.max_bricks, st);
  const auto blocks = [](long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : b);
  };
  long long m = a.F > a.N * 3 ? a.F : a.N * 3;
  tri_prep<<<blocks(m), kThreads, 0, st>>>(a);
  fixed_list(a.dirty, a.F, 0, (int)a.ucap, s.dlist, nullptr, s.dcount,
             s.bcount, st);
  mark_cells<<<blocks(a.N * 4096), kThreads, 0, st>>>(a, s.cellm);
  fixed_list(s.cellm, a.N * 4096, 0, (int)a.ccap, s.clist, nullptr, s.ccount,
             s.bcount, st);
  const dim3 per_tri(blocks(a.ucap), (unsigned)a.N);
  rebin_prep<<<per_tri, kThreads, 0, st>>>(a, s);
  rebin_scan<<<(unsigned)a.N, kThreads, 0, st>>>(a, s);
  rebin_count<<<per_tri, kThreads, 0, st>>>(a, s);
  glob_merge<<<(unsigned)a.N, kThreads, 0, st>>>(a, s);
  cell_merge<false><<<(unsigned)a.ccap, kThreads, 0, st>>>(a, s);
  alloc_to_emit_list(a, s, st);
  return (int)cudaGetLastError();
}

// The scroll up to the emit: the shifted copy of the state and cascades,
// the dirty cells with the fresh bin's lists and rows installed, their
// occupancy, the allocation, the brick map and ESD, and the emit list.
extern "C" int vri_sdf_scroll_lists(const UpdateArgs* pa, void* stream) {
  const UpdateArgs a = *pa;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long sc = a.r / 16;
  const long long s3 = sc * sc * sc;
  if (a.r % 16 != 0 || s3 > kMaxS3 || a.r > 1024 || a.N > 62) return -2;
  if (a.ccap * s3 >= (1LL << 31)) return -3;
  const Layout l = layout(a);
  const Scratch s = scratch(a);
  cudaMemsetAsync(a.scratch, 0, l.zero_bytes, st);
  cudaMemsetAsync(a.emit_bricks, 0, a.max_bricks, st);
  const auto blocks = [](long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : b);
  };
  long long m = a.F > a.N * 3 ? a.F : a.N * 3;
  tri_prep<<<blocks(m), kThreads, 0, st>>>(a);
  shift_cells<<<(unsigned)(a.N * 4096), kThreads, 0, st>>>(a);
  shift_map<<<blocks(a.N * a.r * a.r * a.r), kThreads, 0, st>>>(a);
  shift_bricks<<<blocks(a.max_bricks), kThreads, 0, st>>>(a);
  mark_scroll<<<blocks(a.N * 4096), kThreads, 0, st>>>(a, s);
  fixed_list(s.cellm, a.N * 4096, 0, (int)a.ccap, s.clist, nullptr, s.ccount,
             s.bcount, st);
  glob_scroll<<<(unsigned)a.N, kThreads, 0, st>>>(a, s);
  cell_merge<true><<<(unsigned)a.ccap, kThreads, 0, st>>>(a, s);
  alloc_to_emit_list(a, s, st);
  return (int)cudaGetLastError();
}

// After the emit: the scalars and the march tables.
extern "C" int vri_sdf_update_finish(const UpdateArgs* pa, void* stream) {
  const UpdateArgs a = *pa;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = scratch(a);
  update_scalars<<<1, kThreads, 0, st>>>(a, s);
  const long long sc = a.r / 16;
  if (!a.march_ok) {
    cudaMemsetAsync(a.march_coarse, 0, sizeof(int) * a.N * 512, st);
    cudaMemsetAsync(a.march_fine0, 0, sizeof(int) * a.N * 4096, st);
    cudaMemsetAsync(a.march_fine1, 0, sizeof(int) * a.N * 4096, st);
    return (int)cudaGetLastError();
  }
  const int s3 = (int)(sc * sc * sc);
  const int mt = s3 < 32 ? 32 : s3;             // a thread a voxel
  const unsigned cells = (unsigned)(a.N * 4096);
  if (a.atlas_u8)
    march_fine<unsigned char><<<cells, mt, 0, st>>>(a, s);
  else
    march_fine<float><<<cells, mt, 0, st>>>(a, s);
  march_coarse<<<(unsigned)a.N, 1024, 0, st>>>(a, s);
  return (int)cudaGetLastError();
}
