// The work-list walks: the template walk and the setup walk.
//
// Replaces the TPU kernels of the work-list micro-benchmarks, K1's
// prototypes (vri_tpu/ops/rasterize.py:_pass1_kernel):
//   tools/micro_steps.py:kernel, kernel_fused, kernel_packed   (T5)
//   tools/micro_worklist.py:kernel                             (T4)
//   tools/micro_attrib.py:kernel                               (T3)
//     -> walk_kernel, the template walk
//   tools/micro_pass1.py:make.kern                             (T1)
//     -> setup_kernel, the walk with in-kernel triangle setup
//
// On the TPU one grid step is one (tile, chunk) step of the sorted work
// list; the per-tile winner is carried in VMEM scratch from a step with
// the first flag to the step with the last flag.  Blocks on the card run
// in no order, so here one thread block walks one tile run: there is one
// block per step, a block whose step has no first flag exits at once, and
// the others walk from their step to the next last flag, skipping steps
// without the live flag.  A first flag met before that last flag breaks
// the run (the TPU re-initialises there and never writes it), so its
// block exits unwritten and the later block walks the new run.
//
// Layout.  Each live step's chunk is staged in shared memory once, one
// record a lane: the lane's factors and constant for all three fields
// (column_terms), padded to a multiple of 4 floats, so a thread reads a
// lane with 16-byte broadcast loads.  The slot ids sit apart, TC floats:
// a pixel reads one once a step, at its winner's lane, and there the
// threads' distinct lanes fall in distinct banks (in records of 12-24
// floats they would fall in two to eight banks).  A block has P / kPx threads (at most
// 1024), each holding P / threads pixels in one column of the tile
// (pixel thread + k * threads, where the block width is a multiple of the
// tile's) or one row (thread * ppt + k): a thread reads each lane's record
// once for all its pixels, and the product of the coordinate they share
// is computed once for all of them (the same operands give the same
// bits).  The lane loop is unrolled by kLaneUnroll.  A thread walks the
// TC lanes in order and keeps per pixel:
//   * per-lane mode (micro_steps kernel / kernel_fused, micro_worklist):
//     the TPU keeps a per-lane (P, TC) scratch updated with a strict "<"
//     and finalizes on the lowest lane of the minimum, which is the
//     lexicographic minimum of (z, lane, step).  Here a step keeps its
//     first covering lane of least z (take_covered: the coverage test and
//     the strict "<" in one predicate) and merges it into the run's best
//     once a step (lane_update), which gives the same winner.
//     kernel_fused's singleton step (flags 7) skips that scratch on the
//     TPU; on the card there is no scratch to skip, so it is the same walk;
//   * packed mode (micro_steps kernel_packed, micro_attrib): the key (z
//     bits with lane_bits(TC) low bits cleared) | lane; the step's least
//     key merges with a strict "<", the winner's slot id read by its lane
//     bits; the quantized z is returned, as the TPU kernel does.
// Exact fused products: in the bf16 modes every product is a pixel
// coordinate k + 0.5 (k < 256: 9 significant bits) times a bf16 factor (8
// bits), exact in FP32, so __fmaf_rn(x, f, acc) rounds as acc + x * f
// does (record_field).  The FP32 mode, the translated constant and the
// triangle setup multiply by 24-bit factors and round every product
// (-fmad=false), as the plain versions do.
// micro_attrib's stages 0-4 are timing-only rungs of its ladder (the TPU
// leaves their slot scratch uninitialised): STAGE selects how much of the
// step runs, and the rows they write are not checked.  The matrix unit's
// passes have no counterpart here: stage 1 runs one pair of exact bf16
// products and the constant over the 3 TC columns, stage 2 all three
// pairs, stage 3 up to the coverage chain, stage 4 the packed key without
// the slot id, stage 6 the K=6 sum over the pre-split operand.
//
// Setup walk: per live step, the TC lanes' triangle setup (micro_pass1's
// order) spread over the block, each lane's nine coefficients stored
// together (12 floats), then the template walk's layout and per-lane
// rule, carrying the position wc * TC + lane as float32; its pixels are
// laid out TC wide.  Its variants 1 and 2 never write on the TPU; here
// they write only under a condition that never holds, so their work is
// kept and their rows stay the wrapper's miss values.
//
// Bound on the H100: each (pixel, lane) test is ~20 FP32 operations
// (three affine fields, the coverage chain, the compare), and a step
// moves one chunk (12 KB) and, per run, one output row (8 KB), so the
// walk is bound by operations (micro_steps at P = 1024, TC = 128, 4096
// steps: 5.4e8 tests, ~0.16 ms at 67 TFLOP/s against ~0.013 ms of
// bytes).  The first port ran one pixel a thread, and every (pixel, lane)
// test re-read the lane's 10-22 staged values from shared memory: the
// walk was bound by shared-memory issue.  Here a lane costs a thread 3-6
// 16-byte broadcasts for its 4 pixels (one wavefront each on the H100,
// as 4-byte ones: tools/lds_probe.cu), and the walk issues ~21 (FP32
// per-lane) to ~32 (bf16x3) instructions a test.  What is left is the
// schedule: one block walks a whole run, and the tools' runs of 1-8
// steps leave SMs idle at the end of the launch (the same runs
// renumbered longest first run 18% faster: kernel_turns).

#include "worklist_common.cuh"

namespace {

using namespace vri_wl;

constexpr int kFullStage = 5;
// Pixels a thread (kernel_turns times 2 and 8 as variants).
constexpr int kPx = 4;
// A thread's pixels in one column of the tile where the block allows it,
// else in one row (kernel_turns times rows first as a variant).
constexpr bool kColumnFirst = true;
// Lanes a walk unrolls (kernel_turns times 1 and 2 as variants).
constexpr int kLaneUnroll = 4;
constexpr int kMaxThreads = 1024;
// Where a per-lane step starts: the least float above 1, so take_covered's
// z < sz also holds z <= 1.
constexpr float kStepZ = 1.00000012f;

// The per-lane rule within a step with the coverage test folded in:
// lane l becomes the step's best (sz, sl) where it covers the pixel
// (cover()'s test) with a z below sz.  A step that covers nothing keeps
// (kStepZ, 0), above 1, which merges as a miss.
__device__ __forceinline__ void take_covered(float l1, float l2, float z,
                                             int l, float& sz, int& sl) {
  const bool take = (z < sz) & (l1 >= 0.0f) & (l2 >= 0.0f) & (z >= 0.0f) &
                    (l1 + l2 <= 1.0f);
  sz = take ? z : sz;
  sl = take ? l : sl;
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
// tile-local pixel (px, py), in field()'s order (worklist_common.cuh):
// the first PAIRS pairs' sum, then + the constant.
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

template <int EVAL, bool PACKED, int STAGE, int PPT, int LAYOUT>
__global__ void __launch_bounds__(kMaxThreads)
    walk_kernel(const int* __restrict__ wt, const int* __restrict__ wc,
                const int* __restrict__ fl, int n_work,
                const float* __restrict__ chunks,
                const uint16_t* __restrict__ chunks_k6, int P, int tc,
                int translate, float* __restrict__ z_out,
                int* __restrict__ slot_out) {
  constexpr int S = staged_rows<EVAL>(), RW = record_floats<EVAL>();
  const int start = blockIdx.x;
  if (!(fl[start] & 1)) return;
  extern __shared__ float4 wl_smem[];
  float* rec = reinterpret_cast<float*>(wl_smem);
  float* sid = rec + RW * tc;
  const int ncol = 3 * tc;
  const int mask = ~((1 << lane_bits(tc)) - 1);
  float px[PPT], py[PPT], bz[PPT], bs[PPT];
  int bl[PPT], bk[PPT];
  pixel_centers<LAYOUT, PPT>(kTileW, px, py);
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    bz[q] = 2.0f;
    bl[q] = tc;
    bk[q] = kMissKey;
    bs[q] = 0.0f;
  }
  for (int i = start; i < n_work; ++i) {
    const int f = fl[i];
    if (i > start && (f & 1)) return;   // a broken run: never written
    if (f & 4) {
      const int tile = wt[i];
      const float fx0 = (float)((tile % kNumTx) * kTileW);
      const float fy0 = (float)((tile / kNumTx) * (P / kTileW));
      const size_t off = (size_t)wc[i] * 8 * ncol;
      __syncthreads();   // the previous step's records are read
      stage_records<EVAL>(chunks + off,
                          EVAL == kK6 ? chunks_k6 + off : nullptr, tc,
                          translate != 0, fx0, fy0, rec, sid);
      __syncthreads();
      if (STAGE == 0) {
        // floor: the staged step and the row update, no arithmetic
        const int row = __float_as_int(chunks[off]);
#pragma unroll
        for (int q = 0; q < PPT; ++q) bk[q] = min(bk[q], row);
      } else if (STAGE == 1 || STAGE == 2) {
        // the field sums over all 3 TC columns, their minimum as a key
        constexpr int kPairs = STAGE == 1 ? 1 : all_pairs<EVAL>();
        float m[PPT];
#pragma unroll
        for (int q = 0; q < PPT; ++q) m[q] = __int_as_float(0x7f800000);
#pragma unroll (kLaneUnroll)
        for (int l = 0; l < tc; ++l) {
          float r[RW];
          load_record<RW>(rec + l * RW, r);
#pragma unroll
          for (int q = 0; q < PPT; ++q)
#pragma unroll
            for (int fi = 0; fi < 3; ++fi)
              m[q] = fminf(m[q], record_field<EVAL, kPairs, LAYOUT>(
                                     r + fi * S, px[q], py[q]));
        }
#pragma unroll
        for (int q = 0; q < PPT; ++q)
          bk[q] = min(bk[q], __float_as_int(m[q]) & mask);
      } else {
        // the step's best per pixel: (z, lane) in per-lane mode, the
        // least z at stage 3, the least key in packed mode
        float sz[PPT];
        int sl[PPT];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          sz[q] = PACKED ? 2.0f : kStepZ;
          sl[q] = PACKED ? 0x7fffffff : 0;
        }
#pragma unroll (kLaneUnroll)
        for (int l = 0; l < tc; ++l) {
          float r[RW];
          load_record<RW>(rec + l * RW, r);
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            constexpr int kPairs = all_pairs<EVAL>();
            const float l1 =
                record_field<EVAL, kPairs, LAYOUT>(r, px[q], py[q]);
            const float l2 =
                record_field<EVAL, kPairs, LAYOUT>(r + S, px[q], py[q]);
            const float z =
                record_field<EVAL, kPairs, LAYOUT>(r + 2 * S, px[q], py[q]);
            if (!PACKED) {
              take_covered(l1, l2, z, l, sz[q], sl[q]);
            } else if (STAGE == 3) {
              sz[q] = fminf(sz[q], cover(l1, l2, z));
            } else {
              sl[q] = min(sl[q],
                          (__float_as_int(cover(l1, l2, z)) & mask) | l);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          if (!PACKED) {
            if (lane_update(sz[q], sl[q], bz[q], bl[q])) bs[q] = sid[sl[q]];
          } else if (STAGE == 3) {
            bk[q] = min(bk[q], __float_as_int(sz[q]) & mask);
          } else if (sl[q] < bk[q]) {
            bk[q] = sl[q];
            if (STAGE >= kFullStage) bs[q] = sid[sl[q] & ~mask];
          }
        }
      }
    }
    if (f & 2) {
      const size_t row = (size_t)wt[i] * P;
#pragma unroll
      for (int q = 0; q < PPT; ++q)
        store_pixel(PACKED ? __int_as_float(bk[q] & mask) : bz[q], bs[q],
                    row + pixel_of<LAYOUT, PPT>(threadIdx.x, blockDim.x, q),
                    z_out, slot_out);
      return;
    }
  }
}

constexpr int kSetupRW = 12;   // a lane's nine setup coefficients, padded

// micro_pass1's per-lane setup of lane l (fx0 = tile % kNumTx, its
// quirk: no * 128) into its record c[0 .. 11]: ka1 kb1 kc1 ka2 kb2 kc2
// kaz kbz kcz 0 0 0.
__device__ __forceinline__ void setup_lane(const float* __restrict__ r,
                                           int tc, int l, float fx0,
                                           float* c) {
  const float ax = r[l] - fx0, bx = r[tc + l] - fx0, cx = r[2 * tc + l] - fx0;
  const float ay = r[3 * tc + l], by = r[4 * tc + l], cy = r[5 * tc + l];
  const float az = r[6 * tc + l], bz = r[7 * tc + l], cz = r[8 * tc + l];
  const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const bool dead = az >= 9.0f || fabsf(area) <= 1e-12f;
  const float inv = dead ? 0.0f : 1.0f / (dead ? 1.0f : area);
  const float ka1 = -(ay - cy) * inv;
  const float kb1 = (ax - cx) * inv;
  const float kc1 = (cx * (ay - cy) - cy * (ax - cx)) * inv;
  const float ka2 = -(by - ay) * inv;
  const float kb2 = (bx - ax) * inv;
  const float kc2 = (ax * (by - ay) - ay * (bx - ax)) * inv;
  const float dz1 = bz - az, dz2 = cz - az;
  float4* dst = reinterpret_cast<float4*>(c);
  dst[0] = make_float4(ka1, kb1, kc1, ka2);
  dst[1] = make_float4(kb2, kc2, ka1 * dz1 + ka2 * dz2,
                       kb1 * dz1 + kb2 * dz2);
  dst[2] = make_float4(az + kc1 * dz1 + kc2 * dz2, 0.0f, 0.0f, 0.0f);
}

template <int VARIANT, int PPT, int LAYOUT>
__global__ void __launch_bounds__(kMaxThreads)
    setup_kernel(const int* __restrict__ wt, const int* __restrict__ wc,
                 const int* __restrict__ fl, int n_work,
                 const float* __restrict__ chunks, int P, int tc,
                 float* __restrict__ z_out, int* __restrict__ pos_out) {
  const int start = blockIdx.x;
  if (!(fl[start] & 1)) return;
  extern __shared__ float4 wl_smem[];
  float* smem = reinterpret_cast<float*>(wl_smem);
  float px[PPT], py[PPT], bz[PPT], bp[PPT];
  int bl[PPT];
  pixel_centers<LAYOUT, PPT>(tc, px, py);
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    bz[q] = 2.0f;
    bl[q] = tc;
    bp[q] = -1.0f;
  }
  float acc = 0.0f;   // the floor variants' use of the staged rows
  for (int i = start; i < n_work; ++i) {
    const int f = fl[i];
    if (i > start && (f & 1)) return;   // a broken run: never written
    if (f & 4) {
      const float* rows = chunks + (size_t)wc[i] * 24 * tc;
      __syncthreads();   // the previous step's records are read
      if (VARIANT < 2) {
        for (int c = threadIdx.x; c < 24 * tc; c += blockDim.x)
          smem[c] = rows[c];
        __syncthreads();
        acc += smem[threadIdx.x % (24 * tc)];
      } else {
        const float fx0 = (float)(wt[i] % kNumTx);
        for (int l = threadIdx.x; l < tc; l += blockDim.x)
          setup_lane(rows, tc, l, fx0, smem + l * kSetupRW);
        __syncthreads();
        float sz[PPT];
        int sl[PPT];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          sz[q] = kStepZ;
          sl[q] = 0;
        }
#pragma unroll (kLaneUnroll)
        for (int l = 0; l < tc; ++l) {
          float c[kSetupRW];
          load_record<kSetupRW>(smem + l * kSetupRW, c);
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            const float l1 = (px[q] * c[0] + py[q] * c[1]) + c[2];
            const float l2 = (px[q] * c[3] + py[q] * c[4]) + c[5];
            const float z = (px[q] * c[6] + py[q] * c[7]) + c[8];
            take_covered(l1, l2, z, l, sz[q], sl[q]);
          }
        }
        const float base = (float)(wc[i] * tc);
#pragma unroll
        for (int q = 0; q < PPT; ++q)
          if (lane_update(sz[q], sl[q], bz[q], bl[q]))
            bp[q] = base + (float)sl[q];
      }
    }
    if (f & 2) {
      const size_t row = (size_t)wt[i] * P;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const size_t o =
            row + pixel_of<LAYOUT, PPT>(threadIdx.x, blockDim.x, q);
        if (VARIANT == 3) {
          store_pixel(bz[q], bp[q], o, z_out, pos_out);
        } else if (VARIANT == 0) {
          z_out[o] = acc != acc ? 1.0f : 0.0f;   // 0 for finite rows
          pos_out[o] = 0;
        } else if (VARIANT == 1 ? acc != acc : bz[q] < -1.0f) {
          // timing-only variants: never true, keeps their work alive
          z_out[o] = bz[q] + acc;
          pos_out[o] = (int)bp[q];
        }
      }
      return;
    }
  }
}

// A walk's block: P / kPx threads (at most 1024), ppt = P / threads
// pixels each -- kPx, or 4 where the cap binds (P = 4096 at kPx = 2) --
// in one column where the block width is a multiple of the tile width,
// or in one row where ppt divides it; layout -1 where neither holds (no
// shape the wrappers admit: P is a multiple of 128 and TC divides it).
struct Shape {
  int threads, ppt, layout;
};

inline Shape walk_shape(int P, int width) {
  Shape s;
  s.threads = P / kPx < kMaxThreads ? P / kPx : kMaxThreads;
  s.ppt = P / s.threads;
  const bool column = s.threads % width == 0, row = width % s.ppt == 0;
  s.layout = column && (kColumnFirst || !row) ? kColumn : row ? kRow : -1;
  return s;
}

// One launch of `kernel` (null: a shape without an instance) with s's
// threads, n_work blocks and `smem` bytes of shared memory.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int n_work, const Shape& s, size_t smem,
           cudaStream_t st, A... args) {
  if (n_work <= 0) return (int)cudaGetLastError();
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_work, s.threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int EVAL, bool PACKED, int STAGE, int N>
auto walk_instance(int layout)
    -> decltype(&walk_kernel<EVAL, PACKED, STAGE, N, kColumn>) {
  return layout == kColumn ? &walk_kernel<EVAL, PACKED, STAGE, N, kColumn>
         : layout == kRow  ? &walk_kernel<EVAL, PACKED, STAGE, N, kRow>
                           : nullptr;
}

template <int VARIANT, int N>
auto setup_instance(int layout) -> decltype(&setup_kernel<VARIANT, N,
                                                          kColumn>) {
  return layout == kColumn ? &setup_kernel<VARIANT, N, kColumn>
         : layout == kRow  ? &setup_kernel<VARIANT, N, kRow>
                           : nullptr;
}

template <int EVAL, bool PACKED, int STAGE>
int launch_walk(cudaStream_t st, const int* wt, const int* wc, const int* fl,
                int n_work, const float* chunks, const void* chunks_k6,
                int P, int tc, int translate, float* z_out, int* slot_out) {
  const Shape s = walk_shape(P, kTileW);
  const auto kernel =
      s.ppt == kPx ? walk_instance<EVAL, PACKED, STAGE, kPx>(s.layout)
      : s.ppt == 4 ? walk_instance<EVAL, PACKED, STAGE, 4>(s.layout)
                   : nullptr;
  const size_t smem = sizeof(float) * (record_floats<EVAL>() + 1) * tc;
  return launch(kernel, n_work, s, smem, st, wt, wc, fl, n_work, chunks,
                (const uint16_t*)chunks_k6, P, tc, translate, z_out,
                slot_out);
}

template <int VARIANT>
int launch_setup(cudaStream_t st, const int* wt, const int* wc,
                 const int* fl, int n_work, const float* chunks, int P,
                 int tc, float* z_out, int* pos_out) {
  const Shape s = walk_shape(P, tc);
  const auto kernel = s.ppt == kPx ? setup_instance<VARIANT, kPx>(s.layout)
                      : s.ppt == 4 ? setup_instance<VARIANT, 4>(s.layout)
                                   : nullptr;
  // the floor variants stage all 24 rows; the setup, 12-float records
  const size_t smem = sizeof(float) * 24 * tc;
  return launch(kernel, n_work, s, smem, st, wt, wc, fl, n_work, chunks, P,
                tc, z_out, pos_out);
}

}  // namespace

// mode: the index of worklist.py WALK_KERNELS, (evaluation, packed,
// stage) -- the tools' modes, then micro_attrib's timing-only rungs.
extern "C" int vri_worklist_walk(const int* wt, const int* wc, const int* fl,
                                 int n_work, const float* chunks,
                                 const void* chunks_k6, int P, int tc,
                                 int mode, int translate, float* z_out,
                                 int* slot_out, void* stream) {
#define VRI_ARGS                                                          \
  (cudaStream_t)stream, wt, wc, fl, n_work, chunks, chunks_k6, P, tc,     \
      translate, z_out, slot_out
  switch (mode) {
    case 0: return launch_walk<kF32, false, kFullStage>(VRI_ARGS);
    case 1: return launch_walk<kBf16x2, false, kFullStage>(VRI_ARGS);
    case 2: return launch_walk<kBf16x2, true, kFullStage>(VRI_ARGS);
    case 3: return launch_walk<kBf16x3, true, kFullStage>(VRI_ARGS);
    case 4: return launch_walk<kK6, true, kFullStage>(VRI_ARGS);
    case 5: return launch_walk<kBf16x3, true, 0>(VRI_ARGS);
    case 6: return launch_walk<kBf16x3, true, 1>(VRI_ARGS);
    case 7: return launch_walk<kBf16x3, true, 2>(VRI_ARGS);
    case 8: return launch_walk<kBf16x3, true, 3>(VRI_ARGS);
    case 9: return launch_walk<kBf16x3, true, 4>(VRI_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VRI_ARGS
}

extern "C" int vri_worklist_setup(const int* wt, const int* wc,
                                  const int* fl, int n_work,
                                  const float* chunks, int P, int tc,
                                  int variant, float* z_out, int* pos_out,
                                  void* stream) {
#define VRI_ARGS                                                          \
  (cudaStream_t)stream, wt, wc, fl, n_work, chunks, P, tc, z_out, pos_out
  switch (variant) {
    case 0: return launch_setup<0>(VRI_ARGS);
    case 1: return launch_setup<1>(VRI_ARGS);
    case 2: return launch_setup<2>(VRI_ARGS);
    case 3: return launch_setup<3>(VRI_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VRI_ARGS
}
