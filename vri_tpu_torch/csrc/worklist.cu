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
// block exits unwritten and the later block walks the new run.  Each live
// step's chunk is staged in shared memory once (its per-column bf16
// splits and constant, 12-20 KB at TC = 128), then one thread per pixel
// (P / 1024 pixels a thread above 1024) walks the TC lanes in order and
// keeps a scalar best:
//   * per-lane mode (micro_steps kernel / kernel_fused, micro_worklist):
//     the TPU keeps a per-lane (P, TC) scratch updated with a strict "<"
//     and finalizes on the lowest lane of the minimum, which is the
//     lexicographic minimum of (z, lane, step) (lane_update).
//     kernel_fused's singleton step (flags 7) skips that scratch on the
//     TPU; on the card there is no scratch to skip, so it is the same walk;
//   * packed mode (micro_steps kernel_packed, micro_attrib): the key (z
//     bits with lane_bits(TC) low bits cleared) | lane with a strict "<";
//     the quantized z is returned, as the TPU kernel does.
// micro_attrib's stages 0-4 are timing-only rungs of its ladder (the TPU
// leaves their slot scratch uninitialised): STAGE selects how much of the
// step runs, and the rows they write are not checked.  The matrix unit's
// passes have no counterpart here: stage 1 runs one FP32 pair of exact
// bf16 products and the constant, stage 2 all three, stage 6 the K=6
// sum over the pre-split operand.
//
// Setup walk: per live step, one thread per lane computes the lane's
// triangle setup (micro_pass1's order) into shared memory, then every
// pixel tests the TC lanes with the per-lane rule above, carrying the
// position wc * TC + lane as float32.  Its variants 1 and 2 never write
// on the TPU; here they write only under a condition that never holds,
// so their work is kept and their rows stay the wrapper's miss values.
//
// Bound on the H100: each (pixel, lane) test is ~20 FP32 operations
// (three affine fields, the coverage chain, the compare), and a step
// moves one chunk (12 KB) and, per run, one output row (8 KB), so the
// walk is bound by operations (micro_steps at P = 1024, TC = 128, 4096
// steps: 5.4e8 tests, ~0.16 ms at 67 TFLOP/s against ~0.013 ms of
// bytes).  The design is the simple one: scalar FP32, no tensor cores (a
// contraction depth of 2 or 6 is below mma's 16), shared-memory reads
// that are block-wide broadcasts.  Making it fast is later work.

#include "worklist_common.cuh"

namespace {

using namespace vri_wl;

constexpr int kFullStage = 5;

template <int EVAL, bool PACKED, int STAGE, int PPT>
__global__ void __launch_bounds__(1024)
    walk_kernel(const int* __restrict__ wt, const int* __restrict__ wc,
                const int* __restrict__ fl, int n_work,
                const float* __restrict__ chunks,
                const uint16_t* __restrict__ chunks_k6, int P, int tc,
                int translate, float* __restrict__ z_out,
                int* __restrict__ slot_out) {
  const int start = blockIdx.x;
  if (!(fl[start] & 1)) return;
  extern __shared__ float smem[];
  const int ncol = 3 * tc;
  float* s = smem;
  float* sid = smem + staged_rows<EVAL>() * ncol;
  const int mask = ~((1 << lane_bits(tc)) - 1);
  float px[PPT], py[PPT], bz[PPT], bs[PPT];
  int bl[PPT], bk[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * blockDim.x;
    px[q] = 0.5f + (float)(p % kTileW);
    py[q] = 0.5f + (float)(p / kTileW);
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
      __syncthreads();
      stage_chunk<EVAL>(chunks + off,
                        EVAL == kK6 ? chunks_k6 + off : nullptr, ncol, tc,
                        translate != 0, fx0, fy0, s, sid);
      __syncthreads();
      if (STAGE == 0) {
        // floor: the staged step and the row update, no arithmetic
        const int row = __float_as_int(chunks[off]);
#pragma unroll
        for (int q = 0; q < PPT; ++q) bk[q] = min(bk[q], row);
      } else if (STAGE == 1 || STAGE == 2) {
        // the field sums over all 3 TC columns, their minimum as a key
        constexpr int kPairs = STAGE == 1 ? 1 : all_pairs<EVAL>();
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float m = __int_as_float(0x7f800000);   // +inf
          for (int c = 0; c < ncol; ++c)
            m = fminf(m, field<EVAL, kPairs>(s + c, ncol, px[q], py[q]));
          bk[q] = min(bk[q], __float_as_int(m) & mask);
        }
      } else {
        for (int l = 0; l < tc; ++l) {
          const float sl = sid[l];
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            const float zm =
                covered_depth<EVAL>(s, ncol, tc, l, px[q], py[q]);
            if (!PACKED) {
              lane_update(zm, l, sl, bz[q], bl[q], bs[q]);
            } else if (STAGE == 3) {
              bz[q] = fminf(bz[q], zm);
            } else {
              const int key = (__float_as_int(zm) & mask) | l;
              if (key < bk[q]) {
                bk[q] = key;
                if (STAGE >= kFullStage) bs[q] = sl;
              }
            }
          }
        }
        if (STAGE == 3) {
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            bk[q] = min(bk[q], __float_as_int(bz[q]) & mask);
            bz[q] = 2.0f;
          }
        }
      }
    }
    if (f & 2) {
      const size_t row = (size_t)wt[i] * P;
#pragma unroll
      for (int q = 0; q < PPT; ++q)
        store_pixel(PACKED ? __int_as_float(bk[q] & mask) : bz[q], bs[q],
                    row + threadIdx.x + q * blockDim.x, z_out, slot_out);
      return;
    }
  }
}

// micro_pass1's per-lane setup of lane l (fx0 = tile % kNumTx, its
// quirk: no * 128) into c[k * tc + l]: ka1 kb1 kc1 ka2 kb2 kc2 kaz kbz kcz.
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
  c[l] = ka1;
  c[tc + l] = kb1;
  c[2 * tc + l] = kc1;
  c[3 * tc + l] = ka2;
  c[4 * tc + l] = kb2;
  c[5 * tc + l] = kc2;
  c[6 * tc + l] = ka1 * dz1 + ka2 * dz2;
  c[7 * tc + l] = kb1 * dz1 + kb2 * dz2;
  c[8 * tc + l] = az + kc1 * dz1 + kc2 * dz2;
}

template <int VARIANT, int PPT>
__global__ void __launch_bounds__(1024)
    setup_kernel(const int* __restrict__ wt, const int* __restrict__ wc,
                 const int* __restrict__ fl, int n_work,
                 const float* __restrict__ chunks, int P, int tc,
                 float* __restrict__ z_out, int* __restrict__ pos_out) {
  const int start = blockIdx.x;
  if (!(fl[start] & 1)) return;
  extern __shared__ float smem[];
  float px[PPT], py[PPT], bz[PPT], bp[PPT];
  int bl[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * blockDim.x;
    px[q] = 0.5f + (float)(p % tc);
    py[q] = 0.5f + (float)(p / tc);
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
      __syncthreads();
      if (VARIANT < 2) {
        for (int c = threadIdx.x; c < 24 * tc; c += blockDim.x)
          smem[c] = rows[c];
        __syncthreads();
        acc += smem[threadIdx.x % (24 * tc)];
      } else {
        const float fx0 = (float)(wt[i] % kNumTx);
        for (int l = threadIdx.x; l < tc; l += blockDim.x)
          setup_lane(rows, tc, l, fx0, smem);
        __syncthreads();
        const float base = (float)(wc[i] * tc);
        for (int l = 0; l < tc; ++l) {
          const float* c = smem + l;
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            const float zm =
                cover((px[q] * c[0] + py[q] * c[tc]) + c[2 * tc],
                      (px[q] * c[3 * tc] + py[q] * c[4 * tc]) + c[5 * tc],
                      (px[q] * c[6 * tc] + py[q] * c[7 * tc]) + c[8 * tc]);
            lane_update(zm, l, base + (float)l, bz[q], bl[q], bp[q]);
          }
        }
      }
    }
    if (f & 2) {
      const size_t row = (size_t)wt[i] * P;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const size_t o = row + threadIdx.x + q * blockDim.x;
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

// Both walks run one block per step, one thread a pixel up to 1024
// threads and P / 1024 pixels a thread above (the wrapper admits P of
// 2048 and 4096 there).
template <int EVAL, bool PACKED, int STAGE>
int launch_walk(cudaStream_t st, const int* wt, const int* wc, const int* fl,
                int n_work, const float* chunks, const void* chunks_k6,
                int P, int tc, int translate, float* z_out, int* slot_out) {
  if (n_work <= 0) return (int)cudaGetLastError();
  const int block = P < 1024 ? P : 1024;
  const size_t smem = sizeof(float) * (staged_rows<EVAL>() * 3 * tc + tc);
  const uint16_t* k6 = (const uint16_t*)chunks_k6;
#define VRI_WALK(N)                                                       \
  walk_kernel<EVAL, PACKED, STAGE, N><<<n_work, block, smem, st>>>(       \
      wt, wc, fl, n_work, chunks, k6, P, tc, translate, z_out, slot_out)
  switch (P / block) {
    case 1: VRI_WALK(1); break;
    case 2: VRI_WALK(2); break;
    case 4: VRI_WALK(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VRI_WALK
  return (int)cudaGetLastError();
}

template <int VARIANT>
int launch_setup(cudaStream_t st, const int* wt, const int* wc,
                 const int* fl, int n_work, const float* chunks, int P,
                 int tc, float* z_out, int* pos_out) {
  if (n_work <= 0) return (int)cudaGetLastError();
  const int block = P < 1024 ? P : 1024;
  const size_t smem = sizeof(float) * 24 * tc;   // >= the 9 setup rows
#define VRI_SETUP(N)                                                      \
  setup_kernel<VARIANT, N><<<n_work, block, smem, st>>>(                  \
      wt, wc, fl, n_work, chunks, P, tc, z_out, pos_out)
  switch (P / block) {
    case 1: VRI_SETUP(1); break;
    case 2: VRI_SETUP(2); break;
    case 4: VRI_SETUP(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VRI_SETUP
  return (int)cudaGetLastError();
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
