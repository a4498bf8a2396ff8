// Probe of warp-wide shared-memory loads, for the work-list walks' record
// layout (csrc/worklist.cu): does a 16-byte load that every thread of a
// warp makes at one address cost one shared-memory wavefront, as a
// 4-byte one does?
//
// Each of kBlocks blocks of kThreads threads makes kIters x kUnroll
// warp-wide loads per warp, each consumed by one FP32 add into one of
// four sums, in a mode:
//   0  4 bytes at one address for the whole warp (a broadcast);
//   1  16 bytes at one address (a broadcast);
//   2  16 bytes at each thread's own address: 512 bytes a warp, four
//      wavefronts of 128 bytes -- the yardstick.
// The loads are inline PTX so the compiler keeps their width.  Built and
// timed by vri_tpu_torch/tools/kernel_turns.py.

#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 132 * 8;
constexpr int kThreads = 256;
constexpr int kIters = 2048;
constexpr int kUnroll = 16;

template <int MODE>
__global__ void __launch_bounds__(kThreads) probe(float* out) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += kThreads)
    buf[i] = make_float4((float)i, 1.0f, 2.0f, 3.0f);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < kIters; ++it) {
    const float4* base =
        buf + (it % 32) * 32 + (MODE == 2 ? lane : 0);
    const unsigned a =
        (unsigned)__cvta_generic_to_shared(base);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x, y, z, w;
      if (MODE == 0) {
        asm volatile("ld.shared.f32 %0, [%1];"
                     : "=f"(x) : "r"(a + u * 16 * 32));
      } else {
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                     : "r"(a + u * 16 * 32));
      }
      acc[u % 4] += x;
    }
  }
  const float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  if (s == -1.0f) out[0] = s;   // never: keeps the loads alive
}

}  // namespace

// count_only: the warp-wide loads a launch makes; else one launch of
// mode on the stream, returning cudaGetLastError().
extern "C" int vri_lds_probe(int mode, float* out, int count_only,
                             void* stream) {
  if (count_only) return kBlocks * (kThreads / 32) * kIters * kUnroll;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: probe<0><<<kBlocks, kThreads, 0, st>>>(out); break;
    case 1: probe<1><<<kBlocks, kThreads, 0, st>>>(out); break;
    case 2: probe<2><<<kBlocks, kThreads, 0, st>>>(out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
