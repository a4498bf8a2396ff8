// Kernel M: voxel-precision march of SDF occlusion / GI rays through the
// coarse-cell and surface-bit tables (SDFCascades.march_*).
//
// Replaces the two TPU march kernels:
//   vri_tpu/ops/march_kernel.py:_march_stream_kernel (K3, persistent
//     lanes with 32-deep ray queues and in-kernel refills)
//   vri_tpu/ops/march_kernel.py:_march_block_kernel  (K4, lock-step
//     1024-ray blocks)
// Both run the same per-ray step, _march_step (march_kernel.py:106-218),
// and give the same result per ray.  K3's queues exist only to beat the
// TPU's lock-step vectors; on a GPU one thread marches one ray with its
// own control flow, so this one kernel fulfils both contracts.
//
// One thread = one ray, at most max_steps iterations of the step:
//   finest containing cascade (scanned coarse -> fine so the finest
//   wins), voxel = truncate-then-clip of the local coordinate, a 4-bit
//   Chebyshev distance from the coarse cell grid (8 cells per i32 word),
//   then, in a surface cell, the voxel's bit in the cell's fine words
//   (fetched once per cell entry and cached in registers).
// The operation order follows the reference to the letter (inv_vs = 1/vs
// once per cascade, (p - origin) * inv_vs, |target - l| * vs / |d|, the
// 0.05 and 0.01 voxel nudges) and the library is built with -fmad=false:
// a trajectory one ulp off can land in a different voxel.  The plain
// PyTorch version (march_rays_reference) runs the same operations and
// agrees bit for bit.
//
// Bound on the H100: per step a thread does ~150 FP32/int operations and
// one dependent 4-byte load from the coarse table (12 KB at the room
// preset) plus, on cell entry, one or two loads from the fine tables
// (2 x 96 KB); all of it stays in L1/L2.  The march is latency-bound on
// those dependent loads and divergent in step count across a warp (rays
// finish at different steps).  Staging the tables in shared memory and
// regrouping rays by remaining work are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCascades = 16;
constexpr float kBig = 3.0e38f;

// Distance along the ray to the exit of the box [lo, lo + width) on one
// axis, in world units (BIG when the ray does not move on that axis).
__device__ __forceinline__ float axis_exit(float d, float l, float lo,
                                           float width, float vsl) {
  const float tgt = d > 0.0f ? lo + width : lo;
  const float ad = fabsf(d);
  const float safe = ad < 1e-9f ? 1e-9f : ad;
  const float t = fabsf(tgt - l) * vsl / safe;
  return ad < 1e-9f ? kBig : t;
}

__global__ void march_rays_kernel(const float* __restrict__ rays, int m,
                                  const float* __restrict__ meta, int n_cas,
                                  int r, int log2s,
                                  const int* __restrict__ coarse,
                                  const int* __restrict__ fine0,
                                  const int* __restrict__ fine1,
                                  int max_steps, float* __restrict__ t_out,
                                  int* __restrict__ hv_out,
                                  int* __restrict__ it_out,
                                  int* __restrict__ act_out) {
  __shared__ float s_vs[kMaxCascades], s_inv[kMaxCascades];
  __shared__ float s_ogx[kMaxCascades], s_ogy[kMaxCascades],
      s_ogz[kMaxCascades];
  if (threadIdx.x < n_cas) {
    const float v = meta[threadIdx.x];
    s_vs[threadIdx.x] = v;
    s_inv[threadIdx.x] = 1.0f / v;
    s_ogx[threadIdx.x] = meta[n_cas + threadIdx.x];
    s_ogy[threadIdx.x] = meta[2 * n_cas + threadIdx.x];
    s_ogz[threadIdx.x] = meta[3 * n_cas + threadIdx.x];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;

  const float ox = rays[i], oy = rays[m + i], oz = rays[2 * m + i];
  const float dx = rays[3 * m + i], dy = rays[4 * m + i],
              dz = rays[5 * m + i];
  const float t0 = rays[6 * m + i], tmax = rays[7 * m + i];
  const float tent = rays[8 * m + i], tgrace = rays[9 * m + i];

  const int s = 1 << log2s;
  const int s3 = s * s * s;
  const float rf = (float)r;
  const float sw = (float)s;
  const float vs_coarse = s_vs[n_cas - 1];

  float t = t0;
  bool act = t0 < tmax;
  int hv = -1, it = 0, cell = -1, w0 = 0, w1 = 0;
  while (act && it < max_steps) {
    const float px = ox + dx * t;
    const float py = oy + dy * t;
    const float pz = oz + dz * t;
    int cas = n_cas;
    float lx = 0.0f, ly = 0.0f, lz = 0.0f, vsl = vs_coarse;
    for (int c = n_cas - 1; c >= 0; --c) {
      const float lxi = (px - s_ogx[c]) * s_inv[c];
      const float lyi = (py - s_ogy[c]) * s_inv[c];
      const float lzi = (pz - s_ogz[c]) * s_inv[c];
      if (lxi >= 0.0f && lxi < rf && lyi >= 0.0f && lyi < rf &&
          lzi >= 0.0f && lzi < rf) {
        cas = c;
        lx = lxi;
        ly = lyi;
        lz = lzi;
        vsl = s_vs[c];
      }
    }
    const bool inside = cas < n_cas;
    const int cas_c = min(cas, n_cas - 1);
    const int vx = min(max((int)lx, 0), r - 1);
    const int vy = min(max((int)ly, 0), r - 1);
    const int vz = min(max((int)lz, 0), r - 1);
    const int ccx = vx >> log2s, ccy = vy >> log2s, ccz = vz >> log2s;
    const int cflat = cas_c * 4096 + (ccz * 16 + ccy) * 16 + ccx;
    const int cd = (__ldg(coarse + (cflat >> 3)) >> ((cflat & 7) * 4)) & 15;
    const bool near = inside && cd == 0;
    if (near && cflat != cell) {
      w0 = __ldg(fine0 + cflat);
      w1 = s3 > 32 ? __ldg(fine1 + cflat) : w0;
      cell = cflat;
    }
    const int bit = ((vz & (s - 1)) * s + (vy & (s - 1))) * s + (vx & (s - 1));
    const int word = (s3 > 32 && bit >= 32) ? w1 : w0;
    const bool hit_now = near && ((word >> (bit & 31)) & 1) && t >= tgrace;

    const float vox_exit = fmaxf(
        fminf(fminf(fminf(kBig, axis_exit(dx, lx, (float)vx, 1.0f, vsl)),
                    axis_exit(dy, ly, (float)vy, 1.0f, vsl)),
              axis_exit(dz, lz, (float)vz, 1.0f, vsl)),
        0.0f);
    const float cell_exit = fmaxf(
        fminf(fminf(fminf(kBig, axis_exit(dx, lx, (float)(ccx << log2s),
                                          sw, vsl)),
                    axis_exit(dy, ly, (float)(ccy << log2s), sw, vsl)),
              axis_exit(dz, lz, (float)(ccz << log2s), sw, vsl)),
        0.0f);
    const float cell_w = vsl * sw;
    const float skip =
        fmaxf(cell_exit, ((float)cd - 1.0f) * cell_w) + 0.05f * vsl;
    float adv = near ? vox_exit + 0.01f * vsl : skip;
    adv = inside ? adv : vs_coarse;
    const bool escaped = !inside && t > tent + 1e-3f;
    const float new_t = t + adv;
    const bool over = new_t >= tmax;
    if (hit_now) hv = cas_c * (r * r * r) + (vz * r + vy) * r + vx;
    if (hit_now || over || escaped) act = false;
    if (!hit_now) t = new_t;
    ++it;
  }
  t_out[i] = t;
  hv_out[i] = hv;
  it_out[i] = it;
  act_out[i] = act ? 1 : 0;
}

}  // namespace

extern "C" int vri_march_rays(const float* rays, int m, const float* meta,
                              int n_cas, int r, int log2s, const int* coarse,
                              const int* fine0, const int* fine1,
                              int max_steps, float* t_out, int* hv_out,
                              int* it_out, int* act_out, void* stream) {
  if (m > 0) {
    const int block = 256;
    march_rays_kernel<<<(m + block - 1) / block, block, 0,
                        (cudaStream_t)stream>>>(
        rays, m, meta, n_cas, r, log2s, coarse, fine0, fine1, max_steps,
        t_out, hv_out, it_out, act_out);
  }
  return (int)cudaGetLastError();
}
