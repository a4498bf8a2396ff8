// Kernel M: voxel-precision march of SDF occlusion / GI rays through the
// coarse-cell and surface-bit tables (SDFCascades.march_*).
//
// Replaces the two TPU march kernels:
//   vri_tpu/ops/march_kernel.py:_march_stream_kernel (K3, persistent
//     lanes with 32-deep ray queues and in-kernel refills)
//   vri_tpu/ops/march_kernel.py:_march_block_kernel  (K4, lock-step
//     1024-ray blocks)
// Both run the same per-ray step, _march_step (march_kernel.py:106-218),
// and give the same result per ray, as this kernel does.
//
// What bounds it on the H100.  A step is ~130 FP32/int operations and
// one dependent load of the coarse table, plus one or two loads of the
// fine tables (2 x 96 KB at the room preset, L1/L2-resident) when the
// ray enters a surface cell.  Rays end at very different step counts,
// and a warp runs in lock-step until its slowest lane's ray ends: with
// one ray a thread (the first port), most of a warp's step slots did no
// work.  K3 fixed the same waste on the TPU's 1024-lane vectors with
// per-lane queues refilled in the kernel; this kernel is K3's service
// point written for a warp:
//
// * Persistent warps.  The grid is as many 256-thread blocks as fit on
//   the card at once (the occupancy calculator's blocks per SM times the
//   SM count).  Lane i starts on ray i; when its ray stops (hit, past
//   tmax, escaped, or out of max_steps) the lane writes that ray's t,
//   hv, it and act and takes the next ray index from a global counter
//   with one atomicAdd per warp (ballot of the lanes that need a ray,
//   each lane's offset its rank among them), then resets t, act, hv, the
//   cached cell and it from the new ray, as K3's service does.  Every
//   kRefillEvery steps the warp checks for finished lanes (a service
//   point).
// * Cheaper steps.  The coarse table (n_cas x 512 int32, 12 KB at the
//   room preset) is staged in shared memory at block start, so the
//   step's dependent lookup is a shared load.  The cascade search runs
//   from the finest cascade up and stops at the first that contains the
//   point -- the cascade the full coarse-to-fine scan of the first port
//   ended on, with its local coordinates from the same expressions.
//
// The operation order follows the reference to the letter (inv_vs = 1/vs
// once per cascade, (p - origin) * inv_vs, |target - l| * vs / |d|, the
// 0.05 and 0.01 voxel nudges) and the library is built with -fmad=false:
// a trajectory one ulp off can land in a different voxel.  A ray's
// trajectory depends only on its own fields, so the schedule does not
// change it; the plain PyTorch version (march_rays_reference) runs the
// same operations and agrees bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCascades = 16;
constexpr int kBlock = 256;
// Steps between service points.  A refilled lane waits for its ray's ten
// loads before it can step; checking every 4 steps lets a warp refill
// several lanes at one wait.  On the kitchen's 1080p shadow and GI rays
// (H100) 4 was the fastest of 1, 2, 4 and 8.
constexpr int kRefillEvery = 4;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

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

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmax, tent, tgrace;
};

// A lane's march state: the reference's (t, act, hv, it, cell, w0, w1).
struct State {
  float t;
  bool act;
  int hv, it, cell, w0, w1;
};

__device__ __forceinline__ void load_ray(const float* __restrict__ rays,
                                         int m, int i, Ray& ray, State& st) {
  ray.ox = __ldg(rays + i);
  ray.oy = __ldg(rays + m + i);
  ray.oz = __ldg(rays + 2 * m + i);
  ray.dx = __ldg(rays + 3 * m + i);
  ray.dy = __ldg(rays + 4 * m + i);
  ray.dz = __ldg(rays + 5 * m + i);
  const float t0 = __ldg(rays + 6 * m + i);
  ray.tmax = __ldg(rays + 7 * m + i);
  ray.tent = __ldg(rays + 8 * m + i);
  ray.tgrace = __ldg(rays + 9 * m + i);
  st.t = t0;
  st.act = t0 < ray.tmax;
  st.hv = -1;
  st.it = 0;
  st.cell = -1;
  st.w0 = 0;
  st.w1 = 0;
}

struct Tables {
  const float *vs, *inv, *ogx, *ogy, *ogz;  // shared, n_cas each
  const int* coarse;                        // shared, n_cas * 512
  const int* __restrict__ fine0;
  const int* __restrict__ fine1;
  int n_cas, r, log2s;
};

// One step of _march_step for one ray.
__device__ __forceinline__ void step(const Tables& k, const Ray& ray,
                                     State& st) {
  const int s = 1 << k.log2s;
  const int s3 = s * s * s;
  const float rf = (float)k.r;
  const float sw = (float)s;
  const float vs_coarse = k.vs[k.n_cas - 1];
  const float px = ray.ox + ray.dx * st.t;
  const float py = ray.oy + ray.dy * st.t;
  const float pz = ray.oz + ray.dz * st.t;
  // the finest cascade that contains the point
  int cas = k.n_cas;
  float lx = 0.0f, ly = 0.0f, lz = 0.0f, vsl = vs_coarse;
  for (int c = 0; c < k.n_cas; ++c) {
    const float lxi = (px - k.ogx[c]) * k.inv[c];
    const float lyi = (py - k.ogy[c]) * k.inv[c];
    const float lzi = (pz - k.ogz[c]) * k.inv[c];
    if (lxi >= 0.0f && lxi < rf && lyi >= 0.0f && lyi < rf && lzi >= 0.0f &&
        lzi < rf) {
      cas = c;
      lx = lxi;
      ly = lyi;
      lz = lzi;
      vsl = k.vs[c];
      break;
    }
  }
  const bool inside = cas < k.n_cas;
  const int cas_c = min(cas, k.n_cas - 1);
  const int r = k.r, log2s = k.log2s;
  const int vx = min(max((int)lx, 0), r - 1);
  const int vy = min(max((int)ly, 0), r - 1);
  const int vz = min(max((int)lz, 0), r - 1);
  const int ccx = vx >> log2s, ccy = vy >> log2s, ccz = vz >> log2s;
  const int cflat = cas_c * 4096 + (ccz * 16 + ccy) * 16 + ccx;
  const int cd = (k.coarse[cflat >> 3] >> ((cflat & 7) * 4)) & 15;
  const bool near = inside && cd == 0;
  if (near && cflat != st.cell) {
    st.w0 = __ldg(k.fine0 + cflat);
    st.w1 = s3 > 32 ? __ldg(k.fine1 + cflat) : st.w0;
    st.cell = cflat;
  }
  const int bit = ((vz & (s - 1)) * s + (vy & (s - 1))) * s + (vx & (s - 1));
  const int word = (s3 > 32 && bit >= 32) ? st.w1 : st.w0;
  const bool hit_now =
      near && ((word >> (bit & 31)) & 1) && st.t >= ray.tgrace;

  const float vox_exit = fmaxf(
      fminf(fminf(fminf(kBig, axis_exit(ray.dx, lx, (float)vx, 1.0f, vsl)),
                  axis_exit(ray.dy, ly, (float)vy, 1.0f, vsl)),
            axis_exit(ray.dz, lz, (float)vz, 1.0f, vsl)),
      0.0f);
  const float cell_exit = fmaxf(
      fminf(fminf(fminf(kBig, axis_exit(ray.dx, lx, (float)(ccx << log2s),
                                        sw, vsl)),
                  axis_exit(ray.dy, ly, (float)(ccy << log2s), sw, vsl)),
            axis_exit(ray.dz, lz, (float)(ccz << log2s), sw, vsl)),
      0.0f);
  const float cell_w = vsl * sw;
  const float skip =
      fmaxf(cell_exit, ((float)cd - 1.0f) * cell_w) + 0.05f * vsl;
  float adv = near ? vox_exit + 0.01f * vsl : skip;
  adv = inside ? adv : vs_coarse;
  const bool escaped = !inside && st.t > ray.tent + 1e-3f;
  const float new_t = st.t + adv;
  const bool over = new_t >= ray.tmax;
  if (hit_now) st.hv = cas_c * (r * r * r) + (vz * r + vy) * r + vx;
  if (hit_now || over || escaped) st.act = false;
  if (!hit_now) st.t = new_t;
  ++st.it;
}

// At most 64 registers a thread: four blocks an SM.
__global__ void __launch_bounds__(kBlock, 4)
    march_rays_kernel(const float* __restrict__ rays, int m,
                      const float* __restrict__ meta, int n_cas, int r,
                      int log2s, const int* __restrict__ coarse,
                      const int* __restrict__ fine0,
                      const int* __restrict__ fine1, int max_steps,
                      float* __restrict__ t_out, int* __restrict__ hv_out,
                      int* __restrict__ it_out, int* __restrict__ act_out,
                      int* __restrict__ counter) {
  extern __shared__ int s_coarse[];  // n_cas * 512 words
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
  const int4* src = reinterpret_cast<const int4*>(coarse);
  int4* dst = reinterpret_cast<int4*>(s_coarse);
  for (int e = threadIdx.x; e < n_cas * 128; e += blockDim.x)
    dst[e] = __ldg(src + e);
  __syncthreads();
  const Tables k{s_vs, s_inv, s_ogx, s_ogy, s_ogz, s_coarse, fine0, fine1,
                 n_cas, r, log2s};

  const int lanes = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < m;
  Ray ray{};
  State st{0.0f, false, -1, 0, -1, 0, 0};
  if (live) load_ray(rays, m, i, ray, st);
  while (true) {
    // service point: finished lanes write their ray and take the next
    const bool fin = live && !(st.act && st.it < max_steps);
    if (fin) {
      t_out[i] = st.t;
      hv_out[i] = st.hv;
      it_out[i] = st.it;
      act_out[i] = st.act ? 1 : 0;
    }
    const unsigned need = __ballot_sync(kFull, fin);
    if (need) {
      const int leader = __ffs(need) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counter, __popc(need));
      base = __shfl_sync(kFull, base, leader);
      if (fin) {
        i = lanes + base + __popc(need & below);
        live = i < m;
        if (live) load_ray(rays, m, i, ray, st);
      }
    }
    if (!__any_sync(kFull, live)) break;
#pragma unroll
    for (int j = 0; j < kRefillEvery; ++j)
      if (live && st.act && st.it < max_steps) step(k, ray, st);
  }
}

// Blocks of a launch over m rays: as many as fit the card at once (blocks
// per SM at full occupancy, with this n_cas's shared coarse table, times
// the SM count), or fewer when m rays need fewer.
cudaError_t launch_blocks(int n_cas, int m, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, march_rays_kernel, kBlock, (size_t)n_cas * 512 * 4);
  const int fit = (per_sm > 1 ? per_sm : 1) * sms;
  const int need = (m + kBlock - 1) / kBlock;
  *blocks = need < fit ? need : fit;
  return e;
}

}  // namespace

// Lanes (threads) of a launch over m rays, or -1 when the query fails.
extern "C" int vri_march_lanes(int n_cas, int m) {
  int blocks = 0;
  return launch_blocks(n_cas, m, &blocks) == cudaSuccess ? blocks * kBlock
                                                         : -1;
}

// ``counter`` is one int32 on the card, zero at launch.
extern "C" int vri_march_rays(const float* rays, int m, const float* meta,
                              int n_cas, int r, int log2s, const int* coarse,
                              const int* fine0, const int* fine1,
                              int max_steps, float* t_out, int* hv_out,
                              int* it_out, int* act_out, int* counter,
                              void* stream) {
  if (m > 0) {
    int blocks = 0;
    const cudaError_t e = launch_blocks(n_cas, m, &blocks);
    if (e != cudaSuccess) return (int)e;
    march_rays_kernel<<<blocks, kBlock, (size_t)n_cas * 512 * 4,
                        (cudaStream_t)stream>>>(
        rays, m, meta, n_cas, r, log2s, coarse, fine0, fine1, max_steps,
        t_out, hv_out, it_out, act_out, counter);
  }
  return (int)cudaGetLastError();
}
