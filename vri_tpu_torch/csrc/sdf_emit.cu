// The SDF brick emit (vri_tpu_torch/ops/sdf_build.py:_emit_block and
// _emit_texels) as one kernel: a block of 256 threads a brick.
//
// For its brick the block walks the candidate rows of the brick's cell's
// 27-neighbourhood (27 x K slots) and of its cascade's global list (Kg
// slots), in the plain version's candidate order.  A candidate counts when
// its id is >= 0 and, for a cell slot, when the slot's cell lies in the
// grid and is the one that owns the triangle (the clamp of its AABB
// center's cell into the neighbourhood).  Its key is the bit pattern of
// its squared AABB distance to the brick center shifted left 24 bits, or
// its candidate index: every key is unique, so the k least keys are the
// plain version's top-k.  The block keeps them in a shared buffer: each
// round of 256 candidates appends those below the running k-th key, and a
// buffer near full is sorted (bitonic) and cut to its k least.  Then each
// thread takes texels of the brick and reduces the exact distance to the
// selected candidates' triangles in key order, as the plain version does.
// Every float operation is the plain version's, in its order, and the file
// is built with -fmad=false, so the output is bit-equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 11;          // lo3 hi3 n3 nda id
constexpr int kCap = 2048;        // shared key buffer
constexpr int kMaxK = 64;         // largest k (max_triangles_per_brick)
constexpr float kBig = 3.0e38f;
constexpr unsigned long long kNone = ~0ull;

// torch.minimum / torch.maximum / torch.clamp: NaN wins
__device__ __forceinline__ float t_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float t_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float dot3(float ux, float uy, float uz,
                                      float vx, float vy, float vz) {
  float px = ux * vx, py = uy * vy, pz = uz * vz;
  return (px + py) + pz;
}

// geometry.point_triangle_distance, op for op
__device__ float point_triangle_distance(const float* p, const float* a,
                                         const float* b, const float* c) {
  float ab[3], ac[3], ap[3], bp[3], cp[3];
  for (int k = 0; k < 3; ++k) {
    ab[k] = b[k] - a[k];
    ac[k] = c[k] - a[k];
    ap[k] = p[k] - a[k];
    bp[k] = p[k] - b[k];
    cp[k] = p[k] - c[k];
  }
  float d1 = dot3(ab[0], ab[1], ab[2], ap[0], ap[1], ap[2]);
  float d2 = dot3(ac[0], ac[1], ac[2], ap[0], ap[1], ap[2]);
  float d3 = dot3(ab[0], ab[1], ab[2], bp[0], bp[1], bp[2]);
  float d4 = dot3(ac[0], ac[1], ac[2], bp[0], bp[1], bp[2]);
  float d5 = dot3(ab[0], ab[1], ab[2], cp[0], cp[1], cp[2]);
  float d6 = dot3(ac[0], ac[1], ac[2], cp[0], cp[1], cp[2]);
  float va = d3 * d6 - d5 * d4;
  float vb = d5 * d2 - d1 * d6;
  float vc = d1 * d4 - d3 * d2;
  float sv = (vb + va) + vc;
  float denom_v = 1.0f / (fabsf(sv) > 1e-30f ? sv : 1.0f);
  float e_ab = d1 - d3;
  float v_ab = t_clamp(d1 / (fabsf(e_ab) > 1e-30f ? e_ab : 1.0f), 0.f, 1.f);
  float e_ac = d2 - d6;
  float w_ac = t_clamp(d2 / (fabsf(e_ac) > 1e-30f ? e_ac : 1.0f), 0.f, 1.f);
  float num_bc = d4 - d3;
  float den_bc = (d4 - d3) + (d5 - d6);
  float w_bc = t_clamp(num_bc / (fabsf(den_bc) > 1e-30f ? den_bc : 1.0f),
                       0.f, 1.f);
  float v_in = vb * denom_v;
  float w_in = vc * denom_v;
  bool in_a = (d1 <= 0.f) && (d2 <= 0.f);
  bool in_b = (d3 >= 0.f) && (d4 <= d3);
  bool in_c = (d6 >= 0.f) && (d5 <= d6);
  bool on_ab = (vc <= 0.f) && (d1 >= 0.f) && (d3 <= 0.f) && !in_a && !in_b;
  bool on_ac = (vb <= 0.f) && (d2 >= 0.f) && (d6 <= 0.f) && !in_a && !in_c
               && !on_ab;
  bool on_bc = (va <= 0.f) && ((d4 - d3) >= 0.f) && ((d5 - d6) >= 0.f)
               && !in_b && !in_c && !on_ab && !on_ac;
  float v = (in_a || in_c) ? 0.f
            : in_b ? 1.f
            : on_ab ? v_ab
            : on_ac ? 0.f
            : on_bc ? 1.0f - w_bc : v_in;
  float w = (in_a || in_b) ? 0.f
            : in_c ? 1.f
            : on_ab ? 0.f
            : on_ac ? w_ac
            : on_bc ? w_bc : w_in;
  float q[3];
  for (int k = 0; k < 3; ++k) {
    float cpk = (a[k] + v * ab[k]) + w * ac[k];
    q[k] = p[k] - cpk;
  }
  return sqrtf(dot3(q[0], q[1], q[2], q[0], q[1], q[2]));
}

// sort buf[0, kCap) ascending (bitonic), the whole block
__device__ void block_sort(unsigned long long* buf) {
  for (int k = 2; k <= kCap; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kCap; i += kThreads) {
        int ixj = i ^ j;
        if (ixj > i) {
          unsigned long long x = buf[i], y = buf[ixj];
          bool up = (i & k) == 0;
          if ((x > y) == up) {
            buf[i] = y;
            buf[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// keep the k least keys of the buffer: sort, cut, refill with kNone
__device__ void block_trim(unsigned long long* buf, int* cnt,
                           unsigned long long* thresh, int k) {
  for (int i = *cnt + threadIdx.x; i < kCap; i += kThreads) buf[i] = kNone;
  __syncthreads();
  block_sort(buf);
  int kept = *cnt < k ? *cnt : k;
  for (int i = kept + threadIdx.x; i < kCap; i += kThreads) buf[i] = kNone;
  __syncthreads();
  if (threadIdx.x == 0) {
    *cnt = kept;
    if (kept == k) *thresh = buf[k - 1];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sdf_emit_kernel(const long long* __restrict__ bids, int n,
                const int* __restrict__ brick_voxel,
                const float* __restrict__ origins,
                const float* __restrict__ vs,
                int r, const float* __restrict__ cell_rows, int K,
                const float* __restrict__ glob_rows, int Kg,
                const float* __restrict__ tri,       // (F, 3, 3): a, b, c
                const unsigned char* __restrict__ valid,
                const float* __restrict__ tri_albedo,
                const float* __restrict__ tri_emissive,
                const float* __restrict__ tri_n, int bsz, int k_tris,
                float trunc_vox, int atlas_u8, void* atlas,
                float* __restrict__ alb_out, float* __restrict__ emi_out,
                float* __restrict__ nrm_out,
                long long* __restrict__ near_out) {
  __shared__ unsigned long long buf[kCap];
  __shared__ unsigned long long thresh;
  __shared__ int cnt, near;
  __shared__ int sel[kMaxK];

  const int brick = blockIdx.x;
  if (brick >= n) return;
  const int s = r / 16;
  const int r3 = r * r * r;
  const int bv = brick_voxel[bids[brick]];
  const int ni = bv / r3;
  const int rem = bv % r3;
  const int vx = rem % r, vy = (rem / r) % r, vz = rem / (r * r);
  const float vsz = vs[ni];
  const float org[3] = {origins[ni * 3], origins[ni * 3 + 1],
                        origins[ni * 3 + 2]};
  const float vmin[3] = {org[0] + (float)vx * vsz, org[1] + (float)vy * vsz,
                         org[2] + (float)vz * vsz};
  const float half = 0.5f * vsz;
  const float bc[3] = {vmin[0] + half, vmin[1] + half, vmin[2] + half};
  const float trunc_w = trunc_vox * vsz;
  const float tw2 = trunc_w * trunc_w;
  const float cellw = (float)s * vsz;
  const int cxyz[3] = {vx / s, vy / s, vz / s};
  int lo_nb[3], hi_nb[3];
  for (int k = 0; k < 3; ++k) {
    lo_nb[k] = cxyz[k] - 1 < 0 ? 0 : cxyz[k] - 1;
    hi_nb[k] = cxyz[k] + 1 > 15 ? 15 : cxyz[k] + 1;
  }

  if (threadIdx.x == 0) {
    cnt = 0;
    near = 0;
    thresh = kNone;
  }
  for (int i = threadIdx.x; i < kCap; i += kThreads) buf[i] = kNone;
  __syncthreads();

  const long long n_cell = 27LL * K;
  const long long total = n_cell + Kg;
  for (long long base = 0; base < total; base += kThreads) {
    const long long idx = base + threadIdx.x;
    bool ok = false;
    float d2 = 0.f;
    if (idx < total) {
      const float* row;
      bool cand = true;
      int nb[3];
      if (idx < n_cell) {
        const int j = (int)(idx / K), slot = (int)(idx % K);
        const int off[3] = {j % 3 - 1, (j / 3) % 3 - 1, j / 9 - 1};
        for (int k = 0; k < 3; ++k) {
          const int raw = cxyz[k] + off[k];
          cand = cand && raw >= 0 && raw < 16;
          nb[k] = raw < 0 ? 0 : (raw > 15 ? 15 : raw);
        }
        const long long cell = (long long)ni * 4096
                               + (nb[2] * 16 + nb[1]) * 16 + nb[0];
        row = cell_rows + (cell * K + slot) * kRow;
      } else {
        row = glob_rows + ((long long)ni * Kg + (idx - n_cell)) * kRow;
      }
      if (cand && row[10] >= 0.f) {
        float lo[3] = {row[0], row[1], row[2]};
        float hi[3] = {row[3], row[4], row[5]};
        bool owner = true;
        if (idx < n_cell) {
          for (int k = 0; k < 3; ++k) {
            float ctr = 0.5f * (lo[k] + hi[k]);
            int cc = (int)floorf((ctr - org[k]) / cellw);
            int canon = cc < lo_nb[k] ? lo_nb[k] : cc;
            canon = canon > hi_nb[k] ? hi_nb[k] : canon;
            owner = owner && canon == nb[k];
          }
        }
        if (owner) {
          float dm[3];
          for (int k = 0; k < 3; ++k) {
            float dl = t_clamp_min(lo[k] - bc[k], 0.f);
            float dh = t_clamp_min(bc[k] - hi[k], 0.f);
            dm[k] = t_max(dl, dh);
          }
          d2 = dot3(dm[0], dm[1], dm[2], dm[0], dm[1], dm[2]);
          ok = d2 < kBig;
        }
      }
    }
    if (ok) {
      if (d2 <= tw2) atomicAdd(&near, 1);
      const unsigned long long key =
          ((unsigned long long)(unsigned)__float_as_int(d2) << 24)
          | (unsigned long long)idx;
      if (key < thresh) buf[atomicAdd(&cnt, 1)] = key;
    }
    __syncthreads();
    const int c = cnt;
    __syncthreads();   // every thread has read cnt before the next round
    if (c > kCap - kThreads) block_trim(buf, &cnt, &thresh, k_tris);
  }
  block_trim(buf, &cnt, &thresh, k_tris);

  // the selected candidates' triangle ids, nearest first
  const int m = cnt;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const long long idx = (long long)(buf[i] & 0xFFFFFFull);
    const float* row;
    if (idx < n_cell) {
      const int j = (int)(idx / K), slot = (int)(idx % K);
      const int off[3] = {j % 3 - 1, (j / 3) % 3 - 1, j / 9 - 1};
      int nb[3];
      for (int k = 0; k < 3; ++k) nb[k] = cxyz[k] + off[k];
      const long long cell = (long long)ni * 4096
                             + (nb[2] * 16 + nb[1]) * 16 + nb[0];
      row = cell_rows + (cell * K + slot) * kRow;
    } else {
      row = glob_rows + ((long long)ni * Kg + (idx - n_cell)) * kRow;
    }
    sel[i] = (int)row[10];
  }
  __syncthreads();

  const int nt = bsz * bsz * bsz;
  const float fb = (float)bsz;
  for (int t = threadIdx.x; t < nt; t += kThreads) {
    const int tx = t % bsz, ty = (t / bsz) % bsz, tz = t / (bsz * bsz);
    const float p[3] = {vmin[0] + (((float)tx + 0.5f) / fb) * vsz,
                        vmin[1] + (((float)ty + 0.5f) / fb) * vsz,
                        vmin[2] + (((float)tz + 0.5f) / fb) * vsz};
    float dmin = kBig;
    for (int kk = 0; kk < m; ++kk) {
      const int tr = sel[kk];
      if (!valid[tr]) continue;
      const float* v = tri + (long long)tr * 9;
      dmin = t_min(dmin, point_triangle_distance(p, v, v + 3, v + 6));
    }
    const float d01 = t_clamp(dmin / trunc_w, 0.f, 1.f);
    const long long o = (long long)brick * nt + t;
    if (atlas_u8)
      ((unsigned char*)atlas)[o] = (unsigned char)rintf(d01 * 255.0f);
    else
      ((float*)atlas)[o] = d01;
  }
  if (threadIdx.x < 3) {
    const int k = threadIdx.x;
    const bool ok0 = m > 0;
    const long long t0 = ok0 ? (long long)sel[0] * 3 + k : 0;
    alb_out[brick * 3 + k] = ok0 ? tri_albedo[t0] : 0.f;
    emi_out[brick * 3 + k] = ok0 ? tri_emissive[t0] : 0.f;
    nrm_out[brick * 3 + k] = ok0 ? tri_n[t0] : 0.f;
  }
  if (threadIdx.x == 0) near_out[brick] = near > k_tris ? near - k_tris : 0;
}

}  // namespace

extern "C" int vri_sdf_emit(
    const long long* bids, int n, const int* brick_voxel,
    const float* origins, const float* vs, int r, const float* cell_rows,
    int K, const float* glob_rows, int Kg, const float* tri,
    const unsigned char* valid, const float* tri_albedo,
    const float* tri_emissive, const float* tri_n, int bsz, int k_tris,
    float trunc_vox, int atlas_u8, void* atlas, float* alb, float* emi,
    float* nrm, long long* near_drop, void* stream) {
  if (n <= 0) return 0;
  if (k_tris < 1 || k_tris > kMaxK || k_tris > kCap - kThreads) return -1;
  if (r % 16 != 0 || 27LL * K + Kg >= (1LL << 24)) return -2;
  sdf_emit_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      bids, n, brick_voxel, origins, vs, r, cell_rows, K, glob_rows, Kg, tri,
      valid, tri_albedo, tri_emissive, tri_n, bsz, k_tris, trunc_vox,
      atlas_u8, atlas, alb, emi, nrm, near_drop);
  return (int)cudaGetLastError();
}
