// Kernel bvh_traverse: nearest ray-triangle hit through the implicit
// Morton-ordered LBVH (vri_tpu_torch/ops/bvh.py).
//
// Replaces vri_tpu/ops/bvh_kernel.py:_traverse_kernel (K8), and is also
// the card's form of the XLA traversal vri_tpu/ops/bvh.py:traverse.  K8
// is a lock-step packet walk: a 1024-ray block shares one SMEM stack and
// descends a node when ANY lane hits it, so the block pays for the union
// of its rays' walks, cut at max_nodes pops.  A GPU gives every thread
// its own control flow, so here one thread walks one ray with its own
// stack, in pixel order (a warp is 32 neighbouring pixels of a row, which
// mostly walk the same nodes).  A per-ray walk pops each node at most
// once, so nothing needs cutting and max_nodes has no counterpart.
//
// The walk is traverse's exact per-ray order, so the kernel agrees bit
// for bit with the plain PyTorch version (bvh_traverse_reference; the
// library is built with -fmad=false and PyTorch rounds every operation):
//   * pop (the index clamped to kMaxDepth - 1), slab test against the
//     current best t, inv_d with the signed 1e-12 clamp;
//   * a leaf runs Moller-Trumbore on its K slots (EPS 1e-9, t > 1e-4,
//     t < best t, all against the best t before the leaf) and takes the
//     first minimum by strict "<", as argmin does; u and v are the chosen
//     slot's even when no slot hit (then t is 3e38 and loses to best t);
//   * an internal node slab-tests both children and pushes the hit ones,
//     the far one (by t_near, strict "<" swaps) first;
//   * each ray starts from its own t_max.
// Deliberate differences from K8: K8 clamps det at 1e-12 (traverse and
// this kernel use EPS = 1e-9), pushes children unordered, and its
// trace_packet_hits reports u = v = 0 (this one returns the hit's u, v).
// From both K8 and traverse: a node with an empty box (lo > hi: the
// padded leaves past num_faces and their ancestors) is never entered.
// Its inverted slabs pass their slab test for every ray, so they walk
// every empty subtree to its leaves and find nothing; on the 49k
// kitchen's 65,536-slot pool that was 4,041 of the 4,140.5 pops and
// 16,192 of the 16,298 triangle tests of a mean 1080p camera ray.
// Skipping them changes no output.
//
// Memory: nodes are 32-byte rows [lo3 | hi3 | pad2], triangles 48-byte
// rows [v0 | e1 | e2 | slot | valid | pad] (ops/bvh.py:BVH), both read as
// 16-byte float4 through the read-only cache; on the 49k kitchen (8,192
// leaves) the two tables are 0.5 MB + 3 MB and stay resident in the 50 MB
// L2.  The stack (kMaxDepth = 64 ints) lives in local memory, cached in
// L1.
//
// Bound on the H100: each ray reads 28 bytes and writes 16, so device
// memory moves ~95 MB at 1080p (~0.03 ms at 3.35 TB/s); the FP32 work is
// ~25 operations per node pop and ~54 per triangle test, about 8,200 per
// camera ray on the kitchen (99.5 pops, 106 tests), which bounds the walk
// at 0.25 ms at 67 TFLOP/s.  The kernel takes 3.5 ms: the walk is
// latency-bound on dependent L2 loads and divergent across a warp (rays
// pop different numbers of nodes); packet tricks and a treelet layout are
// left for later work.

#include <cuda_runtime.h>

namespace {

// a walk uses at most log2(L) + 2 entries (ops/bvh.py:MAX_STACK_DEPTH)
constexpr int kMaxDepth = 64;
constexpr float kInf = 3.0e38f;
constexpr float kEps = 1.0e-9f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float inv_dir(float d) {
  const float tiny = d < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(d) < 1e-12f ? tiny : d);
}

// Slab test of node row `node` against t_best: returns the hit flag
// (false for an empty box, lo.x > hi.x) and writes t_near (the max of
// the per-axis entries).
__device__ __forceinline__ bool slab(const float4* __restrict__ nodes,
                                     int node, const Ray& r, float t_best,
                                     float* t_near) {
  const float4 a = __ldg(nodes + 2 * node);
  const float4 b = __ldg(nodes + 2 * node + 1);
  // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z pad pad
  const float tx0 = (a.x - r.ox) * r.ix, tx1 = (a.w - r.ox) * r.ix;
  const float ty0 = (a.y - r.oy) * r.iy, ty1 = (b.x - r.oy) * r.iy;
  const float tz0 = (a.z - r.oz) * r.iz, tz1 = (b.y - r.oz) * r.iz;
  const float tmin =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tmax =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  *t_near = tmin;
  return a.x <= a.w && tmax >= fmaxf(tmin, 0.0f) && tmin < t_best;
}

__global__ void __launch_bounds__(128)
    bvh_traverse_kernel(const float* __restrict__ origins,
                        const float* __restrict__ dirs,
                        const float* __restrict__ t_max, int n,
                        const float4* __restrict__ nodes,
                        const float4* __restrict__ tris, int num_leaves,
                        int leaf_size, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ visits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = origins[3 * i];
  r.oy = origins[3 * i + 1];
  r.oz = origins[3 * i + 2];
  r.dx = dirs[3 * i];
  r.dy = dirs[3 * i + 1];
  r.dz = dirs[3 * i + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  const int first_leaf = num_leaves - 1;

  float best_t = t_max[i];
  int best_slot = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int pops = 0, tests = 0;
  int stack[kMaxDepth];
  stack[0] = 0;  // the root
  int sp = 1;
  while (sp > 0) {
    const int node = stack[min(sp - 1, kMaxDepth - 1)];
    --sp;
    ++pops;
    float t_near;
    if (!slab(nodes, node, r, best_t, &t_near)) continue;
    if (node >= first_leaf) {
      const int slot0 = (node - first_leaf) * leaf_size;
      float tk = kInf, uk = 0.0f, vk = 0.0f;
      int k = 0;
      for (int j = 0; j < leaf_size; ++j) {
        const float4* row = tris + 3 * (slot0 + j);
        const float4 a = __ldg(row);      // v0.xyz e1.x
        const float4 b = __ldg(row + 1);  // e1.yz e2.xy
        const float4 c = __ldg(row + 2);  // e2.z slot valid pad
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const float pvx = r.dy * e2z - r.dz * e2y;
        const float pvy = r.dz * e2x - r.dx * e2z;
        const float pvz = r.dx * e2y - r.dy * e2x;
        const float det = (pvx * e1x + pvy * e1y) + pvz * e1z;
        const bool ok = fabsf(det) > kEps;
        const float inv = ok ? 1.0f / det : 0.0f;
        const float tvx = r.ox - a.x, tvy = r.oy - a.y, tvz = r.oz - a.z;
        const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = ((qvx * r.dx + qvy * r.dy) + qvz * r.dz) * inv;
        const float t = ((qvx * e2x + qvy * e2y) + qvz * e2z) * inv;
        const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                         t > 1e-4f && t < best_t && c.z > 0.5f;
        const float tt = hit ? t : kInf;
        if (j == 0 || tt < tk) {
          tk = tt;
          k = j;
          uk = u;
          vk = v;
        }
      }
      tests += leaf_size;
      if (tk < best_t) {
        best_t = tk;
        best_slot = slot0 + k;
        best_u = uk;
        best_v = vk;
      }
    } else {
      const int c0 = 2 * node + 1, c1 = 2 * node + 2;
      float t0, t1;
      const bool h0 = slab(nodes, c0, r, best_t, &t0);
      const bool h1 = slab(nodes, c1, r, best_t, &t1);
      const bool swap = t1 < t0;
      const int first = swap ? c1 : c0, second = swap ? c0 : c1;
      const bool fh = swap ? h1 : h0, sh = swap ? h0 : h1;
      if (sh) stack[min(sp++, kMaxDepth - 1)] = second;
      if (fh) stack[min(sp++, kMaxDepth - 1)] = first;
    }
  }
  t_out[i] = best_t;
  slot_out[i] = best_slot;
  u_out[i] = best_u;
  v_out[i] = best_v;
  if (visits != nullptr) {
    visits[2 * i] = pops;
    visits[2 * i + 1] = tests;
  }
}

}  // namespace

extern "C" int vri_bvh_traverse(const float* origins, const float* dirs,
                                const float* t_max, int n, const float* nodes,
                                const float* tris, int num_leaves,
                                int leaf_size, float* t_out, int* slot_out,
                                float* u_out, float* v_out, int* visits,
                                void* stream) {
  if (n > 0) {
    const int block = 128;
    bvh_traverse_kernel<<<(n + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(
        origins, dirs, t_max, n, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(tris), num_leaves, leaf_size,
        t_out, slot_out, u_out, v_out, visits);
  }
  return (int)cudaGetLastError();
}
