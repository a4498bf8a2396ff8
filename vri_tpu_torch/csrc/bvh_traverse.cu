// Kernel bvh_traverse: nearest ray-triangle hit through the implicit
// Morton-ordered LBVH (vri_tpu_torch/ops/bvh.py).
//
// Replaces vri_tpu/ops/bvh_kernel.py:_traverse_kernel (K8), and is also
// the card's form of the XLA traversal vri_tpu/ops/bvh.py:traverse.  K8
// is a lock-step packet walk: a 1024-ray block shares one SMEM stack and
// descends a node when ANY lane hits it, so the block pays for the union
// of its rays' walks, cut at max_nodes pops.  A GPU gives every thread
// its own control flow, so here a lane walks one ray at a time with its
// own stack.  A per-ray walk pops each node at most once, so nothing
// needs cutting and max_nodes has no counterpart.
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
// L2.  The stack (kMaxDepth 8-byte entries of node and t_near) lives in
// local memory, cached in L1.
//
// What bounds it on the H100.  Each ray reads 28 bytes and writes 16
// (~95 MB at 1080p, ~0.03 ms at 3.35 TB/s); the FP32 work is ~25
// operations a node pop and ~54 a triangle test, ~8,200 a kitchen camera
// ray (99.5 pops, 106 tests), 0.25 ms at 67 TFLOP/s.  A warp issues the
// instructions of every path one of its lanes takes: where some lanes pop
// a leaf (four triangle tests) and others an internal node, it runs both,
// and it runs until its longest walk ends.  The walk's loads are
// dependent, but measured on the card that divergence cost more than
// the loads (PERF.md):
//
// * Leaf rounds.  A lane whose pop yields a leaf holds it and waits; the
//   warp pops internal nodes until every lane holds a leaf or has ended
//   its walk, then tests all held leaves at once.  Each lane's own
//   sequence of pops is unchanged, so no bit changes.
// * Persistent warps: as many kBlock-thread blocks as fit the card at
//   once; lane i starts on ray i, and a warp whose lanes have all ended
//   writes their rays and takes the next ray indices from a global
//   counter with one atomicAdd (ballot of the lanes that need a ray, each
//   lane's offset its rank among them): kernel M's service point
//   (march_rays.cu).  Refilling lanes one by one broke the warps'
//   pixel-order coherence and lost on camera rays; a whole warp refilled
//   at once keeps it and trims the tail.
// * One slab test a node.  A child's slab test runs when its parent is
//   popped; the stack keeps (node, t_near), and a pop tests only t_near
//   < best t.  That is exactly the pop's full slab test: its other terms
//   (a non-empty box, tmax >= max(tmin, 0)) depend only on the ray and
//   the node and passed at push time, and best t only falls.  The root
//   keeps its full test (its t_near is NaN where that fails, and NaN <
//   best t is false).  A failed pop still counts as a pop, so the visit
//   counts stay the plain version's.  The near child of an internal pop,
//   which the next pop takes, stays in registers.
//
// Measured and not kept (PERF.md): one ray a thread; the walk without
// leaf rounds; the first levels of the tree staged in shared memory
// (1,023 nodes, 32 KB a block: slower, the L1 left to the stack shrank);
// lanes refilled one by one every 1 to 32 pops, or once 1 to 24 lanes of
// a warp are done (faster on incoherent rays, slower on camera rays);
// 128-thread blocks.

#include <cuda_runtime.h>

namespace {

// a walk uses at most log2(L) + 2 entries (ops/bvh.py:MAX_STACK_DEPTH)
constexpr int kMaxDepth = 64;
constexpr int kBlock = 256;
constexpr float kInf = 3.0e38f;
constexpr float kEps = 1.0e-9f;
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// One lane's walk, in registers: its ray, best hit, visit counts and
// stack pointer.  The stack, indexed at run time, lives in local memory
// apart from it: inside this struct it would take the struct there.
struct Walk {
  Ray r;
  float best_t, best_u, best_v;
  int best_slot, pops, tests, sp;
  int next;      // the node the next pop takes ahead of the stack, or -1
  float next_t;  // its t_near
};

// A stack entry: node, bits of its t_near.
using Entry = int2;

struct Tree {
  const float4* nodes;  // 2 float4 a node
  const float4* tris;   // 3 float4 a triangle slot
  int first_leaf, leaf_size;
};

__device__ __forceinline__ float inv_dir(float d) {
  const float tiny = d < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(d) < 1e-12f ? tiny : d);
}

// Slab test of node `node` against t_best: returns the hit flag (false
// for an empty box, lo.x > hi.x) and writes t_near (the max of the
// per-axis entries).
__device__ __forceinline__ bool slab(const Tree& k, int node, const Ray& r,
                                     float t_best, float* t_near) {
  const float4 a = __ldg(k.nodes + 2 * node);
  const float4 b = __ldg(k.nodes + 2 * node + 1);
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

__device__ __forceinline__ void push(Walk& w, Entry* stack, int node,
                                     float t_near) {
  stack[min(w.sp++, kMaxDepth - 1)] = make_int2(node, __float_as_int(t_near));
}

// Pushes the node that the next pop takes, in registers: the walk is
// the one that pushing and popping it would give, since a walk never
// fills the stack (it holds at most log2(L) + 2 entries) and so never
// overwrites its top entry.
__device__ __forceinline__ void push_next(Walk& w, int node, float t_near) {
  w.next = node;
  w.next_t = t_near;
}

// Starts lane walk w on ray i: the root's full slab test is its push.
__device__ __forceinline__ void start(Walk& w, const Tree& k, int i,
                                      const float* __restrict__ origins,
                                      const float* __restrict__ dirs,
                                      const float* __restrict__ t_max) {
  Ray& r = w.r;
  r.ox = origins[3 * i];
  r.oy = origins[3 * i + 1];
  r.oz = origins[3 * i + 2];
  r.dx = dirs[3 * i];
  r.dy = dirs[3 * i + 1];
  r.dz = dirs[3 * i + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  w.best_t = t_max[i];
  w.best_slot = -1;
  w.best_u = 0.0f;
  w.best_v = 0.0f;
  w.pops = 0;
  w.tests = 0;
  w.sp = 0;
  w.next = -1;
  float t0;
  const bool hit = slab(k, 0, r, w.best_t, &t0);
  push_next(w, 0, hit ? t0 : __int_as_float(0x7fffffff));
}

// Whether walk w has a node left to pop.
__device__ __forceinline__ bool walking(const Walk& w) {
  return w.sp > 0 || w.next >= 0;
}

// Pops walk w's next node (walking(w)) and applies the pop's test:
// returns the node, or -1 where t_near is not below the best t.
__device__ __forceinline__ int take(Walk& w, Entry* stack) {
  int node;
  float t_near;
  if (w.next >= 0) {
    node = w.next;
    t_near = w.next_t;
    w.next = -1;
  } else {
    const Entry e = stack[min(w.sp - 1, kMaxDepth - 1)];
    --w.sp;
    node = e.x;
    t_near = __int_as_float(e.y);
  }
  ++w.pops;
  return t_near < w.best_t ? node : -1;
}

// Moller-Trumbore on the K slots of leaf `node`.
__device__ __forceinline__ void leaf(Walk& w, const Tree& k, int node) {
  const Ray& r = w.r;
  const int slot0 = (node - k.first_leaf) * k.leaf_size;
  float tk = kInf, uk = 0.0f, vk = 0.0f;
  int kk = 0;
  for (int j = 0; j < k.leaf_size; ++j) {
    const float4* row = k.tris + 3 * (slot0 + j);
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
                     t > 1e-4f && t < w.best_t && c.z > 0.5f;
    const float tt = hit ? t : kInf;
    if (j == 0 || tt < tk) {
      tk = tt;
      kk = j;
      uk = u;
      vk = v;
    }
  }
  w.tests += k.leaf_size;
  if (tk < w.best_t) {
    w.best_t = tk;
    w.best_slot = slot0 + kk;
    w.best_u = uk;
    w.best_v = vk;
  }
}

// Slab tests of internal node `node`'s children; pushes the hit ones,
// the far one first.
__device__ __forceinline__ void internal(Walk& w, Entry* stack,
                                         const Tree& k, int node) {
  const Ray& r = w.r;
  const int c0 = 2 * node + 1, c1 = 2 * node + 2;
  float t0, t1;
  const bool h0 = slab(k, c0, r, w.best_t, &t0);
  const bool h1 = slab(k, c1, r, w.best_t, &t1);
  const bool swap = t1 < t0;
  if (swap ? h0 : h1) push(w, stack, swap ? c0 : c1, swap ? t0 : t1);
  if (swap ? h1 : h0) push_next(w, swap ? c1 : c0, swap ? t1 : t0);
}

__global__ void __launch_bounds__(kBlock)
    bvh_traverse_kernel(const float* __restrict__ origins,
                        const float* __restrict__ dirs,
                        const float* __restrict__ t_max, int n,
                        const float4* __restrict__ nodes,
                        const float4* __restrict__ tris, int num_leaves,
                        int leaf_size, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ visits,
                        int* __restrict__ counter) {
  const Tree k{nodes, tris, num_leaves - 1, leaf_size};

  const int lanes = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < n;
  Walk w;
  Entry stack[kMaxDepth];
  w.sp = 0;
  w.next = -1;
  if (live) start(w, k, i, origins, dirs, t_max);
  while (true) {
    // service point: finished lanes write their ray and take the next
    const bool fin = live && !walking(w);
    if (fin) {
      t_out[i] = w.best_t;
      slot_out[i] = w.best_slot;
      u_out[i] = w.best_u;
      v_out[i] = w.best_v;
      if (visits != nullptr) {
        visits[2 * i] = w.pops;
        visits[2 * i + 1] = w.tests;
      }
    }
    const unsigned need = __ballot_sync(kFull, fin);
    if (need) {
      const int leader = __ffs(need) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counter, __popc(need));
      base = __shfl_sync(kFull, base, leader);
      if (fin) {
        i = lanes + base + __popc(need & below);
        live = i < n;
        if (live) start(w, k, i, origins, dirs, t_max);
      }
    }
    if (!__any_sync(kFull, live)) break;
    // leaf rounds until every lane's walk has ended
    while (true) {
      // lanes pop until they hold a leaf or their walk ends
      int held = -1;
      while (true) {
        const bool busy = live && held < 0 && walking(w);
        if (!__any_sync(kFull, busy)) break;
        if (busy) {
          const int node = take(w, stack);
          if (node >= k.first_leaf) {
            held = node;
          } else if (node >= 0) {
            internal(w, stack, k, node);
          }
        }
      }
      if (!__any_sync(kFull, held >= 0)) break;  // every lane needs a ray
      if (held >= 0) leaf(w, k, held);
    }
  }
}

// Blocks of a launch over n rays: as many as fit the card at once (blocks
// per SM at full occupancy times the SM count), or fewer when n rays need
// fewer.
cudaError_t launch_blocks(int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bvh_traverse_kernel, kBlock, 0);
  const int fit = (per_sm > 1 ? per_sm : 1) * sms;
  const int need = (n + kBlock - 1) / kBlock;
  *blocks = fit < need ? fit : need;
  return e;
}

}  // namespace

// Lanes (threads) of a launch over n rays, or -1 when the query fails.
extern "C" int vri_bvh_lanes(int n) {
  int blocks = 0;
  return launch_blocks(n, &blocks) == cudaSuccess
             ? blocks * kBlock
             : -1;
}

// ``counter`` is one int32 on the card, zero at launch.
extern "C" int vri_bvh_traverse(const float* origins, const float* dirs,
                                const float* t_max, int n, const float* nodes,
                                const float* tris, int num_leaves,
                                int leaf_size, float* t_out, int* slot_out,
                                float* u_out, float* v_out, int* visits,
                                int* counter, void* stream) {
  if (n > 0) {
    int blocks = 0;
    const cudaError_t e = launch_blocks(n, &blocks);
    if (e != cudaSuccess) return (int)e;
    bvh_traverse_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        origins, dirs, t_max, n, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(tris), num_leaves, leaf_size,
        t_out, slot_out, u_out, v_out, visits, counter);
  }
  return (int)cudaGetLastError();
}
