"""LBVH: Morton-ordered bounding volume hierarchy (counterpart of
``vri_tpu/ops/bvh.py``).

* 30-bit Morton codes over triangle centroids;
* triangles sorted by code (a stable sort: equal codes are common on
  tiled scenes and keep their index order, as ``jnp.argsort`` does),
  grouped into fixed-size leaves;
* an implicit complete binary tree over the sorted order (heap layout,
  node 0 = root, children 2i+1 / 2i+2, leaves are contiguous ranges), so
  the build is log2(L) levels of pairwise AABB unions and the traversal
  needs no child pointers.

Traversal is a nearest-hit walk per ray with its own stack: pop a node,
slab-test it against the current best t, intersect a leaf's triangles
(Möller–Trumbore, first minimum over its slots) or test an internal
node's children and push the far one first.  One deliberate difference
from the reference's walk, which changes no result: a node whose box is
empty (the padded leaves past ``num_faces`` and their ancestors, lo =
3e38 > hi = -3e38) is never entered.  Its inverted slabs pass the
reference's slab test for every ray, so the reference walks each empty
subtree to its leaves and finds nothing there: on the 49k kitchen, whose
pool of 65,536 slots holds 2,024 empty leaves, that was 4,041 of the
4,140.5 nodes and 16,192 of the 16,298 triangle tests of a mean 1080p
camera ray (an H100 run of the kernel with ``visits=True``).
``bvh_traverse`` is the walk's kernel wrapper: it launches
``csrc/bvh_traverse.cu`` (a lane walks one ray at a time; persistent
warps take the next 32 rays from a counter when all their lanes are
done; a warp tests the leaves its lanes reach in rounds; a stack of
(node, t_near), so a pop tests only t_near against the best t) for CUDA
tensors and runs ``bvh_traverse_reference``,
the plain PyTorch version with the same operation order, for CPU
tensors.  Both read
the node and triangle tables that ``build_bvh`` packs once in the
kernel's layout (see :class:`BVH`).
"""

from __future__ import annotations

import dataclasses

import torch

from vri_tpu_torch import _cuda
from vri_tpu_torch.ops.intersect import EPS, INF, HitRecord

NEG_INF = -3.0e38
#: entries of a ray's stack (``kMaxDepth`` in the kernel); a walk uses at
#: most log2(L) + 2, and a push past the top overwrites the top entry
MAX_STACK_DEPTH = 64
# columns of the packed tables (see :class:`BVH`)
NODE_LO, NODE_HI = slice(0, 3), slice(3, 6)
TRI_EDGES, TRI_VALID = slice(0, 9), 10


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------

def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zeros between each bit.
    uint32 arithmetic carried in int64: every mask lies in the low 32 bits,
    so masking after each product is the product modulo 2^32."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(points01: torch.Tensor) -> torch.Tensor:
    """(N, 3) points in [0, 1] -> (N,) 30-bit Morton codes (int64)."""
    q = torch.clamp(points01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (_expand_bits_10(q[:, 0]) << 2 | _expand_bits_10(q[:, 1]) << 1
            | _expand_bits_10(q[:, 2]))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BVH:
    """The LBVH in the kernel's layout: nodes (2L-1, 8) f32 rows
    [lo3 | hi3 | pad2] in heap order and tris (Fp, 12) f32 rows
    [v0 | e1 | e2 | slot | valid | pad] in Morton order -- 32- and 48-byte
    rows, which the kernel reads as 16-byte vectors.  The reference's
    fields (``node_lo`` ... ``slot_valid``) are views of them."""
    order: torch.Tensor      # (Fp,) i32 — triangle ids sorted by Morton code
    nodes: torch.Tensor      # (2L-1, 8) f32
    tris: torch.Tensor       # (Fp, 12) f32
    leaf_size: int = 8
    num_leaves: int = 1

    @property
    def node_lo(self) -> torch.Tensor:
        return self.nodes[:, NODE_LO]

    @property
    def node_hi(self) -> torch.Tensor:
        return self.nodes[:, NODE_HI]

    @property
    def v0(self) -> torch.Tensor:
        return self.tris[:, 0:3]

    @property
    def e1(self) -> torch.Tensor:
        return self.tris[:, 3:6]

    @property
    def e2(self) -> torch.Tensor:
        return self.tris[:, 6:9]

    @property
    def slot_valid(self) -> torch.Tensor:
        return self.tris[:, TRI_VALID] > 0.5


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def build_bvh(world_verts: torch.Tensor, tri_vertices: torch.Tensor,
              num_faces, leaf_size: int = 8) -> BVH:
    """Build the Morton-ordered implicit BVH; shapes depend only on the
    padded triangle count."""
    dev = world_verts.device
    F = tri_vertices.shape[0]
    p = world_verts[tri_vertices.long()]                # (F, 3, 3)
    valid = torch.arange(F, device=dev) < num_faces
    pmin, pmax = p.min(dim=1).values, p.max(dim=1).values

    lo = torch.where(valid[:, None], pmin, INF)
    hi = torch.where(valid[:, None], pmax, NEG_INF)
    centroid = (pmin + pmax) * 0.5

    scene_lo = lo.min(dim=0).values
    scene_hi = hi.max(dim=0).values
    extent = torch.clamp(scene_hi - scene_lo, min=1e-8)
    codes = morton3d((centroid - scene_lo) / extent)
    # invalid triangles sort to the end
    codes = torch.where(valid, codes, 0xFFFFFFFF)
    order = torch.argsort(codes, stable=True).to(torch.int32)

    L = _next_pow2(max((F + leaf_size - 1) // leaf_size, 1))
    Fp = L * leaf_size
    pad = Fp - F
    order_p = torch.cat([order, torch.zeros((pad,), dtype=torch.int32,
                                            device=dev)])
    slot_valid = torch.cat([valid[order.long()],
                            torch.zeros((pad,), dtype=torch.bool,
                                        device=dev)])

    tri_p = p[order_p.long()]                           # (Fp, 3, 3)
    v0 = tri_p[:, 0]
    e1 = tri_p[:, 1] - v0
    e2 = tri_p[:, 2] - v0

    slot_lo = torch.where(slot_valid[:, None], tri_p.min(dim=1).values, INF)
    slot_hi = torch.where(slot_valid[:, None], tri_p.max(dim=1).values,
                          NEG_INF)
    los = [slot_lo.reshape(L, leaf_size, 3).min(dim=1).values]
    his = [slot_hi.reshape(L, leaf_size, 3).max(dim=1).values]
    # heap layout: levels from the leaves up
    while los[-1].shape[0] > 1:
        los.append(torch.minimum(los[-1][0::2], los[-1][1::2]))
        his.append(torch.maximum(his[-1][0::2], his[-1][1::2]))
    f32 = dict(dtype=torch.float32, device=dev)
    nodes = torch.cat([torch.cat(los[::-1]), torch.cat(his[::-1]),
                       torch.zeros((2 * L - 1, 2), **f32)], dim=1)
    tris = torch.cat([v0, e1, e2, torch.arange(Fp, **f32)[:, None],
                      slot_valid.to(torch.float32)[:, None],
                      torch.zeros((Fp, 1), **f32)], dim=1)
    return BVH(order=order_p, nodes=nodes.contiguous(),
               tris=tris.contiguous(), leaf_size=leaf_size, num_leaves=L)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _ray_aabb(o, inv_d, lo, hi, t_best):
    """Slab test; returns (hits, t_near)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = torch.minimum(t0, t1).max(dim=-1).values
    tmax = torch.maximum(t0, t1).min(dim=-1).values
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < t_best)
    return hit, tmin


def _moller_trumbore(o, d, tri, t_max):
    """Möller–Trumbore in component form, each product and sum rounded on
    its own in the order of ``intersect.moller_trumbore`` (``jnp.cross``,
    then sums over x, y, z from the left), which the kernel repeats.
    o, d: (N, 1, 3); tri: (N, K, 12) rows of ``BVH.tris``; t_max (N, 1).
    Returns t, u, v, hit, each (N, K)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[..., TRI_EDGES] \
        .unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = (pvx * e1x + pvy * e1y) + pvz * e1z
    ok = torch.abs(det) > EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = ((qvx * dx + qvy * dy) + qvz * dz) * inv
    t = ((qvx * e2x + qvy * e2y) + qvz * e2z) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4) \
        & (t < t_max)
    return t, u, v, hit


def _inv_dir(dirs):
    tiny = torch.where(dirs < 0, -1e-12, 1e-12).to(dirs.dtype)
    return 1.0 / torch.where(torch.abs(dirs) < 1e-12, tiny, dirs)


def bvh_traverse_reference(nodes, tris, origins, dirs, t_max, *,
                           num_leaves: int, leaf_size: int):
    """Plain PyTorch version of kernel ``bvh_traverse``: every ray walks
    one node per iteration of a loop over all rays, with per-ray stacks
    and activity masks; each ray's walk is exactly the kernel's.

    nodes (2L-1, 8) and tris (Fp, 12) as :class:`BVH` holds them; origins, dirs (N, 3); t_max (N,).  Returns (t f32, slot i32, u,
    v f32, visits (N, 2) i32 = node pops and triangle tests per ray); a
    miss has slot -1, t = t_max and u = v = 0."""
    n = origins.shape[0]
    dev = origins.device
    i32 = torch.int32
    first_leaf = num_leaves - 1
    last_node = nodes.shape[0] - 1
    K = leaf_size
    inv_d = _inv_dir(dirs)
    o1, d1 = origins[:, None, :], dirs[:, None, :]
    kk = torch.arange(K, device=dev)
    rows = torch.arange(n, device=dev)

    # empty boxes (lo > hi) are never entered (see the module docstring)
    nonempty = nodes[:, NODE_LO][:, 0] <= nodes[:, NODE_HI][:, 0]
    depth = MAX_STACK_DEPTH
    stack = torch.zeros((n, depth), dtype=i32, device=dev)
    sp = torch.ones((n,), dtype=i32, device=dev)          # root pushed
    best_t = t_max.clone()
    best_slot = torch.full((n,), -1, dtype=i32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    visits = torch.zeros((n, 2), dtype=i32, device=dev)

    while bool((sp > 0).any()):
        active = sp > 0
        top = torch.clamp(sp - 1, 0, depth - 1)
        node = stack[rows, top.long()]
        sp = torch.where(active, sp - 1, sp)
        nrow = nodes[node.long()]
        hit_node, _ = _ray_aabb(origins, inv_d, nrow[:, NODE_LO],
                                nrow[:, NODE_HI], best_t)
        hit_node = hit_node & active & nonempty[node.long()]
        is_leaf = node >= first_leaf

        # --- leaf: intersect its K triangle slots ------------------------
        leaf_hit = hit_node & is_leaf
        slots = (torch.clamp(node - first_leaf, min=0).long() * K)[:, None] \
            + kk[None, :]                                          # (N, K)
        trow = tris[slots]
        t, u, v, hit_tri = _moller_trumbore(o1, d1, trow, best_t[:, None])
        hit_tri = hit_tri & (trow[..., TRI_VALID] > 0.5) \
            & leaf_hit[:, None]
        t = torch.where(hit_tri, t, INF)
        k = torch.argmin(t, dim=-1)
        tk = t[rows, k]
        # only a popped leaf may improve the hit (a leaf without a hit has
        # tk = INF, which never beats a t_max <= INF)
        closer = leaf_hit & (tk < best_t)
        best_t = torch.where(closer, tk, best_t)
        best_slot = torch.where(closer, slots[rows, k].to(i32), best_slot)
        best_u = torch.where(closer, u[rows, k], best_u)
        best_v = torch.where(closer, v[rows, k], best_v)

        # --- internal: test both children, push the far one first --------
        push = hit_node & ~is_leaf
        c0 = 2 * node + 1
        c1 = 2 * node + 2
        i0 = torch.clamp(c0, max=last_node).long()
        i1 = torch.clamp(c1, max=last_node).long()
        r0, r1 = nodes[i0], nodes[i1]
        h0, tn0 = _ray_aabb(origins, inv_d, r0[:, NODE_LO], r0[:, NODE_HI],
                            best_t)
        h1, tn1 = _ray_aabb(origins, inv_d, r1[:, NODE_LO], r1[:, NODE_HI],
                            best_t)
        h0, h1 = h0 & push & nonempty[i0], h1 & push & nonempty[i1]
        swap = tn1 < tn0
        first = torch.where(swap, c1, c0)
        fh = torch.where(swap, h1, h0)
        second = torch.where(swap, c0, c1)
        sh = torch.where(swap, h0, h1)
        for child, h in ((second, sh), (first, fh)):
            idx = torch.clamp(sp, max=depth - 1).long()
            stack[rows, idx] = torch.where(h, child, stack[rows, idx])
            sp = torch.where(h, sp + 1, sp)
        visits[:, 0] += active.to(i32)
        visits[:, 1] += leaf_hit.to(i32) * K
    return best_t, best_slot, best_u, best_v, visits


def bvh_traverse(nodes: torch.Tensor, tris: torch.Tensor,
                 origins: torch.Tensor, dirs: torch.Tensor,
                 t_max: torch.Tensor, *, num_leaves: int, leaf_size: int,
                 visits: bool = False):
    """Kernel ``bvh_traverse`` wrapper: (t, slot, u, v), plus the (N, 2)
    per-ray node pops and triangle tests when ``visits`` (see
    :func:`bvh_traverse_reference`).  CUDA tensors launch
    ``csrc/bvh_traverse.cu``; CPU tensors run the plain version."""
    n = origins.shape[0]
    for name, x, shape in (("nodes", nodes, (2 * num_leaves - 1, 8)),
                           ("tris", tris, (num_leaves * leaf_size, 12)),
                           ("origins", origins, (n, 3)),
                           ("dirs", dirs, (n, 3)), ("t_max", t_max, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    tensors = (nodes, tris, origins, dirs, t_max)
    if all(x.device.type == "cpu" for x in tensors):
        out = bvh_traverse_reference(nodes, tris, origins, dirs, t_max,
                                     num_leaves=num_leaves,
                                     leaf_size=leaf_size)
        return out if visits else out[:4]
    if not all(x.is_cuda and x.device == origins.device for x in tensors):
        raise ValueError("bvh_traverse: inputs must all be on one CUDA "
                         "device (or all on the CPU)")
    nodes, tris, origins, dirs, t_max = (x.contiguous() for x in tensors)
    if nodes.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("bvh_traverse: the node and triangle tables must "
                         "be 16-byte aligned (the kernel reads float4 rows)")
    dev = origins.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    vis = (torch.empty((n, 2), dtype=torch.int32, device=dev) if visits
           else None)
    # the persistent lanes' next-ray counter
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    code = lib.vri_bvh_traverse(
        origins.data_ptr(), dirs.data_ptr(), t_max.data_ptr(), n,
        nodes.data_ptr(), tris.data_ptr(), num_leaves, leaf_size,
        t.data_ptr(), slot.data_ptr(), u.data_ptr(),
        v.data_ptr(), 0 if vis is None else vis.data_ptr(),
        counter.data_ptr(), _cuda.stream_ptr(origins))
    _cuda.check(code, "bvh_traverse")
    bvh_traverse.launches += 1
    return (t, slot, u, v, vis) if visits else (t, slot, u, v)


bvh_traverse.launches = 0


def persistent_lanes(n: int) -> int:
    """Lanes of a ``bvh_traverse`` launch over ``n`` rays on the current
    card: as many 256-lane blocks as fit the card at once, or fewer when
    ``n`` rays need fewer.  Every ray past them is taken by a refill."""
    lanes = _cuda.library().vri_bvh_lanes(n)
    if lanes < 0:
        raise RuntimeError("bvh_traverse: the occupancy query failed")
    return lanes


def trace_slots(bvh: BVH, origins: torch.Tensor, dirs: torch.Tensor,
                t_max=INF):
    """(t, slot, u, v) of every ray (origins, dirs (N, 3); ``t_max``
    scalar or (N,)) from one ``bvh_traverse`` call; slots index the
    Morton-sorted order, a miss has slot -1 and t = t_max."""
    n = origins.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=origins.device).expand(n).contiguous()
    return bvh_traverse(
        bvh.nodes, bvh.tris, origins.float().contiguous(),
        dirs.float().contiguous(), t_max, num_leaves=bvh.num_leaves,
        leaf_size=bvh.leaf_size)


def traverse(bvh: BVH, origins: torch.Tensor, dirs: torch.Tensor,
             t_max=INF) -> HitRecord:
    """Nearest-hit traversal for a batch of rays; returns a HitRecord with
    global triangle ids.  One ``bvh_traverse`` call: the kernel on CUDA
    tensors, the plain version on CPU ones."""
    t, slot, u, v = trace_slots(bvh, origins, dirs, t_max)
    tri = torch.where(slot >= 0, bvh.order[torch.clamp(slot, min=0).long()],
                      -1)
    return HitRecord(t=t, tri=tri, u=u, v=v)


def trace_batched(bvh: BVH, origins: torch.Tensor, dirs: torch.Tensor,
                  t_max=INF, batch: int = 1 << 16) -> HitRecord:
    """Traverse in bounded ray batches.  Only the plain version is batched
    (its stacks take batch * depth entries); on the card the kernel's
    stack is per thread, so all rays go in one launch."""
    n = origins.shape[0]
    if origins.is_cuda or n <= batch:
        return traverse(bvh, origins, dirs, t_max)
    tm = torch.as_tensor(t_max, dtype=torch.float32,
                         device=origins.device).expand(n)
    recs = [traverse(bvh, origins[s:s + batch], dirs[s:s + batch],
                     tm[s:s + batch])
            for s in range(0, n, batch)]
    return HitRecord(**{k: torch.cat([getattr(r, k) for r in recs])
                        for k in ("t", "tri", "u", "v")})
