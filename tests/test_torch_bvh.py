"""The port's LBVH (``vri_tpu_torch/ops/bvh.py``, ``bvh_kernel.py``,
``trace.py``) against ``vri_tpu.ops.{bvh,bvh_kernel,trace}`` on the CPU.

Both sides get the same world-space vertices (the JAX package's
``bake_world``, carried across as numpy) and the same rays (camera rays
of the JAX ``raygen`` or rays drawn from a numpy seed).  Tolerances, and
why:

* Morton codes, ``_expand_bits_10`` and every ``build_bvh`` field
  bit-equal: integer arithmetic, min / max and a stable sort.
* ``traverse`` (the kernel's plain version): ``tri`` equal except on
  exact t ties (two triangles of a shared edge hit at the same t; the
  first minimum in slot order then depends on ulps), counted and printed;
  ``t`` within rtol 1e-6 and u, v within 1e-5 where ``tri`` agrees.
  XLA:CPU contracts the Möller–Trumbore products and sums into fused
  multiply-adds, the port rounds each operation (as its CUDA kernel,
  built with -fmad=false, does); ``test_traverse_bit_equal_without_
  contraction`` proves that this is the only difference: with an XLA:CPU
  limited to AVX (no FMA) t, tri, u and v are bit-equal on every ray.
* ``trace_packet`` against K8 (``_traverse_kernel``) interpreted, at
  ``tests/test_bvh_kernel.py``'s tolerances: hit flags agree on > 99.9%
  of rays, t within 1e-4 where both hit, slots equal on > 95% of the
  depth-tied hits.  K8 clamps det at 1e-12 and pushes children
  unordered, so it may pick another triangle on a tie.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from vri_tpu.config import RenderConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.ops import bvh as jbvh  # noqa: E402
from vri_tpu.ops import bvh_kernel as jkernel  # noqa: E402
from vri_tpu.ops import intersect as jint  # noqa: E402
from vri_tpu.ops import raygen as jray  # noqa: E402
from vri_tpu.ops import trace as jtrace  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch import _native  # noqa: E402
from vri_tpu_torch.ops import bvh as tbvh  # noqa: E402
from vri_tpu_torch.ops import bvh_kernel as tkernel  # noqa: E402
from vri_tpu_torch.ops import intersect as tint  # noqa: E402
from vri_tpu_torch.ops import trace as ttrace  # noqa: E402
from vri_tpu_torch.registry import scene_from_numpy  # noqa: E402

STAGES = {"cornell": scenes.cornell_box,
          "kitchen32": lambda: scenes.kitchen_stress(num_objects=32)}
#: (stage, rays): camera rays at 32x32, or 512 random rays in [-2, 2]^3
CASES = [("cornell", "camera"), ("cornell", "random"),
         ("kitchen32", "camera")]
BUILD_FIELDS = ("order", "node_lo", "node_hi", "v0", "e1", "e2",
                "slot_valid")


def _inputs(stage: str, rays: str, h: int = 32, w: int = 32):
    """The JAX scene, its world vertices and the rays (camera rays at
    h x w, or 512 random ones), as numpy."""
    d = RenderDelegate(RenderConfig(width=32, height=32))
    d.populate(STAGES[stage]())
    s = d.sync()
    world = np.asarray(jbake_world(s))
    if rays == "camera":
        cam = d.camera
        o, dirs = jray.camera_rays(jnp.asarray(cam.inv_view_proj),
                                   jnp.asarray(cam.eye), h, w)
        o, dirs = np.asarray(o).reshape(-1, 3), np.asarray(dirs).reshape(-1, 3)
    else:
        rng = np.random.default_rng(0)
        o = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
        dirs = rng.normal(size=(512, 3))
        dirs = (dirs / np.linalg.norm(dirs, axis=-1,
                                      keepdims=True)).astype(np.float32)
    return s, world, o, dirs


def _builds(s, world):
    jb = jbvh.build_bvh(jnp.asarray(world), s.tri_vertices, s.num_faces)
    tb = tbvh.build_bvh(torch.as_tensor(world.copy()),
                        torch.as_tensor(np.array(s.tri_vertices)),
                        torch.as_tensor(np.array(s.num_faces)))
    return jb, tb


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def case(request):
    s, world, o, d = _inputs(*request.param)
    jb, tb = _builds(s, world)
    return s, world, o, d, jb, tb


def test_expand_bits_and_morton_bit_equal(monkeypatch):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    v[:3] = (0, 1, 0b1111111111)
    np.testing.assert_array_equal(
        tbvh._expand_bits_10(torch.as_tensor(v.astype(np.int64))).numpy(),
        np.asarray(jbvh._expand_bits_10(jnp.asarray(v))).astype(np.int64))
    pts = rng.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    pts[:4] = ((0, 0, 0), (1, 1, 1), (0.01, 0, 0), (1023 / 1024, 0.5, 1))
    want = np.asarray(jbvh.morton3d(jnp.asarray(pts)))
    np.testing.assert_array_equal(
        tbvh.morton3d(torch.as_tensor(pts)).numpy(), want.astype(np.int64))
    # the host library's copy (native and its numpy fallback)
    np.testing.assert_array_equal(_native.morton3d(pts), want)
    monkeypatch.setattr(_native, "_load", lambda: None)
    np.testing.assert_array_equal(_native.morton3d(pts), want)


@pytest.mark.parametrize("stage", list(STAGES))
def test_build_bvh_bit_equal(stage):
    s, world, _, _ = _inputs(stage, "camera")
    jb, tb = _builds(s, world)
    assert (tb.leaf_size, tb.num_leaves) == (jb.leaf_size, jb.num_leaves)
    for name in BUILD_FIELDS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _assert_matches(ref, got):
    """tri equal except on counted exact-t ties; t rtol 1e-6; u, v 1e-5."""
    a_tri, b_tri = np.asarray(ref.tri), got.tri.numpy()
    a_t, b_t = np.asarray(ref.t), got.t.numpy()
    np.testing.assert_array_equal(b_tri >= 0, a_tri >= 0)
    np.testing.assert_allclose(b_t, a_t, rtol=1e-6)
    same = a_tri == b_tri
    print(f"tri differs on {int((~same).sum())} of {same.size} rays (ties), "
          f"t not bit-equal on {int((a_t != b_t).sum())}")
    assert same.mean() > 0.98
    for key in ("u", "v"):
        np.testing.assert_allclose(getattr(got, key).numpy()[same],
                                   np.asarray(getattr(ref, key))[same],
                                   atol=1e-5)


def test_traverse_matches_reference(case):
    _, _, o, d, jb, tb = case
    ref = jbvh.traverse(jb, jnp.asarray(o), jnp.asarray(d))
    got = tbvh.traverse(tb, torch.as_tensor(o), torch.as_tensor(d))
    assert got.tri.dtype == torch.int32 and got.t.dtype == torch.float32
    _assert_matches(ref, got)


def test_t_max_respected():
    s, world, _, _ = _inputs("cornell", "camera")
    _, tb = _builds(s, world)
    o = torch.tensor([[0.0, 0.0, 3.6]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    rec = tbvh.traverse(tb, o, d)
    assert int(rec.tri[0]) >= 0
    rec2 = tbvh.traverse(tb, o, d, t_max=float(rec.t[0]) * 0.5)
    assert int(rec2.tri[0]) == -1


def test_per_ray_t_max_matches_reference():
    s, world, o, d = _inputs("cornell", "random")
    jb, tb = _builds(s, world)
    tm = np.random.default_rng(2).uniform(0.05, 3.0, len(o)).astype(
        np.float32)
    ref = jbvh.traverse(jb, jnp.asarray(o), jnp.asarray(d),
                        t_max=jnp.asarray(tm))
    got = tbvh.traverse(tb, torch.as_tensor(o), torch.as_tensor(d),
                        t_max=torch.as_tensor(tm))
    assert 0 < (got.tri >= 0).float().mean() < 1
    _assert_matches(ref, got)


def test_batched_matches_single():
    s, world, o, d = _inputs("cornell", "camera", 16, 24)
    _, tb = _builds(s, world)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    a = tbvh.traverse(tb, o, d)
    b = tbvh.trace_batched(tb, o, d, batch=128)
    for key in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key


def test_visits_count_the_walk(case):
    """The plain version's per-ray visit counts: at least the root pop,
    triangle tests in whole leaves, and every hit tested a triangle."""
    _, _, o, d, _, tb = case
    nodes, tris = tb.nodes, tb.tris
    n = len(o)
    t, slot, u, v, visits = tbvh.bvh_traverse(
        nodes, tris, torch.as_tensor(o), torch.as_tensor(d),
        torch.full((n,), tint.INF), num_leaves=tb.num_leaves,
        leaf_size=tb.leaf_size, visits=True)
    pops, tests = visits[:, 0], visits[:, 1]
    assert bool((pops >= 1).all()) and bool((pops <= nodes.shape[0]).all())
    assert bool((tests % tb.leaf_size == 0).all())
    assert bool((tests[slot >= 0] > 0).all())
    print(f"mean {float(pops.float().mean()):.1f} pops, "
          f"{float(tests.float().mean()):.1f} triangle tests per ray")


def _walk_t_near(nodes, tris, o, d, t_max, first_leaf, leaf_size):
    """One ray's walk as ``csrc/bvh_traverse.cu`` runs it, in numpy
    float32 (each operation rounded, in the plain version's order): the
    stack holds (node, t_near) from the parent's slab test of the child,
    and a pop tests only t_near < best t; the root's full slab test is its
    push (t_near NaN where it fails).  Returns (t, slot, u, v, pops,
    tests)."""
    f32 = np.float32
    tiny = np.where(d < 0, f32(-1e-12), f32(1e-12))
    inv = f32(1.0) / np.where(np.abs(d) < f32(1e-12), tiny, d)

    def slab(node, best):
        lo, hi = nodes[node, 0:3], nodes[node, 3:6]
        with np.errstate(over="ignore"):    # empty boxes: +-3e38 slabs
            t0, t1 = (lo - o) * inv, (hi - o) * inv
        tmin = np.minimum(t0, t1).max()
        tmax = np.maximum(t0, t1).min()
        hit = lo[0] <= hi[0] and tmax >= max(tmin, f32(0.0)) and tmin < best
        return hit, tmin

    best, slot, bu, bv = f32(t_max), -1, f32(0.0), f32(0.0)
    pops = tests = 0
    hit, tn = slab(0, best)
    stack = [(0, tn if hit else f32(np.nan))]
    while stack:
        node, tn = stack.pop()
        pops += 1
        if not tn < best:
            continue
        if node >= first_leaf:
            s0 = (node - first_leaf) * leaf_size
            row = tris[s0:s0 + leaf_size]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row[:, :9].T
            dx, dy, dz = d
            pvx, pvy, pvz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, \
                dx * e2y - dy * e2x
            det = (pvx * e1x + pvy * e1y) + pvz * e1z
            ok = np.abs(det) > f32(1e-9)
            rcp = np.where(ok, f32(1.0) / np.where(ok, det, f32(1.0)),
                           f32(0.0))
            tvx, tvy, tvz = o[0] - v0x, o[1] - v0y, o[2] - v0z
            u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * rcp
            qvx, qvy, qvz = tvy * e1z - tvz * e1y, tvz * e1x - tvx * e1z, \
                tvx * e1y - tvy * e1x
            v = ((qvx * dx + qvy * dy) + qvz * dz) * rcp
            t = ((qvx * e2x + qvy * e2y) + qvz * e2z) * rcp
            ok &= (u >= 0) & (v >= 0) & (u + v <= f32(1.0)) \
                & (t > f32(1e-4)) & (t < best) & (row[:, 10] > f32(0.5))
            t = np.where(ok, t, f32(3.0e38))
            k = int(np.argmin(t))
            tests += leaf_size
            if t[k] < best:
                best, slot, bu, bv = t[k], s0 + k, u[k], v[k]
        else:
            c0, c1 = 2 * node + 1, 2 * node + 2
            h0, t0 = slab(c0, best)
            h1, t1 = slab(c1, best)
            swap = t1 < t0
            for child, h, tc in (((c0, h0, t0), (c1, h1, t1)) if swap
                                 else ((c1, h1, t1), (c0, h0, t0))):
                if h:
                    stack.append((child, tc))
    return best, slot, bu, bv, pops, tests


@pytest.mark.parametrize("t_max", ["none", "per_ray"])
def test_t_near_stack_walk_equals_plain_version(t_max):
    """The identity the kernel relies on: a walk that keeps each child's
    t_near from its push and tests only t_near < best t at its pop gives
    the plain version's t, slot, u, v and visit counts bit for bit, on
    256 of the 48-object kitchen's camera rays and 256 random rays from
    inside its room, with and without a per-ray t_max."""
    s, world, o, d = _inputs("kitchen32", "camera")
    _, tb = _builds(s, world)
    rng = np.random.default_rng(4)
    dv = rng.normal(size=(256, 3))
    o = np.concatenate([o[::4], rng.uniform(-2, 2, (256, 3))]) \
        .astype(np.float32)
    d = np.concatenate([d[::4], dv / np.linalg.norm(dv, axis=-1,
                                                    keepdims=True)]) \
        .astype(np.float32)
    n = o.shape[0]
    tm = (np.full(n, 3.0e38, np.float32) if t_max == "none"
          else rng.uniform(0.05, 3.0, n).astype(np.float32))
    want = tbvh.bvh_traverse_reference(
        tb.nodes, tb.tris, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(tm), num_leaves=tb.num_leaves,
        leaf_size=tb.leaf_size)
    nodes, tris = tb.nodes.numpy(), tb.tris.numpy()
    got = [_walk_t_near(nodes, tris, o[i], d[i], tm[i], tb.num_leaves - 1,
                        tb.leaf_size) for i in range(n)]
    t, slot, u, v, pops, tests = (np.array(x) for x in zip(*got))
    hit = want[1].numpy() >= 0
    assert 0.1 < hit.mean() < 1.0
    np.testing.assert_array_equal(t.astype(np.float32), want[0].numpy())
    np.testing.assert_array_equal(slot.astype(np.int32), want[1].numpy())
    np.testing.assert_array_equal(u.astype(np.float32), want[2].numpy())
    np.testing.assert_array_equal(v.astype(np.float32), want[3].numpy())
    np.testing.assert_array_equal(np.stack([pops, tests], 1),
                                  want[4].numpy())
    print(f"t_max {t_max}: {hit.mean():.3f} hit, mean {pops.mean():.1f} "
          f"pops and {tests.mean():.1f} triangle tests per ray")


def test_trace_packet_matches_k8():
    """The port's trace_packet against K8 interpreted, at
    tests/test_bvh_kernel.py's tolerances."""
    s, world, o, d = _inputs("cornell", "camera")
    jb, tb = _builds(s, world)
    jt, jslot = jkernel.trace_packet(jb, jnp.asarray(o), jnp.asarray(d),
                                     interpret=True)
    tt, tslot = tkernel.trace_packet(tb, torch.as_tensor(o),
                                     torch.as_tensor(d))
    ta, tb_ = np.asarray(jt), tt.numpy()
    sa, sb = np.asarray(jslot), tslot.numpy()
    assert ((sa >= 0) == (sb >= 0)).mean() > 0.999
    hits = (sa >= 0) & (sb >= 0)
    np.testing.assert_allclose(tb_[hits], ta[hits], rtol=1e-4, atol=1e-4)
    tie = np.abs(ta - tb_) < 1e-5
    assert (sa == sb)[hits & tie].mean() > 0.95
    np.testing.assert_array_equal(tb_[sb < 0], np.float32(3.0e38))
    # the HitRecord adapter maps slots through the order, with u, v
    jr = jkernel.trace_packet_hits(jb, jnp.asarray(o), jnp.asarray(d),
                                   interpret=True)
    tr = tkernel.trace_packet_hits(tb, torch.as_tensor(o),
                                   torch.as_tensor(d))
    same = np.asarray(jr.tri) == tr.tri.numpy()
    assert same.mean() > 0.95
    full = tbvh.traverse(tb, torch.as_tensor(o), torch.as_tensor(d))
    for key in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(tr, key), getattr(full, key)), key


def test_trace_scene_and_occlusion_match_reference():
    s, world, o, d = _inputs("kitchen32", "camera")
    scene = scene_from_numpy(
        {f.name: np.asarray(getattr(s, f.name))
         for f in dataclasses.fields(s)
         if f.name != "mip_atlas" and getattr(s, f.name) is not None},
        "cpu")
    ref = jtrace.trace_scene(s, jnp.asarray(world), jnp.asarray(o),
                             jnp.asarray(d), batch=256)
    got = ttrace.trace_scene(scene, torch.as_tensor(world),
                             torch.as_tensor(o), torch.as_tensor(d),
                             batch=256)
    _assert_matches(ref, got)
    tm = np.full(len(o), 2.0, np.float32)
    np.testing.assert_array_equal(
        ttrace.occluded_scene(scene, torch.as_tensor(world),
                              torch.as_tensor(o), torch.as_tensor(d),
                              t_max=torch.as_tensor(tm)).numpy(),
        np.asarray(jtrace.occluded_scene(s, jnp.asarray(world),
                                         jnp.asarray(o), jnp.asarray(d),
                                         t_max=jnp.asarray(tm))))


def test_any_hit_brute_matches_reference():
    s, world, o, d = _inputs("cornell", "random")
    jv = jint.gather_triangles(jnp.asarray(world), s.tri_vertices)
    tv = tint.gather_triangles(torch.as_tensor(world),
                               torch.as_tensor(np.array(s.tri_vertices)))
    tm = np.random.default_rng(3).uniform(0.1, 3.0, len(o)).astype(
        np.float32)
    want = np.asarray(jint.any_hit_brute(jnp.asarray(o), jnp.asarray(d), *jv,
                                         s.num_faces, jnp.asarray(tm)))
    got = tint.any_hit_brute(torch.as_tensor(o), torch.as_tensor(d), *tv,
                             torch.as_tensor(np.array(s.num_faces)),
                             torch.as_tensor(tm)).numpy()
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got, want)


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import test_torch_bvh as T
out = {}
for stage, rays in T.CASES:
    s, world, o, d = T._inputs(stage, rays)
    jb = T.jbvh.build_bvh(jnp.asarray(world), s.tri_vertices, s.num_faces)
    rec = T.jbvh.traverse(jb, jnp.asarray(o), jnp.asarray(d))
    tag = f"{stage}-{rays}"
    out[f"{tag}/world"], out[f"{tag}/o"], out[f"{tag}/d"] = world, o, d
    out[f"{tag}/tri_vertices"] = np.asarray(s.tri_vertices)
    out[f"{tag}/num_faces"] = np.asarray(s.num_faces)
    for key in T.BUILD_FIELDS:
        out[f"{tag}/bvh/{key}"] = np.asarray(getattr(jb, key))
    for key in ("t", "tri", "u", "v"):
        out[f"{tag}/hit/{key}"] = np.asarray(getattr(rec, key))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def no_fma_reference(tmp_path_factory):
    """The JAX build and traversal by an XLA:CPU limited to AVX, which has
    no fused multiply-add, in its own interpreter (XLA reads its flags
    once)."""
    path = tmp_path_factory.mktemp("no_fma_bvh") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case_id", ["-".join(c) for c in CASES])
def test_traverse_bit_equal_without_contraction(no_fma_reference, case_id):
    """With contraction ruled out on the JAX side, the build and t, tri,
    u, v of every ray are bit-equal: the port walks the reference's exact
    per-ray order."""
    ref = {k.split("/", 1)[1]: v for k, v in no_fma_reference.items()
           if k.startswith(case_id + "/")}
    tb = tbvh.build_bvh(torch.as_tensor(ref["world"]),
                        torch.as_tensor(ref["tri_vertices"]),
                        torch.as_tensor(ref["num_faces"]))
    for key in BUILD_FIELDS:
        np.testing.assert_array_equal(getattr(tb, key).numpy(),
                                      ref[f"bvh/{key}"], err_msg=key)
    got = tbvh.traverse(tb, torch.as_tensor(ref["o"]),
                        torch.as_tensor(ref["d"]))
    for key in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      ref[f"hit/{key}"], err_msg=key)
