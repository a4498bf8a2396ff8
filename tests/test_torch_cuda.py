"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests import no JAX; ``tests/conftest.py`` does, so on a
machine without JAX run them without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Each builds the stage (or the work list, or synthetic march tables) with
the port itself, runs one kernel (raster_tiles, raster_ranged, march_rays,
bvh_traverse, and the work-list kernels template_walk, setup_walk,
grouped_step) on CUDA tensors
and its plain version on the same tensors, and requires exact equality: the kernels are built with -fmad=false and follow their plain
versions' operation order, so every output agrees bit for bit (also
raster_ranged's per-tile tested pairs and bvh_traverse's visit counts).
It also holds march_compact's three march_rays launches bit-equal to
one-phase march, the trilinear SDF loop on the card against the CPU,
the temporal frame's launches (one raster_tiles and two march_rays a
frame), the LOD-masked tiers bit-equal to each other, one bounded
update and animated frame on the card against the CPU, a band of the
kitchen through the three tiers and the temporal band frame on the card
against the CPU, the dense SDF build on the card against the CPU, and
the sharded frames over a one-rank ``nccl`` mesh bit-equal to the
single-card frames.  The sorted tier's prep kernels (raster_prep) are
held bit-equal to their plain version on the cases of
``tests/test_torch_raster_prep.py`` and on the kitchen at 1080p, with no
host sync, and the SDF emit kernel (sdf_emit) bit-equal to the plain
emit on CUDA tensors.  The bounded SDF update's device pipeline
(sdf_update) is held bit-equal to the plain update on the Cornell scenes
of ``tests/test_torch_sdf_update.py``, on a breach of each capacity and
at the animated cell's first update, with no host sync.  On a host
without a card every test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vri_tpu_torch import RenderConfig, SDFConfig, scenes  # noqa: E402
from vri_tpu_torch.ops.worklist import FULL_STAGE, WALK_KERNELS  # noqa: E402
from test_torch_raster_prep import PREP_CASES, kitchen_args  # noqa: E402

pytestmark = pytest.mark.gpu

SDF = SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                max_bricks=16384, base_voxel_size=0.075,
                truncation_voxels=3.0, max_triangles_per_brick=16,
                approx_occlusion=True)


@pytest.fixture(scope="module")
def frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    r = Renderer(RenderConfig(width=256, height=192, sdf=SDF), device="cuda")
    r.load_stage(scenes.kitchen_stress(num_objects=24, tess=2))
    cam = r.camera
    fp = frame_mod.FrameParams.from_camera(cam, 192, device="cuda")
    return r, fp, bake_world(r.scene)


def test_raster_tiles_matches_plain_version(frame):
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    prep = rasterize.prepare_sorted(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=192, width=256, cull_sign=frame_mod._cull_sign(r.scene))
    args = (prep["coef"], prep["lists"], prep["starts"], prep["counts"])
    kw = dict(num_tx=prep["num_tx"], cap=prep["cap"])
    got = rasterize.raster_tiles(*args, **kw)
    torch.cuda.synchronize()
    want = rasterize.raster_tiles_reference(*args, **kw)
    assert (got[1] >= 0).float().mean() > 0.5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_march_rays_matches_plain_version(frame):
    from vri_tpu_torch.ops import march_kernel

    r, _, _ = frame
    cas = r.ensure_cascades()
    rng = np.random.default_rng(0)
    m = 50000
    o = torch.as_tensor(rng.uniform(-3.5, 3.5, (m, 3)).astype(np.float32),
                        device="cuda")
    o[:, 1] = o[:, 1].abs() * 0.5
    d = torch.as_tensor(rng.normal(size=(m, 3)).astype(np.float32),
                        device="cuda")
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays = march_kernel.ray_table(cas, o, d, 10.0, SDF)
    args = (rays, march_kernel.pack_meta(cas, SDF), cas.march_coarse,
            cas.march_fine0, cas.march_fine1)
    got = march_kernel.march_rays(*args, r=64, max_steps=72)
    torch.cuda.synchronize()
    want = march_kernel.march_rays_reference(*args, r=64, max_steps=72)
    assert (got[1] >= 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_raster_ranged_matches_plain_version(frame):
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    prep = rasterize.prepare_ranged(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=192, width=256, cull_sign=frame_mod._cull_sign(r.scene))
    args = (prep["coef"], prep["order"], prep["ranges"], prep["words"])
    kw = dict(n_global=prep["n_global"], num_tx=prep["num_tx"])
    got = rasterize.raster_ranged(*args, **kw)
    torch.cuda.synchronize()
    want = rasterize.raster_ranged_reference(*args, **kw)
    assert (got[1] >= 0).float().mean() > 0.5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_tiers_bit_equal_on_card(frame):
    """The sorted, binned and ranged tiers give the same tri, t, u and v
    on the card (binned at the smallest caps scale that does not
    overflow)."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    args = (world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj)
    kw = dict(height=192, width=256, cull_sign=frame_mod._cull_sign(r.scene))
    sorted_hit, _ = rasterize.rasterize_sorted(*args, **kw)
    for scale in (1, 2, 4):
        binned_hit, _ = rasterize.rasterize_binned(*args, caps_scale=scale,
                                                   **kw)
        if int(binned_hit.overflow) == 0:
            break
    ranged_hit, _ = rasterize.rasterize(*args, **kw)
    assert int(sorted_hit.overflow) == 0 and int(binned_hit.overflow) == 0
    for hit in (binned_hit, ranged_hit):
        for key in ("tri", "t", "u", "v"):
            assert torch.equal(getattr(hit, key), getattr(sorted_hit, key))


def _synthetic_march(n_cas: int, r: int, m: int, seed: int, *,
                     tmax=None):
    """Kernel M's inputs without an SDF build: ``n_cas`` nested cascades
    of r^3 voxels around the origin (voxel size 0.05 x 2^c), coarse
    tables of random Chebyshev distances (one cell in ten on a surface,
    the rest 1-3 cells away), fine words with a quarter of their bits
    set, and ``m`` rays
    in random directions from a box inside the coarsest cascade (at most
    [-2, 2]^3), with ``tmax`` per ray or uniform in [0.1, 8]."""
    rng = np.random.default_rng(seed)
    vs = 0.05 * 2.0 ** np.arange(n_cas)
    org = -0.5 * r * vs
    meta = np.stack([vs, org, org, org]).astype(np.float32)
    cd = np.where(rng.random((n_cas, 4096)) < 0.1, 0,
                  rng.integers(1, 4, (n_cas, 4096)))
    coarse = (cd.reshape(n_cas, 512, 8)
              << (4 * np.arange(8))).sum(-1).astype(np.uint32)
    coarse = coarse.view(np.int32).reshape(n_cas * 4, 128)

    def words():
        a, b = rng.integers(0, 1 << 32, (2, n_cas * 32, 128),
                            dtype=np.uint64).astype(np.uint32)
        return (a & b).view(np.int32)

    fine0, fine1 = words(), words()
    box = min(2.0, 0.4 * r * vs[-1])
    o = rng.uniform(-box, box, (m, 3))
    d = rng.normal(size=(m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if tmax is None:
        tmax = rng.uniform(0.1, 8.0, m)
    rays = np.concatenate([o.T, d.T, np.stack([
        np.full(m, 1e-3), tmax, np.zeros(m), np.full(m, 0.02)])])
    return _cuda_tensors(rays.astype(np.float32), meta, coarse, fine0, fine1)


def _march_equal(args, r: int, max_steps: int):
    from vri_tpu_torch.ops import march_kernel

    got = march_kernel.march_rays(*args, r=r, max_steps=max_steps)
    torch.cuda.synchronize()
    want = march_kernel.march_rays_reference(*args, r=r, max_steps=max_steps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("m", [1, 31, 33, 257])
def test_march_rays_ragged_counts(m):
    """Fewer rays than a warp, a warp and one, a block and one, on six
    cascades at r = 64: bit-equal, every ray written."""
    _card()
    got = _march_equal(_synthetic_march(6, 64, m, seed=m), 64, 40)
    assert (got[2] > 0).all()


def test_march_rays_rays_that_never_start():
    """Rays with t0 >= tmax (every other one) end at once: t = t0, no hit,
    no step, inactive."""
    _card()
    m = 1000
    tmax = np.where(np.arange(m) % 2 == 0, 1e-3, 5.0)
    args = _synthetic_march(6, 64, m, seed=11, tmax=tmax)
    args[0][6, 1::4] = args[0][7, 1::4] + 1.0
    got = _march_equal(args, 64, 40)
    dead = (args[0][6] >= args[0][7])
    assert dead.sum() > m // 2
    assert (got[2][dead] == 0).all() and (got[3][dead] == 0).all()
    assert torch.equal(got[0][dead], args[0][6][dead])


@pytest.mark.parametrize("cascades", [(6, 64), (2, 32), (1, 16)])
def test_march_rays_refills_mixed_lengths(cascades):
    """More rays than the launch has lanes, very long and very short rays
    alternating in every warp, so that lanes refill many times; six
    cascades at r = 64 exercise the finest-first cascade search."""
    from vri_tpu_torch.ops import march_kernel

    _card()
    n_cas, r = cascades
    lanes = march_kernel.persistent_lanes(n_cas, 1 << 30)
    m = 2 * lanes + 77
    tmax = np.where(np.arange(m) % 2 == 0, 0.08, 12.0)
    got = _march_equal(_synthetic_march(n_cas, r, m, seed=r, tmax=tmax), r,
                       96)
    assert march_kernel.persistent_lanes(n_cas, m) == lanes < m
    it = got[2].reshape(-1)[: m - m % 32].reshape(-1, 32)
    assert (it.max(1).values > it.min(1).values).float().mean() > 0.5


def test_march_rays_one_step():
    _card()
    got = _march_equal(_synthetic_march(6, 64, 5000, seed=3), 64, 1)
    assert (got[2] <= 1).all() and got[3].any()


def test_raster_tiles_long_capped_and_empty_lists(frame):
    """Kernel R on hand-made lists: each tile's own list plus random
    slots (many lists longer than a 128-slot chunk), every seventh tile
    empty, with no cap and with cap 150 (count > cap walks cap slots)."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    prep = rasterize.prepare_sorted(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=192, width=256, cull_sign=frame_mod._cull_sign(r.scene))
    rng = np.random.default_rng(9)
    lists = prep["lists"].cpu().numpy()
    starts = prep["starts"].cpu().numpy()
    counts = prep["counts"].cpu().numpy()
    n_slots = prep["coef"].shape[0]
    own, new_counts = [], []
    for t in range(counts.shape[0]):
        extra = rng.integers(0, n_slots, rng.choice([0, 60, 250, 700]))
        ids = np.unique(np.concatenate(
            [lists[starts[t]:starts[t] + counts[t]], extra]))
        own.append(ids)
        new_counts.append(0 if t % 7 == 3 else ids.shape[0])
    sizes = np.array([x.shape[0] for x in own])
    new_starts = np.concatenate([[0], np.cumsum(sizes)])
    args = (prep["coef"],) + _cuda_tensors(
        np.concatenate(own).astype(np.int32),
        new_starts.astype(np.int32), np.array(new_counts, np.int32))
    assert max(new_counts) > 2 * 128
    for cap, covered in ((1 << 20, 0.5), (150, 0.1)):
        kw = dict(num_tx=prep["num_tx"], cap=cap)
        got = rasterize.raster_tiles(*args, **kw)
        torch.cuda.synchronize()
        want = rasterize.raster_tiles_reference(*args, **kw)
        assert (got[1] >= 0).float().mean() > covered
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_raster_tiles_binned_lists(frame):
    """Kernel R on the binned tier's lists (K5's walk)."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    prep = rasterize.prepare_binned(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=192, width=256, caps_scale=4,
        cull_sign=frame_mod._cull_sign(r.scene))
    args = (prep["coef"], prep["lists"], prep["starts"], prep["counts"])
    kw = dict(num_tx=prep["num_tx"], cap=prep["cap"])
    got = rasterize.raster_tiles(*args, **kw)
    torch.cuda.synchronize()
    want = rasterize.raster_tiles_reference(*args, **kw)
    assert (got[1] >= 0).float().mean() > 0.5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(1, 128), (16, 64), (4, 256), (32, 32),
                                   (2, 512)])
def test_raster_tiles_other_tile_shapes(frame, shape):
    """Tiles other than 8 x 128: a thread's pixels share a column when
    the tile width divides the 256-thread block (1 x 128, 16 x 64,
    4 x 256, 32 x 32), else each pixel has its own (2 x 512)."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    tile_h, tile_w = shape
    prep = rasterize.prepare_sorted(
        world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj,
        height=192, width=256, tile_h=tile_h, tile_w=tile_w,
        cull_sign=frame_mod._cull_sign(r.scene))
    args = (prep["coef"], prep["lists"], prep["starts"], prep["counts"])
    kw = dict(num_tx=prep["num_tx"], cap=prep["cap"], tile_h=tile_h,
              tile_w=tile_w)
    got = rasterize.raster_tiles(*args, **kw)
    torch.cuda.synchronize()
    want = rasterize.raster_tiles_reference(*args, **kw)
    assert (got[1] >= 0).float().mean() > 0.5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_bvh_traverse_matches_plain_version(rays):
    """Kernel ``bvh_traverse`` on the Cornell box's LBVH: camera rays, or
    random rays with per-ray t_max; t, slot, u, v and the visit counts
    bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import bvh, raygen
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    d = RenderDelegate(RenderConfig(width=128, height=96), device="cuda")
    d.populate(scenes.cornell_box())
    scene = d.sync()
    accel = bvh.build_bvh(bake_world(scene), scene.tri_vertices,
                          scene.num_faces)
    nodes, tris = accel.nodes, accel.tris
    if rays == "camera":
        fp = frame_mod.FrameParams.from_camera(d.camera, 96, device="cuda")
        o, dirs = raygen.camera_rays(fp.inv_view_proj, fp.eye, 96, 128)
        o, dirs = o.reshape(-1, 3), dirs.reshape(-1, 3)
        t_max = torch.full((o.shape[0],), 3.0e38, device="cuda")
    else:
        rng = np.random.default_rng(0)
        m = 20000
        o = torch.as_tensor(rng.uniform(-2, 2, (m, 3)).astype(np.float32),
                            device="cuda")
        dv = rng.normal(size=(m, 3))
        dirs = torch.as_tensor((dv / np.linalg.norm(dv, axis=-1,
                                                    keepdims=True)
                                ).astype(np.float32), device="cuda")
        t_max = torch.as_tensor(rng.uniform(0.05, 4.0, m).astype(np.float32),
                                device="cuda")
    args = (nodes, tris, o.contiguous(), dirs.contiguous(), t_max)
    kw = dict(num_leaves=accel.num_leaves, leaf_size=accel.leaf_size,
              visits=True)
    got = bvh.bvh_traverse(*args, **kw)
    torch.cuda.synchronize()
    want = bvh.bvh_traverse_reference(*args[:5], num_leaves=kw["num_leaves"],
                                      leaf_size=kw["leaf_size"])
    assert (got[1] >= 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ranged_equal(prep, sorted_counts=None, **kw):
    """Kernel K6 against its plain version on ``prep``'s inputs (``kw``
    overrides them): z, slot, u, v and the per-tile tested pairs
    bit-equal, the pairs equal to ``sorted_counts`` when given."""
    from vri_tpu_torch.ops import rasterize

    a = dict(coef=prep["coef"], order=prep["order"], ranges=prep["ranges"],
             words=prep["words"], n_global=prep["n_global"],
             num_tx=prep["num_tx"])
    a.update(kw)
    got = rasterize.raster_ranged(**a, pairs=True)
    torch.cuda.synchronize()
    want = rasterize.raster_ranged_reference(**a, pairs=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if sorted_counts is not None:
        assert torch.equal(got[4], sorted_counts)
    return got


def _frame_preps(frame, **kw):
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    args = (world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj)
    kw = dict(height=192, width=256, cull_sign=frame_mod._cull_sign(r.scene),
              **kw)
    return (rasterize.prepare_ranged(*args, **kw),
            rasterize.prepare_sorted(*args, **kw))


def test_raster_ranged_culled_chunks_and_empty_ranges(frame):
    """K6 with every chunk's bit set and every tile's range the whole
    local block: most live chunks lose every slot to the cull, and the
    tested pairs are still exactly the sorted lists, the output the
    ranged tier's own.  Then n_global = 3 with every local range empty:
    only the first three chunks are walked, a part of each tile's sorted
    list."""
    prep, sprep = _frame_preps(frame)
    base = _ranged_equal(prep, sprep["counts"])
    t = prep["ranges"].shape[0]
    chunks = prep["order"].shape[0] // 128
    all_bits = torch.full_like(prep["words"], -1)
    whole = torch.tensor([[prep["n_global"], chunks]], dtype=torch.int32,
                         device="cuda").expand(t, 2).contiguous()
    got = _ranged_equal(prep, sprep["counts"], words=all_bits, ranges=whole)
    assert chunks > 8 and (got[1] >= 0).float().mean() > 0.5
    for g, w in zip(got[:4], base[:4]):
        assert torch.equal(g, w)
    empty = torch.zeros_like(prep["ranges"])
    got = _ranged_equal(prep, words=all_bits, ranges=empty, n_global=3)
    assert (got[4] <= sprep["counts"]).all()
    assert (got[4] < sprep["counts"]).any() and (got[4] > 0).any()


def test_raster_ranged_corners_on_tile_borders():
    """K6 on triangles whose corners lie exactly on multiples of 128 and
    8 pixels, with slivers and zero-area slots
    (``test_torch_kernel_layouts._border_args``)."""
    from test_torch_kernel_layouts import _border_args

    from vri_tpu_torch.ops import rasterize

    _card()
    (world, tri, n, vp), kw = _border_args()
    args = (world.cuda(), tri.cuda(), n, vp.cuda())
    prep = rasterize.prepare_ranged(*args, **kw)
    sprep = rasterize.prepare_sorted(*args, **kw)
    got = _ranged_equal(prep, sprep["counts"])
    assert (got[1] >= 0).float().mean() > 0.3


@pytest.mark.parametrize("shape", [(16, 64), (2, 512)])
def test_raster_ranged_other_tile_shapes(frame, shape):
    """Tiles other than 8 x 128: 16 x 64 (a thread's pixels share a
    column) and 2 x 512 (each pixel its own)."""
    tile_h, tile_w = shape
    prep, sprep = _frame_preps(frame, tile_h=tile_h, tile_w=tile_w)
    got = _ranged_equal(prep, sprep["counts"], tile_h=tile_h, tile_w=tile_w)
    assert (got[1] >= 0).float().mean() > 0.5


@pytest.fixture(scope="module")
def kitchen_bvh(frame):
    from vri_tpu_torch.ops import bvh

    r, _, world = frame
    return bvh.build_bvh(world, r.scene.tri_vertices, r.scene.num_faces)


def _bvh_rays(m, seed, *, t_max=None, away=False):
    """``m`` rays from inside the kitchen's room in random directions
    (``away``: from far outside, pointing away from it), t_max per ray or
    uniform in [0.05, 6]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (m, 3))
    o[:, 1] = np.abs(o[:, 1])
    d = rng.normal(size=(m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if away:
        d = np.abs(d)
        o = 50.0 + o
    tm = rng.uniform(0.05, 6.0, m) if t_max is None else t_max
    return _cuda_tensors(o.astype(np.float32), d.astype(np.float32),
                         np.broadcast_to(np.float32(tm), (m,)).copy())


def _bvh_equal(accel, rays):
    from vri_tpu_torch.ops import bvh

    args = (accel.nodes, accel.tris) + tuple(rays)
    kw = dict(num_leaves=accel.num_leaves, leaf_size=accel.leaf_size)
    got = bvh.bvh_traverse(*args, visits=True, **kw)
    torch.cuda.synchronize()
    want = bvh.bvh_traverse_reference(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("m", [1, 31, 257, 1000])
def test_bvh_traverse_ragged_counts(kitchen_bvh, m):
    """One ray, fewer than a warp, a block and one, and not a multiple of
    32: bit-equal, every ray written."""
    got = _bvh_equal(kitchen_bvh, _bvh_rays(m, seed=m))
    assert (got[4][:, 0] >= 1).all()


def test_bvh_traverse_misses_and_zero_t_max(kitchen_bvh):
    """Rays that miss the whole scene (from outside, pointing away: only
    the root is popped) and rays with t_max = 0: no hit, t = t_max."""
    for away, t_max in ((True, 3.0e38), (False, 0.0)):
        rays = _bvh_rays(3000, seed=5, t_max=t_max, away=away)
        got = _bvh_equal(kitchen_bvh, rays)
        assert (got[1] == -1).all() and torch.equal(got[0], rays[2])
        if away:
            assert (got[4][:, 0] == 1).all()


def test_bvh_traverse_refills_mixed_lengths(kitchen_bvh):
    """Long walks (no t_max) and walks ended at once (t_max 1e-3)
    alternating in every warp, twice as many rays as a persistent launch
    has lanes (at most 2^20 + 77), so that persistent lanes refill many
    times."""
    from vri_tpu_torch.ops import bvh

    lanes = bvh.persistent_lanes(1 << 20)
    m = min(2 * lanes, 1 << 20) + 77
    tm = np.where(np.arange(m) % 2 == 0, 1e-3, 3.0e38)
    got = _bvh_equal(kitchen_bvh, _bvh_rays(m, seed=7, t_max=tm))
    pops = got[4][:, 0].reshape(-1)[: m - m % 32].reshape(-1, 32)
    assert (pops.max(1).values > pops.min(1).values).float().mean() > 0.5


def _cuda_tensors(*xs):
    return tuple(torch.as_tensor(np.array(x), device="cuda") for x in xs)


def _triangle_templates(rng, n_chunks, tc, rows, tiles=30):
    """Chunks of screen triangles around the first ``tiles`` tiles of the
    tools' grid (15 a row, 128 x ``rows`` pixels), integer slot ids: most
    pixels covered, many overlaps."""
    from vri_tpu_torch.ops import worklist

    n = n_chunks * tc
    t = rng.integers(0, tiles, n)
    tri = worklist.triangles_near(rng, (t % 15) * 128, (t // 15) * rows,
                                  128, rows)
    return worklist.templates_from_triangles(
        tri, rng.integers(0, 1 << 20, n), tc)


@pytest.mark.parametrize("mode", [
    ("f32", True, False, 1024, 128), ("f32", False, False, 1024, 128),
    ("bf16x2", True, False, 1024, 128), ("bf16x2", True, False, 2048, 256),
    ("bf16x2", True, False, 4096, 128), ("bf16x2", True, True, 1024, 128),
    ("bf16x2", True, True, 2048, 256), ("bf16x3", True, True, 1024, 128),
    ("k6", True, True, 1024, 128)])
@pytest.mark.parametrize("kind", ["draws", "triangles"])
def test_template_walk_matches_plain_version(mode, kind):
    """Kernel ``template_walk`` in each of the tools' modes, on the tools'
    draws and on triangle templates over 30 tiles."""
    from vri_tpu_torch.ops import worklist

    _card()
    evaluation, translate, packed, p, tc = mode
    wt, wc, fl, chunks = worklist.steps_inputs(400, tc=tc, num_tiles=30,
                                               num_chunks=64, seed=2)
    if kind == "triangles":
        chunks = _triangle_templates(np.random.default_rng(3), 64, tc,
                                     p // 128)
    args = _cuda_tensors(wt, wc, fl, chunks)
    kw = dict(num_tiles=32, p=p, evaluation=evaluation, translate=translate,
              packed=packed,
              chunks_k6=worklist.k6_operand(args[3])
              if evaluation == "k6" else None)
    got = worklist.template_walk(*args, **kw)
    torch.cuda.synchronize()
    want = worklist.template_walk_reference(*args, **kw)
    if kind == "triangles":
        assert (got[1][:30] >= 0).float().mean() > 0.5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", [0, 3])
def test_setup_walk_matches_plain_version(variant):
    from vri_tpu_torch.ops import worklist

    _card()
    args = _cuda_tensors(*worklist.pass1_inputs(nt=60, wcap=160,
                                                nchunks=100))
    got = worklist.setup_walk(*args, num_tiles=60, variant=variant)
    torch.cuda.synchronize()
    want = worklist.setup_walk_reference(*args, num_tiles=60,
                                         variant=variant)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_walks_skip_broken_runs_on_card():
    """A run that a first flag breaks before its last flag, or that never
    closes, is never written: kernels and plain versions agree."""
    from vri_tpu_torch.ops import worklist

    _card()
    wt, wc, fl, _ = worklist.steps_inputs(400, num_tiles=30, num_chunks=64,
                                          seed=6)
    chunks = _triangle_templates(np.random.default_rng(7), 64, 128, 8)
    fl = fl.copy()
    lasts = np.flatnonzero(fl & worklist.LAST)
    fl[lasts[::3]] &= ~worklist.LAST
    inner = np.flatnonzero((fl & (worklist.FIRST | worklist.LAST)) == 0)
    fl[inner[::4]] |= worklist.FIRST
    args = _cuda_tensors(wt, wc, fl, chunks)
    starts, _ = worklist.work_runs(args[2])
    assert 0 < starts.numel() < int((args[2] & worklist.FIRST).ne(0).sum())
    for packed in (False, True):
        kw = dict(num_tiles=30, evaluation="bf16x2", packed=packed)
        got = worklist.template_walk(*args, **kw)
        torch.cuda.synchronize()
        want = worklist.template_walk_reference(*args, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    swt, swc, sfl, sch = worklist.pass1_inputs(nt=60, wcap=160, nchunks=100)
    sfl = sfl.copy()
    sfl[np.flatnonzero(sfl & worklist.LAST)[::3]] &= ~worklist.LAST
    sargs = _cuda_tensors(swt, swc, sfl, sch)
    got = worklist.setup_walk(*sargs, num_tiles=60)
    torch.cuda.synchronize()
    want = worklist.setup_walk_reference(*sargs, num_tiles=60)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_timing_only_variants_launch():
    """The ladders' timing-only rungs build, launch and leave the
    unwritten rows at the miss values."""
    from vri_tpu_torch.ops import worklist

    _card()
    args = _cuda_tensors(*worklist.steps_inputs(200, num_tiles=30,
                                                num_chunks=16))
    for stage in range(5):
        z, _ = worklist.template_walk(*args, num_tiles=30,
                                      evaluation="bf16x3", packed=True,
                                      stage=stage)
        assert z.shape == (30, 1024)
    sargs = _cuda_tensors(*worklist.pass1_inputs(nt=30, wcap=80,
                                                 nchunks=64))
    for v in (1, 2):
        z, pos = worklist.setup_walk(*sargs, num_tiles=30, variant=v)
        torch.cuda.synchronize()
        assert (z == worklist.MISS_Z).all() and (pos == -1).all()


WALK_P = (128, 256, 512, 1024, 2048, 4096)


def _walk_equal(args, **kw):
    from vri_tpu_torch.ops import worklist

    got = worklist.template_walk(*args, **kw)
    torch.cuda.synchronize()
    want = worklist.template_walk_reference(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w), kw
    return got


@pytest.mark.parametrize("p", WALK_P)
@pytest.mark.parametrize("mode", [m[:2] for m in WALK_KERNELS
                                  if m[2] == FULL_STAGE])
def test_template_walk_every_mode_and_width(mode, p):
    """Kernel ``template_walk`` in every full-stage mode at P = 128 to
    4096 (one to four pixels a thread in a column, or in a row below 512)
    and TC = 128 and 256, on the tools' draws and on triangle templates,
    with the constant at the tile origin and at the template's."""
    from vri_tpu_torch.ops import worklist

    _card()
    evaluation, packed = mode
    for tc in (128, 256):
        wt, wc, fl, draws = worklist.steps_inputs(
            300, tc=tc, num_tiles=30, num_chunks=48, seed=p + tc)
        tri = _triangle_templates(np.random.default_rng(tc), 48, tc,
                                  p // 128)
        for chunks in (draws, tri):
            args = _cuda_tensors(wt, wc, fl, chunks)
            k6 = worklist.k6_operand(args[3]) if evaluation == "k6" else None
            for translate in (True, False):
                got = _walk_equal(args, num_tiles=30, p=p,
                                  evaluation=evaluation, translate=translate,
                                  packed=packed, chunks_k6=k6)
            if chunks is tri:
                assert (got[1] >= 0).float().mean() > 0.3


@pytest.mark.parametrize("tc", [128, 256])
def test_setup_walk_every_width(tc):
    """Kernel ``setup_walk`` at every P the wrapper admits with TC
    dividing it, variants 0 and 3, on the tool's draws and on covering
    triangles."""
    from vri_tpu_torch.ops import worklist

    _card()
    rng = np.random.default_rng(tc)
    for p in [128 * m for m in range(1, 9)] + [2048, 4096]:
        if p % tc:
            continue
        draws = _cuda_tensors(*worklist.pass1_inputs(
            tc=tc, nt=40, wcap=120, nchunks=80, seed=p))
        wt = draws[0].cpu().numpy()
        t = np.repeat(wt, tc)
        tri = worklist.setup_rows_from_triangles(
            worklist.triangles_near(rng, t % 15, 0.0, tc, p // tc), tc)
        covered = (draws[0], torch.arange(wt.shape[0], dtype=torch.int32,
                                          device="cuda"), draws[2],
                   torch.as_tensor(tri, device="cuda"))
        for args in (draws, covered):
            for variant in worklist.PASS1_DEFINED:
                got = worklist.setup_walk(*args, num_tiles=40, p=p,
                                          variant=variant)
                torch.cuda.synchronize()
                want = worklist.setup_walk_reference(*args, num_tiles=40,
                                                     p=p, variant=variant)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (p, variant)
        assert (got[1] >= 0).float().mean() > 0.3


@pytest.mark.parametrize("p", [128, 512, 4096])
def test_walks_skip_broken_runs_at_other_widths(p):
    """Broken runs (a first flag before the last, a run never closed) at
    P of one, four and 32 rows: both walks leave them unwritten, as
    their plain versions do."""
    from vri_tpu_torch.ops import worklist

    _card()
    wt, wc, fl, _ = worklist.steps_inputs(300, num_tiles=30, num_chunks=48,
                                          seed=p)
    chunks = _triangle_templates(np.random.default_rng(p), 48, 128,
                                 p // 128)
    fl = fl.copy()
    fl[np.flatnonzero(fl & worklist.LAST)[::3]] &= ~worklist.LAST
    inner = np.flatnonzero((fl & (worklist.FIRST | worklist.LAST)) == 0)
    fl[inner[::4]] |= worklist.FIRST
    args = _cuda_tensors(wt, wc, fl, chunks)
    for evaluation, packed in (("f32", False), ("bf16x2", True),
                               ("bf16x3", True)):
        _walk_equal(args, num_tiles=30, p=p, evaluation=evaluation,
                    packed=packed)
    swt, swc, sfl, sch = worklist.pass1_inputs(nt=40, wcap=120, nchunks=80,
                                               seed=p)
    sfl = sfl.copy()
    sfl[np.flatnonzero(sfl & worklist.LAST)[::3]] &= ~worklist.LAST
    sargs = _cuda_tensors(swt, swc, sfl, sch)
    got = worklist.setup_walk(*sargs, num_tiles=40, p=p)
    torch.cuda.synchronize()
    want = worklist.setup_walk_reference(*sargs, num_tiles=40, p=p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("p", WALK_P)
def test_timing_only_variants_launch_at_every_width(p):
    """The ladders' timing-only rungs (micro_attrib s0-s4, micro_pass1 v1
    and v2) build and launch at every width; v1 and v2 leave the rows at
    the miss values."""
    from vri_tpu_torch.ops import worklist

    _card()
    for tc in (128, 256):
        args = _cuda_tensors(*worklist.steps_inputs(120, tc=tc, num_tiles=30,
                                                    num_chunks=16))
        for stage in range(worklist.FULL_STAGE):
            z, _ = worklist.template_walk(*args, num_tiles=30, p=p,
                                          evaluation="bf16x3", packed=True,
                                          stage=stage)
            torch.cuda.synchronize()
            assert z.shape == (30, p)
        if p % tc:
            continue
        sargs = _cuda_tensors(*worklist.pass1_inputs(tc=tc, nt=30, wcap=80,
                                                     nchunks=64))
        for v in (1, 2):
            z, pos = worklist.setup_walk(*sargs, num_tiles=30, p=p,
                                         variant=v)
            torch.cuda.synchronize()
            assert (z == worklist.MISS_Z).all() and (pos == -1).all()


def _grouped_equal(args, **kw):
    from vri_tpu_torch.ops import worklist

    got = worklist.grouped_step(*args, **kw)
    torch.cuda.synchronize()
    want = worklist.grouped_step_reference(*args, **kw)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv), kw
    return got


@pytest.mark.parametrize("p", [128, 512, 1024])
@pytest.mark.parametrize("w", [1, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["draws", "triangles", "ties"])
def test_grouped_step_matches_plain_version(w, kind, p):
    """Kernel ``grouped_step`` at every W from 1 (a block shorter than the
    lane unroll) to TC, at P = 128 (4 pixels a thread in a row), 512 (a
    column of one tile row a block) and 1024 (a column of two), on the
    tool's draws, triangle templates and the forced-tie templates (keys
    tied in their cleared bits and exact z ties in every block)."""
    from vri_tpu_torch.ops import worklist

    _card()
    wc, chunks = worklist.grouped_inputs(96, num_chunks=64, seed=4)
    if kind == "triangles":
        chunks = _triangle_templates(np.random.default_rng(5), 64, 128,
                                     p // 128, tiles=1)
        # the constant at the tile origin (0, 0), as the grouped prep bakes
        chunks[:, 2] = chunks[:, 2] - chunks[:, 0] * chunks[:, 3] \
            - chunks[:, 1] * chunks[:, 4]
    elif kind == "ties":
        wc, chunks = worklist.grouped_tie_inputs(96, w=w, seed=w)
    _grouped_equal(_cuda_tensors(wc, chunks), w=w, p=p)


@pytest.mark.parametrize("tc", [32, 256])
def test_grouped_step_other_lane_counts(tc):
    """TC other than the tool's 128: the key clears lane_bits(TC) bits."""
    from vri_tpu_torch.ops import worklist

    _card()
    for w in (1, 4, tc):
        wc, chunks = worklist.grouped_tie_inputs(48, w=w, tc=tc, seed=tc)
        _grouped_equal(_cuda_tensors(wc, chunks), w=w, p=1024)


def _on_cpu(cas):
    """The cascade set with every tensor copied to the CPU."""
    import dataclasses

    return cas.replace(**{f.name: getattr(cas, f.name).cpu()
                          for f in dataclasses.fields(cas)
                          if getattr(cas, f.name) is not None})


def _random_rays(m, seed):
    rng = np.random.default_rng(seed)
    o = torch.as_tensor(rng.uniform(-3.5, 3.5, (m, 3)).astype(np.float32),
                        device="cuda")
    o[:, 1] = o[:, 1].abs() * 0.5
    d = torch.as_tensor(rng.normal(size=(m, 3)).astype(np.float32),
                        device="cuda")
    return o, d / torch.linalg.norm(d, dim=-1, keepdim=True)


@pytest.mark.parametrize("div", [4, 64])
def test_march_compact_matches_one_phase_march(frame, div):
    """march_compact's three march_rays launches give one-phase march's
    result bit for bit; with a phase 1 of 8 steps (as
    tests/test_march_kernel.py runs the JAX version) at compact_div 64
    more rays survive phase 1 than the buffer holds, so the cleanup
    launch marches."""
    import dataclasses

    from vri_tpu_torch.ops import march_kernel

    r, _, _ = frame
    cas = r.ensure_cascades()
    o, d = _random_rays(50000, seed=1)
    ref = march_kernel.march(cas, o, d, 10.0, config=SDF, max_steps=72)
    _, _, _, act = march_kernel.march_rays(
        march_kernel.ray_table(cas, o, d, 10.0, SDF),
        march_kernel.pack_meta(cas, SDF), cas.march_coarse,
        cas.march_fine0, cas.march_fine1, r=64, max_steps=8)
    before = march_kernel.march_rays.launches
    got = march_kernel.march_compact(cas, o, d, 10.0, config=SDF,
                                     max_steps=72, phase1_steps=8,
                                     compact_div=div)
    assert march_kernel.march_rays.launches - before == 3
    if div == 64:
        assert int(act.sum()) > 1024
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), \
            f.name


def test_trilinear_march_card_matches_cpu(frame):
    """The trilinear loop (approx=False) runs on the rays' device, with
    no kernel launch, and agrees with the CPU run: hit, iterations,
    cascade and brick on at least 99.9% of the rays, t within rtol 1e-5
    where both hit."""
    import dataclasses

    from vri_tpu_torch.ops import march_kernel, sdf_trace

    r, _, _ = frame
    cas = r.ensure_cascades()
    cfg = dataclasses.replace(SDF, approx_occlusion=False)
    o, d = _random_rays(20000, seed=2)
    before = march_kernel.march_rays.launches
    got = sdf_trace.march(cas, o, d, 10.0, config=cfg)
    assert march_kernel.march_rays.launches == before
    assert got.t.is_cuda
    want = sdf_trace.march(_on_cpu(cas), o.cpu(), d.cpu(), 10.0,
                           config=cfg)
    same = torch.ones(o.shape[0], dtype=torch.bool)
    for key in ("hit", "iterations", "cascade", "brick"):
        same &= getattr(got, key).cpu() == getattr(want, key)
    both = same & want.hit
    assert float(same.float().mean()) >= 0.999 and bool(want.hit.any())
    torch.testing.assert_close(got.t.cpu()[both], want.t[both], rtol=1e-5,
                               atol=0)


def test_temporal_frame_launches(frame):
    """Each render_frame_gi_temporal frame at gi_scale=2 launches one
    raster_tiles and two march_rays (the shadow rays at the shadow_scale
    subsample, the GI rays at GI resolution) and nothing else."""
    import dataclasses

    from vri_tpu_torch.ops import bvh, march_kernel, rasterize, worklist
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, _ = frame
    cas = r.ensure_cascades()
    cfg = dataclasses.replace(SDF, shadow_scale=2)
    wrappers = (rasterize.raster_tiles, rasterize.raster_ranged,
                march_kernel.march_rays, bvh.bvh_traverse,
                worklist.template_walk, worklist.setup_walk,
                worklist.grouped_step)
    state = frame_mod.init_temporal(192, 256, 2, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for i in range(2):
        counts = [w.launches for w in wrappers]
        aovs, state = frame_mod.render_frame_gi_temporal(
            r.scene, fp, cas, state, height=192, width=256, config=cfg,
            use_cache=True, gi_scale=2, generator=gen)
        torch.cuda.synchronize()
        diff = [w.launches - c for w, c in zip(wrappers, counts)]
        assert diff == [1, 0, 2, 0, 0, 0, 0], diff
        assert bool(torch.isfinite(aovs["color"]).all())
        assert int(aovs["raster_overflow_tiles"]) == 0
    cov = aovs["instance_id"] >= 0
    assert float((aovs["gi_history"][cov] == 2.0).float().mean()) > 0.9


def test_lod_masked_tiers_bit_equal_on_card():
    """The LOD-masked sorted, binned and ranged tiers on the card
    (``kitchen_stress(24, tess=4)`` packed with two LOD levels, 256x192,
    the stage camera's mask at tau 0.75): tri, t, u and v bit-equal, one
    ``raster_ranged`` launch on the ranged tier, no masked face wins a
    pixel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import lod, rasterize
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    h, w = 192, 256
    d = RenderDelegate(RenderConfig(width=w, height=h, lod_levels=2,
                                    lod_min_faces=64), device="cuda")
    d.populate(scenes.kitchen_stress(num_objects=24, tess=4))
    s = d.sync()
    fp = frame_mod.FrameParams.from_camera(d.camera, h, device="cuda")
    mask, levels = lod.face_mask(s, fp.eye, 1.0 / fp.pixel_spread, 0.75)
    assert int(levels[:int(s.num_instances)].max()) >= 1
    args = (bake_world(s), s.tri_vertices, s.num_faces_total, fp.view_proj)
    kw = dict(height=h, width=w, cull_sign=frame_mod._cull_sign(s),
              face_mask=mask)
    before = rasterize.raster_ranged.launches
    hits = {t: fn(*args, **kw)[0] for t, fn in (
        ("sorted", rasterize.rasterize_sorted),
        ("binned", rasterize.rasterize_binned),
        ("ranged", rasterize.rasterize))}
    assert rasterize.raster_ranged.launches - before == 1
    for t in ("sorted", "binned"):
        assert int(hits[t].overflow) == 0, t
    tri = hits["sorted"].tri
    assert bool(mask[tri[tri >= 0].long()].all())
    for t in ("binned", "ranged"):
        for key in ("tri", "t", "u", "v"):
            assert torch.equal(getattr(hits[t], key),
                               getattr(hits["sorted"], key)), (t, key)


def test_dynamic_frame_card_matches_cpu():
    """One bounded update and one ``render_frame_gi_dynamic`` frame on
    the card against the CPU (the kernels' plain versions) on the Cornell
    box at 64^2, both from the same CPU build and bake, with the same GI
    uniforms: ``needs_full`` 0 on both, occupancy equal on at least
    99.99% of the voxels, one ``raster_tiles`` and three ``march_rays``
    on the card (the partial bake's shadow rays, the frame's shadow and
    GI rays); ``instance_id`` equal on at least 99.9% of the pixels and
    colour within 2e-3 where it is (``chip_smoke.py`` phase 10's
    tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import march_kernel, rasterize
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    cfg = SDFConfig(num_cascades=2, cascade_resolution=32,
                    base_voxel_size=0.1, max_bricks=8192,
                    truncation_voxels=2.0, max_triangles_per_brick=16,
                    approx_occlusion=True, update_cell_cap=2048)
    res = 64
    d = RenderDelegate(RenderConfig(width=res, height=res), device="cpu")
    d.populate(scenes.cornell_box())
    s = d.sync()
    centers = sdf_mod.default_centers(cfg, np.zeros(3), device="cpu")
    cas, st = sdf_build.build_for_scene(s, bake_world(s), centers, cfg)
    cas = sdf_mod.bake_brick_lighting(cas, s, config=cfg, alive=st.alive)
    ni = int(s.num_instances)
    k = int((s.instance_aabb_hi - s.instance_aabb_lo)[:ni].max(-1)
            .values.argmin())
    off = torch.tensor([0.15, 0.0, 0.1])
    tf = s.instance_transform.clone()
    tf[k, :3, 3] += off
    dlo = torch.full((4, 3), 3.0e38)
    dhi = torch.full((4, 3), -3.0e38)
    dlo[0], dhi[0] = s.instance_aabb_lo[k], s.instance_aabb_hi[k]
    dlo[1], dhi[1] = dlo[0] + off, dhi[0] + off
    uni = torch.rand((1, res * res, 2), generator=torch.Generator()
                     .manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        mv = lambda x: x.to(dev) if torch.is_tensor(x) else x  # noqa: E731
        s_d = type(s)(**{f.name: mv(getattr(s, f.name))
                         for f in dataclasses.fields(s)})
        s_d = s_d.replace(instance_transform=tf.to(dev))
        cas_d = type(cas)(**{f.name: mv(getattr(cas, f.name))
                             for f in dataclasses.fields(cas)})
        st_d = type(st)(**{f.name: mv(getattr(st, f.name))
                           for f in dataclasses.fields(st)})
        fp = frame_mod.FrameParams.from_camera(d.camera, res, device=dev)
        before = (rasterize.raster_tiles.launches,
                  march_kernel.march_rays.launches)
        aovs, _, cas1, _, nf = frame_mod.render_frame_gi_dynamic(
            s_d, fp, cas_d, st_d,
            frame_mod.init_temporal(res, res, 1, device=dev),
            s_d.tri_instance == k, dlo.to(dev), dhi.to(dev), height=res,
            width=res, config=cfg, use_cache=True, uniforms=uni.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (rasterize.raster_tiles.launches - before[0],
                    march_kernel.march_rays.launches - before[1]) == (1, 3)
        assert int(nf) == 0, dev
        out[dev] = ({key: v.cpu() for key, v in aovs.items()},
                    cas1.brick_map.cpu())
    (a, bm_a), (b, bm_b) = out["cpu"], out["cuda"]
    assert float(((bm_a >= 0) == (bm_b >= 0)).float().mean()) >= 0.9999
    same = a["instance_id"] == b["instance_id"]
    assert float(same.float().mean()) >= 0.999
    assert float((a["color"] - b["color"]).abs().amax(-1)[same].max()) \
        <= 2e-3
    assert bool(torch.isfinite(b["color"]).all())


def _to(obj, dev):
    """A dataclass of tensors (scene, cascades) moved to ``dev``; a
    scene's mip atlas is dropped (shading rebuilds it on ``dev``)."""
    import dataclasses

    def mv(name):
        x = getattr(obj, name)
        return (x.to(dev) if torch.is_tensor(x)
                else None if name == "mip_atlas" else x)
    return type(obj)(**{f.name: mv(f.name) for f in dataclasses.fields(obj)})


def test_band_card_matches_cpu(frame):
    """A band of the kitchen (rows [64, 128) of the 256x192 frame): each
    tier's band on the card equal to the CPU's on at least 99.9% of the
    pixels (triangle) and the card's tiers bit-equal to each other; one
    ``render_frame_gi_temporal(band=...)`` frame at ``gi_scale=2`` on the
    card against the CPU from the same cascades and uniforms, with one
    ``raster_tiles`` and two ``march_rays`` launches on the card,
    ``instance_id`` equal on at least 99.9% of the pixels and colour
    within 2e-3 where it is."""
    from vri_tpu_torch.ops import march_kernel, rasterize
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    r, _, _ = frame
    y0, band, full, w = 64, 64, 192, 256
    cas = r.ensure_cascades()
    uni = torch.rand((1, (band // 2) * (w // 2), 2),
                     generator=torch.Generator().manual_seed(3))
    tiers = {"sorted": rasterize.rasterize_sorted,
             "binned": rasterize.rasterize_binned,
             "ranged": rasterize.rasterize}
    out = {}
    for dev in ("cpu", "cuda"):
        s = _to(r.scene, dev)
        fp = frame_mod.FrameParams.from_camera(r.camera, full, device=dev)
        world = bake_world(s)
        hits = {t: fn(world, s.tri_vertices, s.num_faces, fp.view_proj,
                      height=band, width=w, proj_height=full,
                      y_offset=float(y0),
                      cull_sign=frame_mod._cull_sign(s))[0]
                for t, fn in tiers.items()}
        before = (rasterize.raster_tiles.launches,
                  march_kernel.march_rays.launches)
        aovs, _ = frame_mod.render_frame_gi_temporal(
            s, fp, _to(cas, dev),
            frame_mod.init_temporal(band, w, 2, device=dev), height=band,
            width=w, config=SDF, use_cache=True, gi_scale=2,
            band=(y0, full), uniforms=uni.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (rasterize.raster_tiles.launches - before[0],
                    march_kernel.march_rays.launches - before[1]) == (1, 2)
            for t in ("binned", "ranged"):
                for key in ("tri", "t", "u", "v"):
                    assert torch.equal(getattr(hits[t], key),
                                       getattr(hits["sorted"], key)), (t, key)
        out[dev] = ({t: h.tri.cpu() for t, h in hits.items()},
                    {k: v.cpu() for k, v in aovs.items()})
    (ha, a), (hb, b) = out["cpu"], out["cuda"]
    for t in tiers:
        assert float((ha[t] == hb[t]).float().mean()) >= 0.999, t
    same = a["instance_id"] == b["instance_id"]
    assert float(same.float().mean()) >= 0.999
    assert float((a["color"] - b["color"]).abs().amax(-1)[same].max()) \
        <= 2e-3
    assert bool(torch.isfinite(b["color"]).all())


def test_dense_build_card_matches_cpu():
    """The dense SDF build (``SDFConfig.preset("tiny")``) of the Cornell
    box on the card against the CPU: counts, brick map and nearest-surface
    payload exactly equal, the atlas within one u8 step; a GI frame through
    ``Renderer.render`` on each with the same uniforms ("rebuilt
    (dense)"), ``instance_id`` equal on at least 99.9% of the pixels and
    colour within 2e-3 where it is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    tiny = SDFConfig.preset("tiny")
    res = 64
    uni = torch.rand((1, res * res, 2),
                     generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", "cuda"):
        r = Renderer(RenderConfig(width=res, height=res, sdf=tiny),
                     device=dev)
        r.load_stage(scenes.cornell_box())
        cas = sdf_mod.build_for_scene(r.scene, bake_world(r.scene),
                                      np.zeros(3, np.float32), tiny)
        aovs = r.render(gi=True, uniforms=uni.to(dev))
        assert r.last_build_label == "rebuilt (dense)"
        out[dev] = (cas, aovs)
    (ca, a), (cb, b) = out["cpu"], out["cuda"]
    for key in ("num_bricks", "overflow", "brick_map", "brick_voxel",
                "brick_albedo", "brick_emissive", "brick_normal",
                "march_coarse", "march_fine0", "march_fine1"):
        assert torch.equal(getattr(ca, key), getattr(cb, key).cpu()), key
    step = (ca.atlas.int() - cb.atlas.cpu().int()).abs().max()
    assert int(step) <= 1
    same = a["instance_id"] == b["instance_id"]
    assert same.mean() >= 0.999
    assert np.abs(a["color"] - b["color"]).max(-1)[same].max() <= 2e-3
    assert np.isfinite(b["color"]).all()


def test_tiled_frames_world_size_1_nccl(monkeypatch):
    """``vri_tpu_torch.parallel.tiling`` over a one-rank ``nccl`` mesh on
    the card (the process group of a ``torchrun --nproc-per-node 1``):
    the tiled static, temporal (``gi_scale`` 2, two frames) and dynamic
    frames bit-equal to ``render_frame_gi``, ``render_frame_gi_temporal``
    and ``render_frame_gi_dynamic`` with the same uniforms, on the
    Cornell box at 64^2 with ``test_dynamic_frame_card_matches_cpu``'s
    configuration and motion; the same launches of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket

    import torch.distributed as dist

    from vri_tpu_torch.ops import march_kernel, rasterize
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.parallel import make_mesh, tiling
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    cfg = SDFConfig(num_cascades=2, cascade_resolution=32,
                    base_voxel_size=0.1, max_bricks=8192,
                    truncation_voxels=2.0, max_triangles_per_brick=16,
                    approx_occlusion=True, update_cell_cap=2048)
    res = 64
    d = RenderDelegate(RenderConfig(width=res, height=res), device="cuda")
    d.populate(scenes.cornell_box())
    s = d.sync()
    centers = sdf_mod.default_centers(cfg, np.zeros(3), device="cuda")
    cas, st = sdf_build.build_for_scene(s, bake_world(s), centers, cfg)
    cas = sdf_mod.bake_brick_lighting(cas, s, config=cfg, alive=st.alive)
    fp = frame_mod.FrameParams.from_camera(d.camera, res, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand((1, res * res, 2), generator=gen, device="cuda")
    ug = torch.rand((1, (res // 2) ** 2, 2), generator=gen, device="cuda")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, val in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                         MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, val)
    mesh = make_mesh()
    kw = dict(height=res, width=res, config=cfg)

    def run(fn):
        before = (rasterize.raster_tiles.launches,
                  march_kernel.march_rays.launches)
        out = fn()
        torch.cuda.synchronize()
        return out, (rasterize.raster_tiles.launches - before[0],
                     march_kernel.march_rays.launches - before[1])

    try:
        assert (mesh.backend, mesh.size, mesh.device) == (
            "nccl", 1, torch.device("cuda:0"))
        tiled, lt = run(lambda: tiling.render_frame_tiled(
            s, fp, cas, mesh=mesh, uniforms=u, **kw))
        single, ls = run(lambda: frame_mod.render_frame_gi(
            s, fp, cas, uniforms=u, use_cache=True, **kw))
        assert lt == ls == (1, 2)
        for key in ("color", "depth", "instance_id"):
            assert torch.equal(tiled[key], single[key]), key
        states = [frame_mod.init_temporal(res, res, 2, device="cuda")
                  for _ in range(2)]
        for _ in range(2):
            (tiled, states[0]), lt = run(
                lambda: tiling.render_frame_tiled_temporal(
                    s, fp, cas, states[0], mesh=mesh, gi_scale=2,
                    uniforms=ug, **kw))
            (single, states[1]), ls = run(
                lambda: frame_mod.render_frame_gi_temporal(
                    s, fp, cas, states[1], gi_scale=2, uniforms=ug,
                    use_cache=True, **kw))
            assert lt == ls == (1, 2)
            for key in ("color", "depth", "gi_history"):
                assert torch.equal(tiled[key], single[key]), key
            assert torch.equal(states[0].data, states[1].data)
        ni = int(s.num_instances)
        k = int((s.instance_aabb_hi - s.instance_aabb_lo)[:ni].max(-1)
                .values.argmin())
        off = torch.tensor([0.15, 0.0, 0.1], device="cuda")
        tf = s.instance_transform.clone()
        tf[k, :3, 3] += off
        dlo = torch.full((4, 3), 3.0e38, device="cuda")
        dhi = torch.full((4, 3), -3.0e38, device="cuda")
        dlo[0], dhi[0] = s.instance_aabb_lo[k], s.instance_aabb_hi[k]
        dlo[1], dhi[1] = dlo[0] + off, dhi[0] + off
        args = (s.replace(instance_transform=tf), fp, cas, st,
                frame_mod.init_temporal(res, res, 1, device="cuda"),
                s.tri_instance == k, dlo, dhi)
        tiled, lt = run(lambda: tiling.render_frame_tiled_dynamic(
            *args, mesh=mesh, uniforms=u, **kw))
        single, ls = run(lambda: frame_mod.render_frame_gi_dynamic(
            *args, uniforms=u, use_cache=True, **kw))
        assert lt == ls == (1, 3)
        assert int(tiled[4]) == int(single[4]) == 0
        for key in ("color", "depth", "gi_history"):
            assert torch.equal(tiled[0][key], single[0][key]), key
        for f in ("atlas", "voxel_shade", "brick_irradiance", "brick_map"):
            assert torch.equal(getattr(tiled[2], f), getattr(single[2], f))
    finally:
        dist.destroy_process_group()


def _prep_equal(args, kw):
    """The prep's kernels against its plain version on the card: the slot
    table bit for bit, src, starts, counts, overflow and the live part of
    the lists exactly equal.  Returns the kernels' dict."""
    from vri_tpu_torch.ops import rasterize

    before = rasterize.raster_prep.launches
    got = rasterize.prepare_sorted(*args, **kw)
    torch.cuda.synchronize()
    assert rasterize.raster_prep.launches == before + 1
    want = rasterize.prepare_sorted_reference(*args, **kw)
    assert torch.equal(got["coef"].view(torch.int32),
                       want["coef"].view(torch.int32))
    for k in ("src", "starts", "counts", "overflow"):
        assert torch.equal(got[k], want[k]), k
    n = int(want["starts"][-1])
    assert got["lists"].shape == want["lists"].shape
    assert torch.equal(got["lists"][:n], want["lists"][:n])
    for k in ("cap", "num_tx", "grid"):
        assert got[k] == want[k]
    return got


def _on_cuda(x):
    return x.cuda() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("case", ["kitchen_1080p", *PREP_CASES])
def test_raster_prep_matches_plain_version(case):
    """Cases: the 49k-face kitchen at 1920x1080 (two radix passes over
    2,025 tiles), and each case of the CPU prep tests -- the kitchen, its
    frame without culling, a camera among near-plane crossers, a band, the
    compacted faces (``src_map``), a face mask, caps_scale 2, and the
    overflow of the pair stream, of the second slots and of a tile's
    list, and no faces."""
    _card()
    if case == "kitchen_1080p":
        args, kw = kitchen_args(1080, 1920, 256, 4, device="cuda")
        want_overflow = 0
    else:
        build, want_overflow = PREP_CASES[case]
        args, kw = build()
        args = tuple(_on_cuda(x) for x in args)
        kw = {k: _on_cuda(v) for k, v in kw.items()}
    got = _prep_equal(args, kw)
    assert int(got["overflow"]) == want_overflow
    if case != "no_faces":
        assert int(got["starts"][-1]) > 0


def test_raster_prep_has_no_host_sync(frame):
    """Three preps on the card under ``set_sync_debug_mode("error")``:
    no host sync, and one pipeline counted a call."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    args = (world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj)
    kw = dict(height=192, width=256, cull_sign=frame_mod._cull_sign(r.scene))
    rasterize.prepare_sorted(*args, **kw)
    torch.cuda.synchronize()
    before = rasterize.raster_prep.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            prep = rasterize.prepare_sorted(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rasterize.raster_prep.launches == before + 3
    assert int(prep["starts"][-1]) > 0 and int(prep["overflow"]) == 0


@pytest.mark.parametrize("case", ["kitchen", "dense", "float_atlas"])
def test_sdf_emit_matches_plain_version(case):
    """The ``sdf_emit`` kernel (``csrc/sdf_emit.cu``) bit-equal to the
    plain emit (``sdf_build._emit_blocks``, eager on the same CUDA
    tensors) on every live brick of a card build: the animated kitchen at
    this file's SDF settings; a dense case (1 m cells, whose 27
    neighbourhoods hold thousands of candidates, so the kernel's key
    buffer is cut many times a brick); the float atlas with 8 triangles a
    brick.  One launch, no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.ops.sdf import cascade_origin
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    cfg, stage = {
        "kitchen": (SDF, dict(num_objects=24, tess=2)),
        "dense": (dataclasses.replace(
            SDF, num_cascades=1, cascade_resolution=16, base_voxel_size=1.0,
            truncation_voxels=1.0, max_triangles_per_brick=32),
            dict(num_objects=64, tess=6)),
        "float_atlas": (dataclasses.replace(
            SDF, atlas_u8=False, max_triangles_per_brick=8),
            dict(num_objects=24, tess=3)),
    }[case]
    r = Renderer(RenderConfig(width=64, height=64, sdf=cfg), device="cuda")
    r.load_stage(scenes.kitchen_anim(**stage))
    r.ensure_cascades()
    cfg = r._sdf_cfg_effective or cfg
    st, cas, scene = r._build_state, r.cascades, r.scene
    alb, emi = sdf_build._scene_colors(scene)
    a, b, c, valid, tri_n, alb, emi = sdf_build._prep_tris(
        bake_world(scene), scene.tri_vertices, scene.num_faces, alb, emi)
    tris = (a, b, c, valid, alb, emi, tri_n)
    bids = torch.nonzero(st.alive).reshape(-1)
    vs = cas.voxel_size
    origins = cascade_origin(cas.center, vs, cfg.cascade_resolution)
    args = (bids, cas.brick_voxel, st, origins, vs, tris, cfg)
    want = sdf_build._emit_blocks(*args)
    before = sdf_build._emit_kernel.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sdf_build._emit_kernel(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sdf_build._emit_kernel.launches - before == 1
    names = ("atlas", "albedo", "emissive", "normal", "near_drop")
    for name, x, y in zip(names, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), (
            case, name, int((x != y).sum()))
    assert int(want[4]) > 0 or case != "dense"


#: tests/test_torch_sdf_update.py's CFG (the JAX parity scenes)
UPDATE_CFG = dict(num_cascades=2, cascade_resolution=32, base_voxel_size=0.1,
                  max_bricks=8192, truncation_voxels=2.0,
                  max_triangles_per_brick=16, update_cell_cap=2048,
                  update_brick_cap=8192, update_tri_cap=512)
#: case -> (config changes, instance moved ("smallest", "box" or an index),
#: its offset, axis_name); each breach case's counter must read non-zero
UPDATE_CASES = {
    "smallest": ({}, "smallest", (0.15, 0.0, 0.1), None),
    "wall_cells_past_cap": (dict(update_cell_cap=8), 3, (0.25, 0.1, 0.0),
                            None),
    "bricks_past_cap": (dict(update_brick_cap=32), "smallest",
                        (0.15, 0.0, 0.1), None),
    "tris_past_cap": (dict(update_tri_cap=5), "box", (0.15, 0.0, 0.1), None),
    "free_slots_exhausted": (dict(max_bricks=400), 3, (0.25, 0.1, 0.0),
                             None),
    # a box's 12 triangles re-bin to at most 12 a cell, so only the merge
    # with the cells' old lists passes K
    "merged_list_past_k": (dict(cell_list_cap=12), "box", (0.15, 0.0, 0.1),
                           None),
    "rebin_past_k": (dict(cell_list_cap=2), "box", (0.15, 0.0, 0.1), None),
    "glob_past_kg": (dict(global_list_cap=2), 3, (0.25, 0.1, 0.0), None),
    "share_proxy": (dict(update_brick_cap=512), "smallest", (0.15, 0.0, 0.1),
                    (None, 2)),
    "float_atlas": (dict(atlas_u8=False), "smallest", (0.15, 0.0, 0.1),
                    None),
}


def _update_equal(got, want, label):
    """Every field of the two updates' cascades and build states, and
    ``needs_full``, equal in dtype, shape and value."""
    import dataclasses

    (c1, s1, n1), (c2, s2, n2) = got, want
    for obj1, obj2 in ((c1, c2), (s1, s2)):
        for f in dataclasses.fields(obj2):
            a, b = getattr(obj1, f.name), getattr(obj2, f.name)
            if b is None:
                assert a is None, (label, f.name)
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (
                label, f.name, a.dtype, b.dtype, a.shape, b.shape)
            assert torch.equal(a, b), (label, f.name, int((a != b).sum()))
    assert n1.dtype == n2.dtype and int(n1) == int(n2), (
        label, int(n1), int(n2))


def _moved(scene, world, inst, off):
    """World vertices with instance ``inst`` moved by ``off``, its
    triangles and its old and new boxes."""
    mask = scene.tri_instance == inst
    vi = scene.tri_vertices.long()
    w1 = world.clone()
    w1[torch.unique(vi[mask])] += torch.tensor(off, device=world.device)
    old, new = world[vi[mask]], w1[vi[mask]]
    return (w1, mask, torch.stack([old.amin((0, 1)), new.amin((0, 1))]),
            torch.stack([old.amax((0, 1)), new.amax((0, 1))]))


def _cornell_update(cfg_over, inst, off):
    """(config, scene, cascades, state, update inputs) of the Cornell box
    built on the card at ``UPDATE_CFG`` with ``cfg_over``, instance
    ``inst`` moved by ``off``."""
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.registry import bake_world

    cfg = SDFConfig(**{**UPDATE_CFG, **cfg_over})
    d = RenderDelegate(RenderConfig(width=32, height=32), device="cuda")
    d.populate(scenes.cornell_box())
    s = d.sync()
    world = bake_world(s)
    centers = sdf_mod.default_centers(cfg, np.zeros(3), device="cuda")
    cas, st = sdf_build.build_for_scene(s, world, centers, cfg)
    ni = int(s.num_instances)
    if inst == "smallest":
        inst = int((s.instance_aabb_hi - s.instance_aabb_lo)[:ni]
                   .amax(-1).argmin())
    elif inst == "box":
        counts = torch.bincount(s.tri_instance[:int(s.num_faces)].long())
        inst = int((counts == 12).nonzero()[0])
    return cfg, s, cas, st, _moved(s, world, inst, off)


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_sdf_update_matches_plain_version(case):
    """The bounded update's device pipeline (``update_cascades`` on CUDA
    tensors: ``csrc/sdf_update.cu`` and one counted ``sdf_emit`` launch)
    bit-equal to the plain update (``update_cascades_reference``, eager on
    the same tensors): every field of the cascades (brick map, atlas,
    payloads, counts, march tables) and of the build state (lists, counts,
    rows, ``alive``, ``emit_bricks``, ``list_overflow``) and
    ``needs_full``, on tests/test_torch_sdf_update.py's scenes and on one
    breach of each capacity: dirty triangles, cells and emit bricks past
    their caps, the free slots exhausted, the re-bin and a merged list past
    K, the global list past Kg; also one share of a two-way split emit and
    the float atlas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vri_tpu_torch.ops import sdf_build

    over, inst, off, axis = UPDATE_CASES[case]
    cfg, s, cas, st, (w1, mask, dlo, dhi) = _cornell_update(over, inst, off)
    alb, emi = sdf_build._scene_colors(s)
    args = (cas, st, w1, s.tri_vertices, s.num_faces, mask, dlo, dhi)
    kw = dict(tri_albedo=alb, tri_emissive=emi, config=cfg, axis_name=axis)
    want = sdf_build.update_cascades_reference(*args, **kw)
    before = sdf_build._emit_kernel.launches
    got = sdf_build.update_cascades(*args, **kw)
    torch.cuda.synchronize()
    assert sdf_build._emit_kernel.launches == before + 1
    _update_equal(got, want, case)
    c2, s2, n2 = want
    hit = {"wall_cells_past_cap": int(n2), "bricks_past_cap": int(n2),
           "tris_past_cap": int(n2), "rebin_past_k": int(n2),
           "glob_past_kg": int(n2),
           "free_slots_exhausted": int(c2.overflow - cas.overflow),
           "merged_list_past_k": int(s2.list_overflow - st.list_overflow),
           }.get(case, int(s2.emit_bricks.sum()))
    assert hit > 0, case


@pytest.fixture(scope="module")
def anim_kitchen():
    """The animated cell's stage and SDF (``kitchen49k-anim-room-1080p``:
    ``kitchen_anim(256, tess=4)``, the room preset, list caps scaled to
    the demand) built on the card, and the first update's inputs: the
    moved prop at code 1 of its circle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import math

    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    r = Renderer(RenderConfig(width=64, height=64,
                              sdf=SDFConfig.preset("room")), device="cuda")
    r.load_stage(scenes.kitchen_anim(num_objects=256, seed=7, tess=4,
                                     radius=0.03, period=9))
    r.ensure_cascades()
    scene = r.scene.base_view()
    ni = int(scene.num_instances)
    k = int((scene.instance_aabb_hi - scene.instance_aabb_lo)[:ni]
            .amax(-1).argmin())
    ang = 2.0 * math.pi / 9.0
    off = (0.03 * math.cos(ang), 0.0, 0.03 * math.sin(ang))
    return (r._sdf_cfg_effective or r.config.sdf, scene, r.cascades,
            r._build_state, _moved(scene, bake_world(scene), k, off))


def test_sdf_update_animated_kitchen_first_update(anim_kitchen):
    """The device pipeline bit-equal to the plain update at the animated
    cell's first update (about 4,000 bricks re-emitted)."""
    from vri_tpu_torch.ops import sdf_build

    cfg, s, cas, st, (w1, mask, dlo, dhi) = anim_kitchen
    args = (cas, st, s, w1, mask, dlo, dhi, cfg)
    alb, emi = sdf_build._scene_colors(s)
    want = sdf_build.update_cascades_reference(
        cas, st, w1, s.tri_vertices, s.num_faces, mask, dlo, dhi,
        tri_albedo=alb, tri_emissive=emi, config=cfg)
    got = sdf_build.update_for_scene(*args)
    _update_equal(got, want, "animated kitchen")
    assert int(want[2]) == 0 and int(want[1].emit_bricks.sum()) > 1000


def test_sdf_update_has_no_host_sync(anim_kitchen):
    """Three updates at the animated cell's first update under
    ``set_sync_debug_mode("error")``: no host sync, one ``sdf_emit``
    launch each, and ``sdf_update.kernel_path`` counted once each."""
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.runtime import profiler

    cfg, s, cas, st, (w1, mask, dlo, dhi) = anim_kitchen
    args = (cas, st, s, w1, mask, dlo, dhi, cfg)
    sdf_build.update_for_scene(*args)
    torch.cuda.synchronize()
    before = sdf_build._emit_kernel.launches
    profiler.start_recording()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            got = sdf_build.update_for_scene(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiler.stop_recording()
    counts = [c.name for c in profiler.recorded_counts()]
    assert sdf_build._emit_kernel.launches == before + 3
    assert counts.count("sdf_update.kernel_path") == 3
    assert int(got[2]) == 0
