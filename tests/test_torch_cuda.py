"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and its frames and paths as the program runs them.  These tests
import no JAX; ``tests/conftest.py`` does, so on a machine without JAX
run them without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

The kernel tests build the stage (or the work list, or synthetic march
tables) with the port itself, run one kernel (raster_tiles,
raster_ranged, march_rays, bvh_traverse, the work-list kernels
template_walk, setup_walk and grouped_step, the sorted tier's prep
raster_prep, the SDF emit sdf_emit, the bounded update's pipeline
sdf_update, the temporal frame's history stage temporal_history) on CUDA
tensors and its plain version on the same tensors,
and require exact equality: the kernels are built with -fmad=false and
follow their plain versions' operation order, so every output agrees bit
for bit (also raster_ranged's per-tile tested pairs and bvh_traverse's
visit counts); the prep, the emit and the update also with no host sync.

The frame tests run the program -- ``Renderer.render`` through every
raster tier, the BVH and three SDF presets, the direct-only frame, the
production temporal frame and animated playback through
``Renderer.render_temporal`` on the benchmark cells' own stages, sizes
and SDF preset, bands, the city at 1.35M faces, the update
and the scroll against a rebuild, the scene cache, the app, and the
sharded frames over one ``nccl`` rank and over four ``gloo`` ranks
sharing the card -- with every kernel launch counted and each launch of
R, K6, M, bvh_traverse and temporal_history held bit-equal to its plain
version on that launch's own inputs (:func:`_run_held`); where the CPU
renders the same frame with the plain versions, the two agree within the
tolerances each test names.  On a host without a card every test skips.
"""

import dataclasses
import sys

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


@pytest.mark.parametrize("case", ["kitchen", "kitchen_1080p"])
def test_raster_tiles_matches_plain_version(frame, case):
    """R bit-equal to its plain version on the sorted tier's lists: the
    kitchen fixture at 256x192, and the cells' 49k-face kitchen at
    1920x1080 (2,025 tiles, the lists the benchmark's frames walk), whose
    prep overflows nothing."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    if case == "kitchen":
        r, fp, world = frame
        args = (world, r.scene.tri_vertices, r.scene.num_faces, fp.view_proj)
        kw = dict(height=192, width=256,
                  cull_sign=frame_mod._cull_sign(r.scene))
    else:
        args, kw = kitchen_args(1080, 1920, 256, 4, device="cuda")
    prep = rasterize.prepare_sorted(*args, **kw)
    assert int(prep["overflow"]) == 0
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
    colour within 2e-3 where it is (the tolerances of
    ``test_gi_frame_and_sdf_views_card_match_cpu``)."""
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
    moved = _moved_smallest(s, (0.15, 0.0, 0.1))
    uni = torch.rand((1, res * res, 2), generator=torch.Generator()
                     .manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        mv = lambda x: x.to(dev) if torch.is_tensor(x) else x  # noqa: E731
        s_d, cas_d, st_d = (type(x)(**{f.name: mv(getattr(x, f.name))
                                       for f in dataclasses.fields(x)})
                            for x in (moved[0], cas, st))
        fp = frame_mod.FrameParams.from_camera(d.camera, res, device=dev)
        before = (rasterize.raster_tiles.launches,
                  march_kernel.march_rays.launches)
        aovs, _, cas1, _, nf = frame_mod.render_frame_gi_dynamic(
            s_d, fp, cas_d, st_d,
            frame_mod.init_temporal(res, res, 1, device=dev),
            *(x.to(dev) for x in moved[1:]), height=res, width=res,
            config=cfg, use_cache=True, uniforms=uni.to(dev))
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


def _cornell_dynamic(dev):
    """The Cornell box at 64^2 built and baked on ``dev`` at
    ``test_dynamic_frame_card_matches_cpu``'s configuration: (config,
    scene, camera, frame parameters, cascades, build state, and the
    dynamic frame's inputs with the smallest instance moved by (0.15, 0,
    0.1): the moved scene, its triangles, the dirty boxes)."""
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    cfg = SDFConfig(num_cascades=2, cascade_resolution=32,
                    base_voxel_size=0.1, max_bricks=8192,
                    truncation_voxels=2.0, max_triangles_per_brick=16,
                    approx_occlusion=True, update_cell_cap=2048)
    d = RenderDelegate(RenderConfig(width=64, height=64), device=dev)
    d.populate(scenes.cornell_box())
    s = d.sync()
    centers = sdf_mod.default_centers(cfg, np.zeros(3), device=dev)
    cas, st = sdf_build.build_for_scene(s, bake_world(s), centers, cfg)
    cas = sdf_mod.bake_brick_lighting(cas, s, config=cfg, alive=st.alive)
    fp = frame_mod.FrameParams.from_camera(d.camera, 64, device=dev)
    return (cfg, s, d.camera, fp, cas, st,
            _moved_smallest(s, (0.15, 0.0, 0.1)))


def test_tiled_frames_world_size_1_nccl(monkeypatch):
    """``vri_tpu_torch.parallel.tiling`` over a one-rank ``nccl`` mesh on
    the card (the process group of a ``torchrun --nproc-per-node 1``):
    the tiled static, temporal (``gi_scale`` 2, two frames) and dynamic
    frames bit-equal to ``render_frame_gi``, ``render_frame_gi_temporal``
    and ``render_frame_gi_dynamic`` with the same uniforms, on the
    Cornell box at 64^2 with ``test_dynamic_frame_card_matches_cpu``'s
    configuration and motion; the same launches of each kernel (R, M and,
    in the temporal and dynamic frames, one ``temporal_history``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket

    import torch.distributed as dist

    from vri_tpu_torch.ops import march_kernel, rasterize
    from vri_tpu_torch.parallel import make_mesh, tiling
    from vri_tpu_torch.passes import frame as frame_mod

    cfg, s, _, fp, cas, st, moved = _cornell_dynamic("cuda")
    res = 64
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
                  march_kernel.march_rays.launches,
                  frame_mod.temporal_history.launches)
        out = fn()
        torch.cuda.synchronize()
        return out, (rasterize.raster_tiles.launches - before[0],
                     march_kernel.march_rays.launches - before[1],
                     frame_mod.temporal_history.launches - before[2])

    try:
        assert (mesh.backend, mesh.size, mesh.device) == (
            "nccl", 1, torch.device("cuda:0"))
        tiled, lt = run(lambda: tiling.render_frame_tiled(
            s, fp, cas, mesh=mesh, uniforms=u, **kw))
        single, ls = run(lambda: frame_mod.render_frame_gi(
            s, fp, cas, uniforms=u, use_cache=True, **kw))
        assert lt == ls == (1, 2, 0)
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
            assert lt == ls == (1, 2, 1)
            for key in ("color", "depth", "gi_history"):
                assert torch.equal(tiled[key], single[key]), key
            assert torch.equal(states[0].data, states[1].data)
        args = (moved[0], fp, cas, st,
                frame_mod.init_temporal(res, res, 1, device="cuda"),
                *moved[1:])
        tiled, lt = run(lambda: tiling.render_frame_tiled_dynamic(
            *args, mesh=mesh, uniforms=u, **kw))
        single, ls = run(lambda: frame_mod.render_frame_gi_dynamic(
            *args, uniforms=u, use_cache=True, **kw))
        assert lt == ls == (1, 3, 1)
        assert int(tiled[4]) == int(single[4]) == 0
        for key in ("color", "depth", "gi_history"):
            assert torch.equal(tiled[0][key], single[0][key]), key
        for f in ("atlas", "voxel_shade", "brick_irradiance", "brick_map"):
            assert torch.equal(getattr(tiled[2], f), getattr(single[2], f))
    finally:
        dist.destroy_process_group()


def test_tiled_frames_gloo_ranks_share_the_card(tmp_path):
    """``vri_tpu_torch.parallel`` over four ``gloo`` ranks sharing cuda:0,
    whose collectives stage CUDA tensors through the host, the ranks
    started by ``mesh.launch`` as this file's ``--gloo-rank``
    (:func:`_gloo_rank`), on :func:`_cornell_dynamic`'s scene (16-row
    bands): the tiled frame at ``samples`` 0 and 1, each rank its band's
    samples, one R and ``samples`` + 1 M a rank, each held on its own
    inputs, its ids off the single-card frame's on at most 0.05% of the
    pixels; the temporal frame (``gi_scale`` 2, two halo rows) over a
    small pan carrying its history on more than half the covered pixels
    of every band border row; ``esd_sharded`` and ``scroll_slab`` (by 2
    and past one slab) equal to ``esd_map`` and ``torch.roll`` on cascade
    0; the tiled dynamic frame (the sharded update and re-bake) with
    ``atlas`` and ``voxel_shade`` bit-equal to the single-card dynamic
    frame's, ``needs_full`` 0; on a 2 x 2 mesh ``merge_scene_partitions``
    rebuilding the scene from two hosts' partial scenes and
    ``render_frame_tiled_2d`` giving the 1-D frame's ids."""
    import os

    from vri_tpu_torch.parallel import mesh as mesh_mod

    _card()
    out = str(tmp_path / "rank")
    proc = mesh_mod.launch(4, [os.path.abspath(__file__), "--gloo-rank",
                               out], capture=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-8000:]
    for i in range(4):
        assert os.path.exists(f"{out}{i}.json"), i


def _pan(cam, dy: float):
    """``cam`` moved up by ``dy`` (world units), looking the same way."""
    import dataclasses

    t = np.eye(4, dtype=np.float32)
    t[1, 3] = -dy
    return dataclasses.replace(cam, eye=cam.eye + np.float32([0, dy, 0]),
                               view=(cam.view @ t).astype(np.float32))


def _gloo_rank(out: str) -> None:
    """One rank of ``test_tiled_frames_gloo_ranks_share_the_card``: its
    checks on this rank; writes ``<out><rank>.json`` when all hold."""
    import json

    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.parallel import halo, make_mesh, multihost, tiling
    from vri_tpu_torch.parallel import mesh as mesh_mod
    from vri_tpu_torch.passes import frame as frame_mod

    mesh = make_mesh(backend="gloo", device="cuda:0")
    dev, rank, n, ax = mesh.device, mesh.rank, mesh.size, mesh.axis()
    cfg, s, cam, fp, cas, st, moved = _cornell_dynamic(dev)
    res, band = 64, 64 // n
    kw = dict(height=res, width=res, config=cfg)

    def band_u(i):
        return torch.rand((1, band * res, 2), device=dev,
                          generator=mesh_mod.band_generator(29, i, dev))

    ids = {}
    for smp in (0, 1):
        aovs, launches = _run_held(lambda: tiling.render_frame_tiled(
            s, fp, cas, mesh=mesh, samples=smp,
            uniforms=band_u(rank) if smp else None, **kw))
        assert launches == dict(raster_tiles=1, march_rays=1 + smp)
        uni = torch.cat([band_u(i) for i in range(n)], 1) if smp else None
        single = frame_mod.render_frame_gi(s, fp, cas, samples=smp,
                                           uniforms=uni, use_cache=True,
                                           **kw)
        ids[smp] = float((aovs["instance_id"]
                          != single["instance_id"]).float().mean())
        assert ids[smp] <= 0.0005, ids
        if smp == 0:
            ids_1d = aovs["instance_id"]
    state = frame_mod.init_temporal(band, res, 2, device=dev)
    gen = mesh_mod.band_generator(292, rank, dev)
    for c in (cam, _pan(cam, 0.002)):
        fpi = frame_mod.FrameParams.from_camera(c, res, device=dev)
        aovs, state = tiling.render_frame_tiled_temporal(
            s, fpi, cas, state, mesh=mesh, gi_scale=2, halo_rows=2,
            uniforms=torch.rand((1, (band // 2) * (res // 2), 2),
                                generator=gen, device=dev), **kw)
    hist, cov = aovs["gi_history"], aovs["instance_id"] >= 0
    borders = [float((hist[y][cov[y]] >= 2.0).float().mean())
               for b in range(1, n) for y in (b * band - 1, b * band)]
    assert float((hist[cov] >= 2.0).float().mean()) > 0.5
    assert min(borders) > 0.5, borders
    occ = cas.brick_map[0] >= 0
    dense = sdf_build.esd_map(occ[None]).reshape(occ.shape)
    sharded = mesh_mod.gather_rows(
        halo.esd_sharded(mesh_mod.shard_rows(occ, mesh), ax, 15), mesh)
    assert torch.equal(sharded, dense)
    vol = occ.to(torch.float32)
    for shift in (2, occ.shape[0] // n + 3):
        rolled = mesh_mod.gather_rows(halo.scroll_slab(
            mesh_mod.shard_rows(vol, mesh), shift, 0, ax), mesh)
        assert torch.equal(rolled, torch.roll(vol, -shift, 0)), shift
    tiled, launches = _run_held(lambda: tiling.render_frame_tiled_dynamic(
        moved[0], fp, cas, st, frame_mod.init_temporal(band, res, 2,
                                                       device=dev),
        *moved[1:], mesh=mesh, gi_scale=2, halo_rows=2, seed=29, **kw))
    assert launches["raster_tiles"] == 1 and launches["sdf_update"] == 1
    assert launches["temporal_history"] == 1
    single = frame_mod.render_frame_gi_dynamic(
        moved[0], fp, cas, st, frame_mod.init_temporal(res, res, 2,
                                                       device=dev),
        *moved[1:], gi_scale=2, use_cache=True,
        generator=torch.Generator(device=dev).manual_seed(29), **kw)
    assert int(tiled[4]) == int(single[4]) == 0
    for f in ("atlas", "voxel_shade"):
        assert torch.equal(getattr(tiled[2], f), getattr(single[2], f)), f
    mesh2 = multihost.make_mesh_2d(2, n // 2, backend="gloo", device=dev)
    owner = torch.arange(s.instance_transform.shape[0], device=dev) % 2
    own_i = owner == mesh2.coords[0]
    part = {}
    for name, idx in (("positions", s.vertex_instance),
                      ("tri_vertices", s.tri_instance),
                      ("tri_uv", s.tri_instance),
                      ("tri_face", s.tri_instance),
                      ("instance_transform", None),
                      ("instance_material", None),
                      ("instance_aabb_lo", None),
                      ("instance_aabb_hi", None)):
        a = getattr(s, name)
        if a is None or (s.tri_proto is not None
                         and name in ("positions", "tri_uv", "tri_face")):
            continue
        own = own_i if idx is None else own_i[idx.long()]
        part[name] = torch.where(
            own.reshape(own.shape + (1,) * (a.dim() - 1)), a,
            torch.zeros((), dtype=a.dtype, device=dev))
    merged = multihost.merge_scene_partitions(s.replace(**part), owner,
                                              mesh2)
    for name in part:
        assert torch.equal(getattr(merged, name), getattr(s, name)), name
    out2 = multihost.render_frame_tiled_2d(merged, fp, cas, mesh=mesh2,
                                           samples=0, **kw)
    assert torch.equal(out2["instance_id"], ids_1d)
    with open(f"{out}{rank}.json", "w") as f:
        json.dump(dict(rank=rank, ids_off=ids, borders=min(borders)), f)
    mesh_mod.close(mesh)


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


@pytest.mark.parametrize("case", ["kitchen", "kitchen49k_room", "dense",
                                  "float_atlas"])
def test_sdf_emit_matches_plain_version(case):
    """The ``sdf_emit`` kernel (``csrc/sdf_emit.cu``) bit-equal to the
    plain emit (``sdf_build._emit_blocks``, eager on the same CUDA
    tensors) on every live brick of a card build: the animated kitchen at
    this file's SDF settings; the cells' build, the 49k-face kitchen at
    the room preset (about 95,000 bricks, with no list drop); a dense case
    (1 m cells, whose 27 neighbourhoods hold thousands of candidates, so
    the kernel's key buffer is cut many times a brick); the float atlas
    with 8 triangles a brick.  One launch, no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.ops.sdf import cascade_origin
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    cfg, stage = {
        "kitchen": (SDF, lambda: scenes.kitchen_anim(24, tess=2)),
        "kitchen49k_room": (SDFConfig.preset("room"), CELL_STAGES["static"]),
        "dense": (dataclasses.replace(
            SDF, num_cascades=1, cascade_resolution=16, base_voxel_size=1.0,
            truncation_voxels=1.0, max_triangles_per_brick=32),
            lambda: scenes.kitchen_anim(64, tess=6)),
        "float_atlas": (dataclasses.replace(
            SDF, atlas_u8=False, max_triangles_per_brick=8),
            lambda: scenes.kitchen_anim(24, tess=3)),
    }[case]
    r = Renderer(RenderConfig(width=64, height=64, sdf=cfg), device="cuda")
    r.load_stage(stage())
    r.ensure_cascades()
    assert r.list_overflow == 0 or case != "kitchen49k_room"
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


#: the benchmark's two cells (``perfbench/configs``): the 49k-face kitchen
#: at 1920x1080 and the room preset, static, and with one prop moving on
#: a 0.03 m circle, one turn every 9 time codes
CELL_STAGES = {
    "static": lambda: scenes.kitchen_stress(num_objects=256, seed=7, tess=4),
    "anim": lambda: scenes.kitchen_anim(num_objects=256, seed=7, tess=4,
                                        radius=0.03, period=9)}


def _cell_renderer(stage):
    from vri_tpu_torch.renderer import Renderer

    _card()
    r = Renderer(RenderConfig(width=1920, height=1080,
                              sdf=SDFConfig.preset("room")), device="cuda")
    r.load_stage(CELL_STAGES[stage]())
    return r


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
    r.load_stage(CELL_STAGES["anim"]())
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


# -- the temporal frame's history stage ----------------------------------------

#: case -> the frame's rows, columns and gi_scale, the previous camera's
#: offset in pixels (x, y), and optionally a band (first row, the whole
#: frame's rows), ghost rows of history above and below, points behind
#: the previous camera, NaN and inf history rows.  122 GI columns: i /
#: 122 and i * (1 / 122) floor apart on some pixels; one GI column: every
#: tap reads the wrap pair of the plain version's roll
HISTORY_CASES = {
    "scale1": dict(h=48, w=122, s=1, move=(0.3, 0.2)),
    "scale2": dict(h=48, w=64, s=2, move=(1.6, -0.7)),
    "band": dict(h=32, w=64, s=2, move=(0.6, 2.3), band=(32, 96)),
    "halo2": dict(h=32, w=64, s=2, move=(0.4, 1.7), band=(32, 96), halo=2),
    "off_screen": dict(h=48, w=64, s=2, move=(9.0, -6.0), behind=0.1),
    "last_column_row": dict(h=48, w=64, s=2, move=(0.45, 0.45)),
    "one_column": dict(h=16, w=1, s=1, move=(0.2, 0.3)),
    "nonfinite": dict(h=48, w=64, s=2, move=(0.5, 0.5), nonfinite=True),
    "cell1080": dict(h=1080, w=1920, s=2, move=(0.35, 0.15)),
}


def _history_case(case, device):
    """(the wrapper's tensors, its keywords) for ``HISTORY_CASES[case]``:
    world points on the plane z = 0 under the current camera's pixels (one
    in ten raised towards it, a depth edge), a history written by a camera
    panned by ``move`` pixels (its depth the plane's, half of it up to 4%
    off, about the depth test's tolerance, 15% of its rows disoccluded, a
    count of 0 to 16), 5% of the normals flipped and 5% of the pixels
    invalid."""
    from vri_tpu_torch.hydra.camera import make_camera

    c = HISTORY_CASES[case]
    h, w, s, halo = c["h"], c["w"], c["s"], c.get("halo", 0)
    y0, full = c.get("band", (0, h))
    hs, ws = h // s, w // s
    rng = np.random.default_rng(list(HISTORY_CASES).index(case))
    step = 2.0 * np.tan(np.radians(22.5)) * 3.0 / full    # a pixel at z = 0
    mx, my = c["move"]
    eye_b = np.float32([0.0, 0.0, 3.0])
    eye_a = eye_b + np.float32([mx * step, -my * step, 0.0])
    cam_b = make_camera(eye_b, eye_b * [1, 1, 0], 45.0, w / full)
    cam_a = make_camera(eye_a, eye_a * [1, 1, 0], 45.0, w / full)

    def on_plane(cam, rows, cols):
        y, x = np.meshgrid(rows, cols, indexing="ij")
        ndc = np.stack([(x + 0.5) / w * 2 - 1, 1 - (y + 0.5) / full * 2],
                       -1)
        inv = np.linalg.inv(cam.view_proj.astype(np.float64))
        q = np.concatenate([ndc.reshape(-1, 2), np.full((ndc.size // 2, 1),
                                                        0.5),
                            np.ones((ndc.size // 2, 1))], 1) @ inv.T
        d = q[:, :3] / q[:, 3:] - cam.eye
        return cam.eye + d * (-cam.eye[2] / d[:, 2:])

    pos = on_plane(cam_b, np.arange(y0, y0 + h), np.arange(w))
    pos = pos.astype(np.float32)
    edge = rng.random(h * w) < 0.1
    pos[edge] += (eye_b - pos[edge]) * 0.3
    if c.get("behind"):
        pos[rng.random(h * w) < c["behind"], 2] = 4.0
    nrm = np.float32([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.2, (h * w, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[rng.random(h * w) < 0.05] *= -1.0
    nrm = nrm.astype(np.float32)
    valid = rng.random(h * w) > 0.05
    sub = (np.arange(0, h, s)[:, None] * w + np.arange(0, w, s)).reshape(-1)

    rows = np.arange(y0 // s - halo, y0 // s + hs + halo) * s
    p_a = on_plane(cam_a, rows, np.arange(0, w, s))
    m = len(p_a)
    data = np.zeros((m, 8), np.float32)
    data[:, 0:3] = rng.random((m, 3))
    data[:, 3] = np.linalg.norm(p_a - cam_a.eye, axis=-1)
    data[:, 3] *= 1.0 + (rng.random(m) < 0.5) * rng.uniform(0.0, 0.04, m)
    data[rng.random(m) < 0.15, 3] *= 1.3
    data[:, 4:7] = nrm[rng.integers(0, h * w, m)]
    data[:, 7] = rng.integers(0, 17, m)
    if c.get("nonfinite"):
        k = rng.choice(m, 6, replace=False)
        data[k[:3]] = np.nan
        data[k[3:], :4] = np.inf
    depth = np.linalg.norm(pos - eye_b, axis=-1).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    args = (t(data), t(cam_a.view_proj.astype(np.float32)), t(cam_a.eye),
            t(pos[sub]), t(nrm[sub]), t(valid[sub]),
            t(rng.random((hs * ws, 3), np.float32)), t(depth), t(eye_b),
            t(rng.random((h * w, 3), np.float32)
              * (rng.random((h * w, 1)) < 0.1)),
            t(rng.random((h * w, 3), np.float32)),
            t(rng.random((h * w, 3), np.float32)), t(valid))
    kw = dict(height=h, width=w, gi_scale=s, history_cap=16.0, y0=y0 // s,
              proj_height=full // s if "band" in c else None, halo=halo)
    return args, kw


def _same(a, b):
    """Equal, NaN where the other is NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_temporal_history_matches_plain_version(case):
    """``frame.temporal_history`` (``csrc/temporal.cu``) against its plain
    version on the same CUDA tensors: colour, frame count and new history
    bit-equal (a NaN where the plain version has one) at ``gi_scale`` 1
    and 2, on a band, on a history with two ghost rows a side, under a
    camera move that sends taps off the screen and behind the camera, at
    the last column and row, on one GI column, through NaN and inf history
    rows, and at the static cell's 1920x1080; each launch counted once,
    its outputs fresh and its inputs, the history included, unchanged."""
    from vri_tpu_torch.passes import frame as frame_mod

    _card()
    args, kw = _history_case(case, "cuda")
    before = [a.clone() for a in args]
    launches = frame_mod.temporal_history.launches
    got = frame_mod.temporal_history(*args, **kw)
    assert frame_mod.temporal_history.launches == launches + 1
    want = frame_mod.temporal_history_reference(*args, **kw)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and _same(g, w), (case, k)
    for a, b in zip(args, before):
        assert torch.equal(a, b) or _same(a, b)
    assert all(g.data_ptr() != a.data_ptr() for g in got for a in args)
    kept = want[1] > 1.0
    if case == "nonfinite":
        assert bool(torch.isnan(want[0]).any())
    elif case not in ("off_screen", "one_column"):
        assert float(kept.float().mean()) > 0.3, case


# -- whole frames and paths, every launch held on its own inputs -----------------

def _copy(x):
    return x.clone() if torch.is_tensor(x) else x


def _run_held(fn):
    """``fn()`` with every kernel's launches counted and each launch of R,
    K6, M, ``bvh_traverse`` and ``temporal_history`` held bit-equal to the
    kernel's plain version on a copy of that launch's own inputs: a
    frame's kernels are held on the inputs the frame builds, and every
    counted launch of those five was recorded and held.  Returns (``fn``'s
    result, {kernel: launches} of the kernels it launched)."""
    from vri_tpu_torch.ops import (bvh, march_kernel, rasterize, sdf_build,
                                   worklist)
    from vri_tpu_torch.passes import frame as frame_mod

    # kernel -> (module, wrapper, plain version: None for those not held)
    table = {"raster_prep": (rasterize, "raster_prep", None),
             "raster_tiles": (rasterize, "raster_tiles",
                              rasterize.raster_tiles_reference),
             "raster_ranged": (rasterize, "raster_ranged",
                               rasterize.raster_ranged_reference),
             "march_rays": (march_kernel, "march_rays",
                            march_kernel.march_rays_reference),
             "bvh_traverse": (bvh, "bvh_traverse",
                              bvh.bvh_traverse_reference),
             "sdf_emit": (sdf_build, "_emit_kernel", None),
             "sdf_update": (sdf_build, "_update_kernel", None),
             "template_walk": (worklist, "template_walk", None),
             "setup_walk": (worklist, "setup_walk", None),
             "grouped_step": (worklist, "grouped_step", None),
             "temporal_history": (frame_mod, "temporal_history",
                                  frame_mod.temporal_history_reference)}
    calls, real = [], {}

    def recorder(name, wrapper):
        def run(*args, **kw):
            inputs = ([_copy(x) for x in args],
                      {k: _copy(v) for k, v in kw.items()})
            out = wrapper(*args, **kw)
            calls.append((name, inputs, [_copy(x) for x in out]))
            return out
        # the wrapper counts its launches on its module's attribute
        run.launches = wrapper.launches
        return run

    for name, (mod, attr, plain) in table.items():
        if plain is not None:
            real[name] = getattr(mod, attr)
            setattr(mod, attr, recorder(name, real[name]))
    before = {n: getattr(m, a).launches for n, (m, a, _) in table.items()}
    try:
        out = fn()
        torch.cuda.synchronize()
        launches = {n: getattr(m, a).launches - before[n]
                    for n, (m, a, _) in table.items()}
    finally:
        for name, wrapper in real.items():
            mod, attr, _ = table[name]
            wrapper.launches = getattr(mod, attr).launches
            setattr(mod, attr, wrapper)
    for name, (args, kw), got in calls:
        kw.pop("visits", None)
        want = table[name][2](*args, **kw)
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (name, k)
    for name in real:
        held = sum(call[0] == name for call in calls)
        assert held == launches[name], (name, held, launches[name])
    return out, {n: c for n, c in launches.items() if c}


def test_every_source_builds_with_its_ptxas_report():
    """Every source under ``csrc/`` builds into its own library, every
    entry point binds, and each library's kept compiler output holds
    ptxas's register and spill lines."""
    import os

    from vri_tpu_torch import _cuda

    _card()
    _cuda.library()
    paths = _cuda.build()
    assert sorted(paths) == sorted(_cuda.SOURCES)
    for src, path in paths.items():
        log = _cuda.compiler_log(src)
        assert os.path.exists(path) and "registers" in log \
            and "spill" in log, src


#: the frame tests' stages: the kitchen at 18,624 faces, past the binned
#: tier's 2^14, so that every frame takes the sorted tier as the 49k
#: kitchen's does, and the Cornell box, which takes the binned tier
STAGES = {"kitchen": lambda: scenes.kitchen_stress(num_objects=96, tess=4),
          "cornell": scenes.cornell_box}
#: case -> (stage, SDF preset (None: this file's SDF), render keywords,
#: launches of the build and two frames).  A sparse build launches one
#: sdf_emit and its bake one march_rays (each stage holds one light); the
#: tiny preset's dense build its bake's march_rays alone; the reference
#: and tiny presets march their GI rays in the trilinear loop.
FRAME_CASES = {
    "gi_sorted": ("kitchen", None, dict(gi=True),
                  dict(raster_prep=2, raster_tiles=2, march_rays=5,
                       sdf_emit=1)),
    "gi_binned": ("cornell", None, dict(gi=True),
                  dict(raster_tiles=2, march_rays=5, sdf_emit=1)),
    "gi_ranged": ("kitchen", None, dict(gi=True, backend="raster_ranged"),
                  dict(raster_ranged=2, march_rays=5, sdf_emit=1)),
    "gi_bvh": ("kitchen", None, dict(gi=True, backend="bvh"),
               dict(march_rays=5, bvh_traverse=2, sdf_emit=1)),
    "gi_reference_preset": ("cornell", "reference", dict(gi=True),
                            dict(raster_tiles=2, march_rays=3, sdf_emit=1)),
    "gi_dense_tiny": ("cornell", "tiny", dict(gi=True),
                      dict(raster_tiles=2, march_rays=3)),
    "direct_raster": ("cornell", None, dict(gi=False),
                      dict(raster_tiles=2)),
    "direct_bvh": ("cornell", None, dict(gi=False, backend="bvh"),
                   dict(bvh_traverse=2)),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_renderer_frames_hold_kernels(case):
    """Two frames of ``Renderer.render`` from a fresh renderer (the first
    builds the cascades) with fixed GI samples, the launches counted
    (``FRAME_CASES``) and every launch of R, K6, M and ``bvh_traverse``
    held on its own inputs: the GI frame through the sorted, binned and
    ranged tiers and the BVH, at the reference preset (eight cascades)
    and the tiny preset (the dense build), and the direct-only frame
    through the raster and the BVH.  Each frame finite, more than half its
    pixels covered, no raster overflow and no SDF list drop; the ranged
    frame equal to the sorted tier's, the direct BVH frame's ids to the
    raster's on at least 99% of the pixels (the BVH culls no back
    face)."""
    from vri_tpu_torch.renderer import Renderer

    _card()
    stage, preset, kw, want = FRAME_CASES[case]
    h, w = (192, 256) if stage == "kitchen" else (128, 128)
    sdf = SDF if preset is None else SDFConfig.preset(preset)
    if kw["gi"]:
        kw = dict(kw, uniforms=torch.rand(
            (1, h * w, 2), generator=torch.Generator().manual_seed(7)).cuda())
    r = Renderer(RenderConfig(width=w, height=h, sdf=sdf), device="cuda")
    r.load_stage(STAGES[stage]())
    frames, launches = _run_held(lambda: [r.render(**kw) for _ in range(2)])
    assert launches == want
    for aovs in frames:
        assert np.isfinite(aovs["color"]).all()
        assert (aovs["instance_id"] >= 0).mean() > 0.5
        assert int(aovs.get("raster_overflow_tiles", 0)) == 0
    assert r.list_overflow == 0
    if kw.get("backend") in ("raster_ranged", "bvh") and kw["gi"]:
        assert "raster_overflow_tiles" not in frames[1]
    if case == "gi_ranged":
        plain = r.render(gi=True, uniforms=kw["uniforms"])
        for key in ("instance_id", "color"):
            np.testing.assert_array_equal(frames[1][key], plain[key])
    if case == "direct_bvh":
        raster = r.render(gi=False)
        assert (frames[1]["instance_id"]
                == raster["instance_id"]).mean() >= 0.99


def test_gi_frame_and_sdf_views_card_match_cpu():
    """The Cornell box at 64^2 at this file's SDF settings, built and
    rendered on the card and on the CPU (the kernels' plain versions) with
    the same GI samples: ``instance_id`` equal on at least 99.9% of the
    pixels and colour within 2e-3 where it is (the eager passes round
    differently on the two devices).  The six SDF debug views on the card
    launch no kernel (the trilinear loop marches them) and give finite
    colour and depth alone; the distance view's hits agree with the CPU's
    on at least 99.9% of the pixels."""
    from vri_tpu_torch.config import DebugMode
    from vri_tpu_torch.renderer import Renderer

    _card()
    u = torch.rand((1, 64 * 64, 2), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        r = Renderer(RenderConfig(width=64, height=64, sdf=SDF), device=dev)
        r.load_stage(scenes.cornell_box())
        out[dev] = (r.render(gi=True, uniforms=u.to(dev)),
                    r.render(mode=DebugMode.SDF_DISTANCE))
    for mode in range(DebugMode.SDF_DISTANCE, DebugMode.SDF_CASCADE_ID + 1):
        view, launches = _run_held(lambda: r.render(mode=mode))
        assert launches == {} and set(view) == {"color", "depth"}, mode
        assert np.isfinite(view["color"]).all(), mode
    (a, view_a), (b, view_b) = out["cpu"], out["cuda"]
    same = a["instance_id"] == b["instance_id"]
    assert same.mean() >= 0.999
    assert np.abs(a["color"] - b["color"]).max(-1)[same].max() <= 2e-3
    hits = [v["depth"] < 1e30 for v in (view_a, view_b)]
    assert (hits[0] == hits[1]).mean() >= 0.999 and hits[1].any()


@pytest.fixture(scope="module")
def city():
    """``bench.py``'s city (4,500 instanced towers, 1.35M faces) packed as
    ``bench.py`` packs it (``lod_levels`` 3, ``lod_min_faces`` 64), at
    1920x1080 on the card: its face pool passes the 2^19 from which the
    raster compacts the frustum-visible faces, and nothing smaller takes
    that branch by itself."""
    _card()
    from vri_tpu_torch import SceneLimits
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    lim = SceneLimits(max_instances=8192, max_vertices=1 << 22,
                      max_faces=1 << 22)
    d = RenderDelegate(RenderConfig(width=1920, height=1080, limits=lim,
                                    lod_levels=3, lod_min_faces=64),
                       device="cuda")
    d.populate(scenes.city_stress(num_buildings=4500, tess=5, num_protos=24))
    scene = d.sync()
    fp = frame_mod.FrameParams.from_camera(d.camera, 1080, device="cuda")
    return scene, bake_world(scene), fp


def _settled(frame):
    """The renderer's ladder: ``frame(caps_scale)`` at 1x, 2x and 4x until
    one reports no overflow; returns that scale."""
    for scale in (1, 2, 4):
        if int(frame(scale).overflow) == 0:
            return scale
    pytest.fail("overflow at 4x capacities")


def test_city_compacted_frame(city):
    """The city at ``lod_tau`` 0 through the raster dispatch with the
    compaction budget ``bench.py`` gives it (2^20 faces): at the
    capacities the ladder settles on, one prep and one R (held on its own
    lists), no overflow, and tri, t, u and v equal to an uncompacted
    sorted raster of the frame."""
    from vri_tpu_torch.ops import rasterize
    from vri_tpu_torch.passes import frame as frame_mod

    scene, world, fp = city
    assert scene.tri_vertices.shape[0] >= frame_mod._CULL_COMPACT_MIN_POOL

    def frame(scale):
        return frame_mod._visibility_raster(
            scene, world, fp, 1080, 1920, caps_scale=scale, lod_tau=0.0,
            compact_cap=1 << 20)

    scale = _settled(frame)
    hit, launches = _run_held(lambda: frame(scale))
    assert launches == dict(raster_prep=1, raster_tiles=1)
    assert int(hit.overflow) == 0 and float((hit.tri >= 0).float().mean()) > 0.5
    full, _ = rasterize.rasterize_sorted(
        world, scene.tri_vertices, scene.num_faces, fp.view_proj,
        height=1080, width=1920, cap=4096, pairs_cap=1 << 22,
        caps_scale=scale, cull_sign=frame_mod._cull_sign(scene))
    assert int(full.overflow) == 0
    for key in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(hit, key), getattr(full, key)), key


def test_city_lod_frame(city):
    """The city at ``lod_tau`` 0.75: the face mask goes to the uncompacted
    sorted tier; at the capacities the ladder settles on, one prep and one
    R (held on its own lists), no overflow, and no face of a level not
    chosen wins a pixel."""
    from vri_tpu_torch.ops import lod
    from vri_tpu_torch.passes import frame as frame_mod

    scene, world, fp = city
    mask, _ = lod.face_mask(scene, fp.eye,
                            1.0 / torch.clamp(fp.pixel_spread, min=1e-8),
                            0.75)
    assert 0 < int(mask.sum()) < int(scene.num_faces_total)

    def frame(scale):
        return frame_mod._visibility_raster(scene, world, fp, 1080, 1920,
                                            caps_scale=scale, lod_tau=0.75)

    scale = _settled(frame)
    hit, launches = _run_held(lambda: frame(scale))
    assert launches == dict(raster_prep=1, raster_tiles=1)
    assert int(hit.overflow) == 0
    assert bool(mask[hit.tri[hit.tri >= 0].long()].all())


#: the orbit of tests/test_torch_temporal.py's flythrough
ORBIT = dict(radius=3.2, height=0.3)


def _clean_frame(r, aovs):
    """A production frame with no raster overflow, no frame fault, no SDF
    list drop and finite colour."""
    assert int(aovs["raster_overflow_tiles"]) == 0
    assert int(aovs["frame_faults"]) == 0
    assert r.list_overflow == 0
    assert bool(torch.isfinite(aovs["color"]).all())


def test_temporal_frame_launches():
    """The static cell's production frame, ``Renderer.render_temporal``
    (``gi_scale`` 2, one sample, the radiance cache, the room preset's
    ``shadow_scale`` 2), on the cells' kitchen at 1920x1080: four frames
    from an empty history after the build, each one prep, one R, two M
    (the shadow rays of the ``shadow_scale`` subsample, the GI rays at GI
    resolution) and one ``temporal_history`` and no other kernel, every
    launch held on its own inputs, ``history.kernel_path`` counted once
    for each frame under a recording, each frame clean
    (:func:`_clean_frame`), and the history equal to the frame count on
    at least 90% of the covered pixels.  Then
    ``render_flythrough(temporal=True, gi_scale=2)`` over a slow orbit of
    the Cornell box: finite colour, and the covered pixels' mean history
    above 1 by the third frame."""
    import dataclasses

    from vri_tpu_torch.hydra.camera import FreeCamera
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.renderer import Renderer
    from vri_tpu_torch.runtime import profiler

    r = _cell_renderer("static")
    r.ensure_cascades(eye=r.camera.eye)
    state = frame_mod.init_temporal(1080, 1920, 2, device="cuda")
    for i in range(4):
        profiler.start_recording()
        try:
            (aovs, state), launches = _run_held(
                lambda: r.render_temporal(state))
        finally:
            spans = profiler.stop_recording()
        assert launches == dict(raster_prep=1, raster_tiles=1, march_rays=2,
                                temporal_history=1)
        frames = {sp.frame for sp in spans if sp.name == "frame"}
        paths = [c.frame for c in profiler.recorded_counts()
                 if c.name == "history.kernel_path"]
        assert len(frames) == 1 and paths == list(frames)
        _clean_frame(r, aovs)
        cov = aovs["instance_id"] >= 0
        kept = (aovs["gi_history"][cov] - (i + 1)).abs() <= 1e-3
        assert float(kept.float().mean()) >= 0.9, i
    cfg = dataclasses.replace(SDF, shadow_scale=2)
    rc = Renderer(RenderConfig(width=64, height=64, sdf=cfg), device="cuda")
    rc.load_stage(scenes.cornell_box())
    fly = rc.render_flythrough(4, FreeCamera(**ORBIT), dt=1.0 / 60.0,
                               temporal=True, gi_scale=2)
    assert all(np.isfinite(f["color"]).all() for f in fly)
    assert fly[2]["gi_history"][fly[2]["instance_id"] >= 0].mean() > 1.0


def test_animated_playback_holds_kernels():
    """The animated cell's playback: its stage through
    ``Renderer.render_temporal(time_code=)`` at 1920x1080 and the room
    preset.  After the build, each of four codes runs the bounded update
    on the card (one ``sdf_update`` pipeline, one ``sdf_emit``), the
    partial re-bake and the temporal frame: one prep, one R, three M (the
    re-bake's shadow rays, the frame's shadow and GI rays) and one
    ``temporal_history`` and no other kernel, every R, M and
    ``temporal_history`` launch held on its own inputs; each frame
    "updated (1 dirty instances)" and clean (:func:`_clean_frame`)."""
    from vri_tpu_torch.passes import frame as frame_mod

    r = _cell_renderer("anim")
    r.ensure_cascades()
    state = frame_mod.init_temporal(1080, 1920, 2, device="cuda")
    for code in (1.0, 2.0, 3.0, 4.0):
        (aovs, state), launches = _run_held(
            lambda: r.render_temporal(state, time_code=code))
        assert launches == dict(raster_prep=1, raster_tiles=1, march_rays=3,
                                sdf_emit=1, sdf_update=1,
                                temporal_history=1), code
        assert r.last_build_label == "updated (1 dirty instances)"
        _clean_frame(r, aovs)


#: tests/test_torch_dynamic.py's ANIM_SDF with 8^3-texel bricks and 64
#: triangles a brick: no near candidate is dropped, so an update or a
#: scroll gives a rebuild's voxels exactly
ANIM_SDF = SDFConfig(
    num_cascades=2, cascade_resolution=32, base_voxel_size=0.1,
    max_bricks=16384, truncation_voxels=2.0, max_triangles_per_brick=64,
    update_cell_cap=2048, update_brick_cap=8192, update_tri_cap=512)


def _animated_renderer():
    from vri_tpu_torch.renderer import Renderer

    r = Renderer(RenderConfig(width=32, height=32, sdf=ANIM_SDF),
                 device="cuda")
    r.load_stage(scenes.animated_stage(num_objects=4))
    return r


def _voxel_equal(a, b, atol: float = 0.0):
    """Occupancy, ESD and atlas per voxel of two cascade sets: with
    ``atol``, the atlas within ``atol`` and one u8 step; without, the atlas
    and albedo equal and the march tables too."""
    ba, bb = a.brick_map.reshape(-1), b.brick_map.reshape(-1)
    occ = ba >= 0
    assert torch.equal(occ, bb >= 0)
    assert torch.equal(torch.where(occ, 0, ba), torch.where(occ, 0, bb))
    ia, ib = ba[occ].long(), bb[occ].long()
    if atol:
        step = a.atlas[ia].float() / 255.0 - b.atlas[ib].float() / 255.0
        assert float(step.abs().max()) <= atol + 1.0 / 255.0
        return
    assert torch.equal(a.atlas[ia], b.atlas[ib])
    assert torch.equal(a.brick_albedo[ia], b.brick_albedo[ib])
    for f in ("march_coarse", "march_fine0", "march_fine1"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_animated_stage_updates_equal_a_rebuild():
    """``animated_stage(num_objects=4)`` through ``render(time_code=t)``
    for t = 0, 4, 8 on the card: rebuilt, then the bounded update twice
    (one ``sdf_update`` pipeline each), and the cascades at t = 8
    voxel-equal to a fresh build there (occupancy, ESD, atlas and albedo
    per voxel, march tables), no near candidate dropped."""
    _card()
    r = _animated_renderer()
    labels, pipelines = [], []
    for t in (0.0, 4.0, 8.0):
        aovs, launches = _run_held(lambda: r.render(gi=True, time_code=t))
        labels.append(r.last_build_label)
        pipelines.append(launches.get("sdf_update", 0))
        assert np.isfinite(aovs["color"]).all()
    assert labels[0] == "rebuilt", labels
    assert all(x.startswith("updated (") for x in labels[1:]), labels
    assert pipelines == [0, 1, 1]
    fresh = _animated_renderer()
    fresh._sdf_cfg_effective = r._sdf_cfg_effective
    fresh.sync(time_code=8.0)
    fresh.ensure_cascades(eye=r.camera.eye)
    assert fresh.last_build_label == "rebuilt"
    assert int(fresh.cascades.near_drop) == 0
    _voxel_equal(r.cascades, fresh.cascades)


def test_scroll_on_card_equals_a_fresh_build():
    """The clipmap scroll on the card: the animated stage's renderer with
    its focus moved by two coarse voxels takes the scroll ("scrolled n
    cascades") without a list drop, and ``scroll_cascades`` there is
    voxel-equal to a fresh build at the new centers (the atlas within 2e-6
    and one u8 step), each cell list nesting in the fresh build's or
    holding it."""
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.registry import bake_world

    _card()
    r = _animated_renderer()
    r.render(gi=True)
    coarse = ANIM_SDF.voxel_size(ANIM_SDF.num_cascades - 1)
    shift = np.asarray([2.0 * coarse, 0.0, 0.0], np.float32)
    r.ensure_cascades(focus=r._cascade_focus + shift)
    assert r.last_build_label.startswith("scrolled "), r.last_build_label
    assert r.list_overflow == 0
    sc = r.scene
    args = (bake_world(sc), sc.tri_vertices, sc.num_faces)
    c0 = sdf_mod.default_centers(ANIM_SDF, np.zeros(3, np.float32),
                                 device="cuda")
    cfg = sdf_build.demand_caps(sc, args[0], c0, ANIM_SDF)
    c1 = sdf_mod.default_centers(cfg, -shift, device="cuda")
    scrolled = tuple(bool(x) for x in (c0 != c1).any(-1).tolist())
    cas0, st0 = sdf_build.build_cascades_binned(*args, c0, config=cfg)
    cas1, st1, nf = sdf_build.scroll_cascades(cas0, st0, c1, *args,
                                              config=cfg, scrolled=scrolled)
    ref, ref_st = sdf_build.build_cascades_binned(*args, c1, config=cfg)
    assert any(scrolled) and int(nf) == 0
    assert int(cas0.near_drop) == 0 and int(ref.near_drop) == 0
    _voxel_equal(cas1, ref, atol=2e-6)
    a, b = st1.cell_tris, ref_st.cell_tris
    for n, cell in (a != b).any(-1).nonzero().tolist():
        sa = set(a[n, cell][a[n, cell] >= 0].tolist())
        sb = set(b[n, cell][b[n, cell] >= 0].tolist())
        assert sa <= sb or sb <= sa, (n, cell)


#: the orbit cell's SDF settings: the room preset with the scroll's
#: brick cap (``update_brick_cap``) raised
ORBIT_SDF = dataclasses.replace(SDFConfig.preset("room"),
                                update_brick_cap=16384)


def test_orbit_playback_holds_kernels():
    """The orbit cell's camera path (``kitchen49k.gi_orbit``): the cells'
    kitchen through ``Renderer.render_temporal(camera=)`` at 1920x1080 and
    the room preset, built at the orbit's first camera, then 12 frames
    along it (0.0838 m a frame), which scroll cascades 0 and 1.  Each
    frame: one prep, one R, two M (the frame's shadow and GI rays) and a
    third where the frame scrolled (the bake after it), one
    ``temporal_history``, no ``sdf_update``, and one ``sdf_emit`` for each
    cascade axis that moved a cell and had bricks to emit (the entering
    cells and the edge layers beside them, one emit); every launch held on
    its own inputs, ``history.kernel_path`` counted once, no scroll fallen
    back to a build (``sdf_scroll.rebuilds``), each cascade's center that
    of the frame's focus, the frame clean (:func:`_clean_frame`).  At the
    end the cascades match a fresh build at their centers: occupancy, ESD
    and albedo equal, the atlas within one u8 step (surviving bricks keep
    texels emitted at an older origin) on all but 1e-4 of the occupied
    voxels (the emit's top-k breaks equal distances by candidate order,
    which bricks a scroll keeps emitted from earlier lists: one voxel of
    121,080 on this path on an H100), and each cell list nesting in the
    fresh build's or holding it."""
    from vri_tpu_torch.hydra.camera import FreeCamera
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer
    from vri_tpu_torch.runtime import profiler

    _card()
    # the orbit cell's SDF (perfbench/configs/kitchen49k-orbit-room-1080p
    # .json): the room preset, the scroll's bricks past the update's cap
    r = Renderer(RenderConfig(width=1920, height=1080, sdf=ORBIT_SDF),
                 device="cuda")
    r.load_stage(CELL_STAGES["static"]())
    orbit = FreeCamera(center=(0.0, 0.6, 0.0), radius=3.2, height=1.8,
                       fov_y_deg=55.0, far=200.0)
    cams = [orbit.at_time(1.0 + n / 30.0, 1920 / 1080) for n in range(13)]
    r.ensure_cascades(eye=cams[0].eye)
    start = r._centers.clone()
    state = frame_mod.init_temporal(1080, 1920, 2, device="cuda")
    scrolls = []
    for cam in cams[1:]:
        before = r._centers.clone()
        profiler.start_recording()
        try:
            (aovs, state), launches = _run_held(
                lambda: r.render_temporal(state, camera=cam))
        finally:
            spans = profiler.stop_recording()
        recorded = profiler.recorded_counts()
        counts = {}
        for c in recorded:
            counts[c.name] = counts.get(c.name, 0) + c.value
        axes = int((r._centers != before).sum())
        emits = [c.value for c in recorded if c.name == "sdf_scroll.bricks"]
        print(f"{axes} axes scrolled, bricks an emit {emits}, {launches}")
        assert len(emits) == axes
        want = dict(raster_prep=1, raster_tiles=1,
                    march_rays=2 + (axes > 0), temporal_history=1)
        if any(emits):
            want["sdf_emit"] = sum(e > 0 for e in emits)
        assert launches == want, (launches, emits)
        frames = {sp.frame for sp in spans if sp.name == "frame"}
        paths = [c.frame for c in recorded if c.name == "history.kernel_path"]
        assert len(frames) == 1 and paths == list(frames)
        assert counts.get("sdf_scroll.rebuilds", 0) == 0, counts
        assert not r.last_build_label.startswith("rebuilt")
        cfg = r._sdf_cfg_effective or r.config.sdf
        assert torch.equal(r._centers, sdf_mod.default_centers(
            cfg, r._focus(cam.eye), device="cpu"))
        assert torch.equal(r.cascades.center.cpu(), r._centers)
        _clean_frame(r, aovs)
        scrolls.append(launches.get("sdf_emit", 0))
    moved = (r._centers != start).any(-1)
    print(f"emit launches a frame {scrolls}; cascades moved "
          f"{moved.int().tolist()}")
    assert bool(moved[0]) and bool(moved[1])
    sc = r.scene
    ref, ref_st = sdf_build.build_for_scene(sc, bake_world(sc),
                                            r.cascades.center, cfg)
    assert int(ref_st.list_overflow) == 0
    ba, bb = r.cascades.brick_map.reshape(-1), ref.brick_map.reshape(-1)
    occ = ba >= 0
    assert torch.equal(occ, bb >= 0)
    assert torch.equal(torch.where(occ, 0, ba), torch.where(occ, 0, bb))
    ia, ib = ba[occ].long(), bb[occ].long()
    assert torch.equal(r.cascades.brick_albedo[ia], ref.brick_albedo[ib])
    steps = (r.cascades.atlas[ia].float() - ref.atlas[ib].float()).abs()
    past = int((steps.reshape(ia.shape[0], -1).max(1).values > 1).sum())
    print(f"{past} of {ia.shape[0]} voxels past one u8 step")
    assert past <= 1e-4 * ia.shape[0]
    a, b = r._build_state.cell_tris, ref_st.cell_tris
    cells = (a != b).any(-1).nonzero()
    a, b = (x[cells[:, 0], cells[:, 1]].cpu() for x in (a, b))
    for sa, sb in zip(a, b):
        sa, sb = set(sa[sa >= 0].tolist()), set(sb[sb >= 0].tolist())
        assert sa <= sb or sb <= sa


def _moved_smallest(scene, off):
    """The scene with its smallest instance moved by ``off``, that
    instance's triangles, and its old and new boxes as dirty boxes (4, 3)
    (the others dead)."""
    ni = int(scene.num_instances)
    k = int((scene.instance_aabb_hi - scene.instance_aabb_lo)[:ni]
            .amax(-1).argmin())
    off = torch.tensor(off, device=scene.instance_transform.device)
    tf = scene.instance_transform.clone()
    tf[k, :3, 3] += off
    dlo = torch.full((4, 3), 3.0e38, device=off.device)
    dhi = torch.full((4, 3), -3.0e38, device=off.device)
    dlo[0], dhi[0] = scene.instance_aabb_lo[k], scene.instance_aabb_hi[k]
    dlo[1], dhi[1] = dlo[0] + off, dhi[0] + off
    return (scene.replace(instance_transform=tf), scene.tri_instance == k,
            dlo, dhi)


def test_band_frames_hold_kernels(frame):
    """Bands of the kitchen fixture's frame, rows [64, 128) of 192, on
    cascades built around the room's center (the stage camera's focus
    leaves the moved prop outside the finest cascade): the temporal band
    frame (``gi_scale`` 2) launches one R, two M and one
    ``temporal_history``, each held on its own inputs, and its ids and
    depth (rtol 1e-5) differ from the same rows of the full temporal frame
    on at most 0.5% of the pixels; the dynamic band frame (the smallest
    prop moved by 0.03) re-emits bricks with one ``sdf_update`` pipeline
    and one ``sdf_emit`` and launches one R, three M (the re-bake's shadow
    rays, the band's shadow and GI rays) and one ``temporal_history``,
    each R, M and ``temporal_history`` held, and needs no rebuild."""
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.passes import frame as frame_mod

    r, fp, world = frame
    centers = sdf_mod.default_centers(SDF, np.zeros(3), device="cuda")
    cas, st = sdf_build.build_for_scene(r.scene, world, centers, SDF)
    cas = sdf_mod.bake_brick_lighting(cas, r.scene, config=SDF,
                                      alive=st.alive)
    y0, band, full, w = 64, 64, 192, 256
    kw = dict(width=w, config=SDF, use_cache=True, gi_scale=2)
    gen = torch.Generator(device="cuda").manual_seed(25)
    (aovs, _), launches = _run_held(lambda: frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, frame_mod.init_temporal(band, w, 2, device="cuda"),
        height=band, band=(y0, full), generator=gen, **kw))
    assert launches == dict(raster_tiles=1, march_rays=2, temporal_history=1)
    whole, _ = frame_mod.render_frame_gi_temporal(
        r.scene, fp, cas, frame_mod.init_temporal(full, w, 2, device="cuda"),
        height=full, generator=gen, **kw)
    ids, dep = whole["instance_id"][y0:y0 + band], whole["depth"][y0:y0 + band]
    differ = (aovs["instance_id"] != ids) | (
        (ids >= 0) & ((aovs["depth"] - dep).abs() > 1e-5 * dep.abs()))
    assert float(differ.float().mean()) <= 0.005
    moved = _moved_smallest(r.scene, (0.03, 0.0, 0.0))
    out, launches = _run_held(lambda: frame_mod.render_frame_gi_dynamic(
        moved[0], fp, cas, st,
        frame_mod.init_temporal(band, w, 2, device="cuda"), *moved[1:],
        height=band, band=(y0, full), generator=gen, **kw))
    assert launches == dict(raster_tiles=1, march_rays=3, sdf_emit=1,
                            sdf_update=1, temporal_history=1)
    assert int(out[3].emit_bricks.sum()) > 0 and int(out[4]) == 0
    assert bool(torch.isfinite(out[0]["color"]).all())


def test_scene_cache_round_trip_on_card(frame, tmp_path):
    """The kitchen fixture's scene saved to the scene cache and loaded into
    a fresh renderer on the card: every field equal (positions within one
    uint16 step of the scene's extent, uvs within float16 rounding,
    textures within one u8 step: the cache's quantisations), the loaded
    scene's GI frame with the same cascades and samples agreeing on at
    least 99.5% of the ids, and ``validate_scene`` finding no error."""
    import dataclasses

    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.renderer import Renderer
    from vri_tpu_torch.runtime import checks

    r, fp, _ = frame
    path = str(tmp_path / "scene.npz")
    r.save_cache(path)
    r2 = Renderer(RenderConfig(width=256, height=192, sdf=SDF),
                  device="cuda")
    r2.load_cache(path, camera=r.camera)
    a, b = r.scene, r2.scene
    step = float((a.positions.amax(0) - a.positions.amin(0)).max()) / 65535.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "mip_atlas":
            continue
        if not torch.is_tensor(x):
            assert x == y, f.name
            continue
        assert y.is_cuda and x.shape == y.shape and x.dtype == y.dtype, f.name
        if x.numel() == 0:
            continue
        if f.name == "positions":
            assert float((x - y).abs().max()) <= 1.01 * step
        elif f.name == "tri_uv":
            assert bool(((x - y).abs() <= 2.0 ** -11
                         * torch.clamp(x.abs(), min=1.0)).all())
        elif f.name == "textures":
            assert float((x - y).abs().max()) <= 1.0 / 255.0 + 1e-6
        else:
            assert torch.equal(x, y), f.name
    u = torch.rand((1, 192 * 256, 2), generator=torch.Generator()
                   .manual_seed(27)).cuda()
    kw = dict(height=192, width=256, config=SDF, use_cache=True, uniforms=u)
    fa = frame_mod.render_frame_gi(a, fp, r.ensure_cascades(), **kw)
    fb = frame_mod.render_frame_gi(b, fp, r.ensure_cascades(), **kw)
    same = (fa["instance_id"] == fb["instance_id"]).float().mean()
    assert float(same) >= 0.995 and bool(torch.isfinite(fb["color"]).all())
    assert not [x for x in checks.validate_scene(a) if x.severity == "error"]


#: case -> the app's arguments after ``--out DIR`` and the PNGs it writes
APP_CASES = {
    "sdf_tiny": (["--builtin", "cornell", "--sdf", "tiny"], 1),
    "cache": (["--builtin", "cornell", "--cache", "CACHE"], 1),
    "trace": (["--builtin", "cornell", "--sdf", "tiny", "--trace", "TRACE"],
              1),
    "animated": (["--builtin", "animated", "--frames", "4"], 4),
    "lod": (["--builtin", "kitchen", "--lod", "3"], 1),
}


@pytest.mark.parametrize("case", list(APP_CASES))
def test_app_on_card(case, tmp_path, monkeypatch):
    """``python -m vri_tpu_torch.app`` on the card at 128^2: the tiny
    preset; ``--cache`` written, then read with no stage load; ``--trace``,
    whose Chrome trace holds the program's ``frame``, ``visibility`` and
    ``gbuffer`` spans and kernel R's and M's CUDA functions, with
    ``device_memory_stats`` reporting ``cuda:0``; the animated builtin's
    four frames; the kitchen with three LOD levels.  Each run exits 0 with
    its PNGs."""
    import glob
    import json
    import os

    from vri_tpu_torch import app
    from vri_tpu_torch import renderer as renderer_mod
    from vri_tpu_torch.runtime import profiler

    _card()
    extra, n_png = APP_CASES[case]
    cache, trace = str(tmp_path / "scene.npz"), str(tmp_path / "trace")
    extra = [cache if x == "CACHE" else trace if x == "TRACE" else x
             for x in extra]
    loads = []
    real = renderer_mod.Renderer.load_stage
    monkeypatch.setattr(renderer_mod.Renderer, "load_stage",
                        lambda self, *a: loads.append(a) or real(self, *a))
    runs = 2 if case == "cache" else 1
    for i in range(runs):
        out = str(tmp_path / f"out{i}")
        assert app.main(["--width", "128", "--height", "128", "--out", out,
                         *extra]) == 0
        assert len(glob.glob(os.path.join(out, "*.png"))) == n_png
    assert len(loads) == 1
    if case == "cache":
        assert os.path.exists(cache)
    if case == "trace":
        (path,) = glob.glob(os.path.join(trace, "*.json"))
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert {"frame", "visibility", "gbuffer"} <= names
        for kernel in ("raster_tiles_kernel", "march_rays_kernel"):
            assert any(kernel in n for n in names), kernel
        assert "cuda:0" in profiler.device_memory_stats()


if __name__ == "__main__" and sys.argv[1:2] == ["--gloo-rank"]:
    _gloo_rank(sys.argv[2])
