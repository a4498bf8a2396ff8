"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests import no JAX; ``tests/conftest.py`` does, so on a
machine without JAX run them without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Each builds the stage (or the work list) with the port itself, runs one
kernel (raster_tiles, raster_ranged, march_rays, bvh_traverse, and the
work-list kernels template_walk, setup_walk, grouped_step) on CUDA tensors
and its plain version on the same tensors, and requires exact equality: the kernels are built with -fmad=false and follow their plain
versions' operation order, so every output agrees bit for bit.  On a host
without a card every test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vri_tpu_torch import RenderConfig, SDFConfig, scenes  # noqa: E402

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


@pytest.mark.parametrize("w", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", ["draws", "triangles"])
def test_grouped_step_matches_plain_version(w, kind):
    from vri_tpu_torch.ops import worklist

    _card()
    wc, chunks = worklist.grouped_inputs(96, num_chunks=64, seed=4)
    if kind == "triangles":
        chunks = _triangle_templates(np.random.default_rng(5), 64, 128, 8,
                                     tiles=1)
        # the constant at the tile origin (0, 0), as the grouped prep bakes
        chunks[:, 2] = chunks[:, 2] - chunks[:, 0] * chunks[:, 3] \
            - chunks[:, 1] * chunks[:, 4]
    args = _cuda_tensors(wc, chunks)
    got = worklist.grouped_step(*args, w=w)
    torch.cuda.synchronize()
    want = worklist.grouped_step_reference(*args, w=w)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
