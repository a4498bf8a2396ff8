"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests import no JAX; ``tests/conftest.py`` does, so on a
machine without JAX run them without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Each builds the stage with the port itself, runs one kernel on CUDA
tensors and its plain version on the same tensors, and requires exact
equality: the kernels are built with -fmad=false and follow their plain
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
