"""The port's scene packing against ``vri_tpu.registry``.

The registry's host-side numpy packing exists in two copies, the JAX
package's and the port's; this file keeps them equal.  Tolerances:

* every SceneBuffers field equal exactly (dtype, shape and value), the JAX
  package's packing carried across with ``scene_from_numpy`` against the
  port's own sync: the packing is the same numpy code;
* ``bake_world`` within rtol 1e-6: the reference contracts the transform
  with XLA, the port with explicit products (a few float32 ulps).

The last test proves that the port never imports JAX: a fresh interpreter
where ``import jax`` fails renders the Cornell box on the CPU.
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

from vri_tpu.config import RenderConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate as JaxDelegate  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.hydra.delegate import RenderDelegate  # noqa: E402
from vri_tpu_torch.registry import (TENSOR_FIELDS, bake_world,  # noqa: E402
                                    scene_from_numpy)

STAGES = {"cornell": scenes.cornell_box,
          "kitchen16": lambda: scenes.kitchen_stress(num_objects=16)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=list(STAGES))
def scenes_pair(request):
    cfg = RenderConfig(width=32, height=32)
    jd = JaxDelegate(cfg)
    jd.populate(STAGES[request.param]())
    js = jd.sync()
    td = RenderDelegate(cfg, device="cpu")
    td.populate(STAGES[request.param]())
    return js, td.sync()


def test_scene_from_numpy_equals_port_sync(scenes_pair):
    js, ts = scenes_pair
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)
              if f.name != "mip_atlas" and getattr(js, f.name) is not None}
    arrays["base_pool_len"] = js.base_pool_len
    carried = scene_from_numpy(arrays, "cpu")
    for name in TENSOR_FIELDS:
        a, b = getattr(carried, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(js, name)))
    assert carried.base_pool_len == ts.base_pool_len == js.base_pool_len
    for name in ("flat", "offsets", "sizes"):
        np.testing.assert_array_equal(
            getattr(ts.mip_atlas, name).numpy(),
            np.asarray(getattr(js.mip_atlas, name)))


def test_bake_world(scenes_pair):
    js, ts = scenes_pair
    np.testing.assert_allclose(bake_world(ts).numpy(),
                               np.asarray(jbake_world(js)), rtol=1e-6,
                               atol=1e-6)


def test_base_view_is_identity_without_lod(scenes_pair):
    _, ts = scenes_pair
    assert ts.base_view() is ts


def test_port_never_imports_jax():
    code = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
from vri_tpu.config import RenderConfig, SDFConfig
from vri_tpu.usd import scenes
from vri_tpu_torch.renderer import Renderer
cfg = SDFConfig(num_cascades=2, cascade_resolution=16, max_bricks=4096,
                base_voxel_size=0.15, truncation_voxels=1.0,
                max_triangles_per_brick=16, approx_occlusion=True)
r = Renderer(RenderConfig(width=32, height=32, sdf=cfg), device="cpu")
r.load_stage(scenes.cornell_box())
out = r.render(gi=True)
assert np.isfinite(out["color"]).all()
assert (out["instance_id"] >= 0).mean() > 0.9
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
               for m, v in sys.modules.items() if v is not None)
print("rendered without jax")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rendered without jax" in out.stdout


def test_texture_sampling_matches_reference():
    """Mip atlas + trilinear / bilinear sampling with ray-cone LOD against
    ``vri_tpu.ops.texture`` on random textures (float32 arithmetic in the
    same order; atol 1e-5)."""
    import jax.numpy as jnp

    from vri_tpu.ops import shading as jshading
    from vri_tpu.ops import texture as jtex
    from vri_tpu_torch.ops import shading as tshading
    from vri_tpu_torch.ops import texture as ttex

    rng = np.random.default_rng(5)
    tex = rng.random((3, 16, 16, 4), dtype=np.float32)
    n = 500
    slot = rng.integers(-1, 4, n).astype(np.int32)
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1, 6, n).astype(np.float32)
    ja, ta = jtex.build_mip_atlas(jnp.asarray(tex)), \
        ttex.build_mip_atlas(torch.as_tensor(tex))
    np.testing.assert_allclose(ta.flat.numpy(), np.asarray(ja.flat),
                               atol=1e-6)
    np.testing.assert_allclose(
        ttex.sample_trilinear(ta, torch.as_tensor(slot), torch.as_tensor(uv),
                              torch.as_tensor(lod)).numpy(),
        np.asarray(jtex.sample_trilinear(ja, jnp.asarray(slot),
                                         jnp.asarray(uv), jnp.asarray(lod))),
        atol=1e-5)
    np.testing.assert_allclose(
        tshading.sample_texture_bilinear(torch.as_tensor(tex),
                                         torch.as_tensor(slot),
                                         torch.as_tensor(uv)).numpy(),
        np.asarray(jshading.sample_texture_bilinear(
            jnp.asarray(tex), jnp.asarray(slot), jnp.asarray(uv))),
        atol=1e-5)
