"""The port's scene packing against ``vri_tpu.registry``.

The registry's host-side numpy packing exists in two copies, the JAX
package's and the port's; this file keeps them equal.  Tolerances:

* every SceneBuffers field equal exactly (dtype, shape and value), the JAX
  package's packing carried across with ``scene_from_numpy`` against the
  port's own sync: the packing is the same numpy code;
* ``bake_world`` within rtol 1e-6: the reference contracts the transform
  with XLA, the port with explicit products (a few float32 ulps).

``test_port_never_imports_jax`` proves that the port imports neither JAX
nor ``vri_tpu``: a fresh interpreter where both imports fail renders the
Cornell box on the CPU.  The port's host modules are copies of
``vri_tpu``'s (``config``, ``usd``, ``hydra.{camera,material,meshutil}``,
``utils``); the builtin stages of both copies export identical ``.usda``
text and read back, from ``.usda`` and ``.usdc``, to equal prims.
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

import vri_tpu_torch  # noqa: E402
from vri_tpu.config import RenderConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate as JaxDelegate  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import Stage, scenes  # noqa: E402
from vri_tpu_torch.hydra.delegate import RenderDelegate  # noqa: E402
from vri_tpu_torch.registry import (TENSOR_FIELDS, bake_world,  # noqa: E402
                                    scene_from_numpy)

#: name -> (builder arguments); each package builds with its own scenes
STAGES = {"cornell": ("cornell_box", {}),
          "kitchen16": ("kitchen_stress", {"num_objects": 16})}
#: the builtin stages of the copy-parity tests
BUILTINS = dict(STAGES, city_small=("city_stress", {"num_buildings": 16,
                                                    "tess": 2,
                                                    "num_protos": 4}))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stage(pkg_scenes, name: str, table=STAGES):
    builder, kw = table[name]
    return getattr(pkg_scenes, builder)(**kw)


@pytest.fixture(scope="module", params=list(STAGES))
def scenes_pair(request):
    jd = JaxDelegate(RenderConfig(width=32, height=32))
    jd.populate(_stage(scenes, request.param))
    js = jd.sync()
    td = RenderDelegate(vri_tpu_torch.RenderConfig(width=32, height=32),
                        device="cpu")
    td.populate(_stage(vri_tpu_torch.scenes, request.param))
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
sys.modules["vri_tpu"] = None
import numpy as np
from vri_tpu_torch import RenderConfig, SDFConfig, scenes
from vri_tpu_torch.renderer import Renderer
from vri_tpu_torch.ops import worklist
from vri_tpu_torch.tools import (kernel_turns, micro_attrib, micro_grouped,
                                 micro_pass1, micro_steps, micro_worklist,
                                 prof_worklist)
cfg = SDFConfig(num_cascades=2, cascade_resolution=16, max_bricks=4096,
                base_voxel_size=0.15, truncation_voxels=1.0,
                max_triangles_per_brick=16, approx_occlusion=True)
r = Renderer(RenderConfig(width=32, height=32, sdf=cfg), device="cpu")
r.load_stage(scenes.cornell_box())
for kw in ({"gi": True}, {"gi": True, "backend": "bvh"}, {"gi": False}):
    out = r.render(**kw)
    assert np.isfinite(out["color"]).all()
    assert (out["instance_id"] >= 0).mean() > 0.9
import torch
wl = [torch.as_tensor(x) for x in worklist.steps_inputs(8, num_tiles=4,
                                                       num_chunks=2)]
z, slot = worklist.template_walk(*wl, num_tiles=4, packed=True)
assert z.shape == (4, 1024) and slot.dtype == torch.int32
loaded = [m for m, v in sys.modules.items() if v is not None]
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
               for m in loaded)
assert not any(m == "vri_tpu" or m.startswith("vri_tpu.") for m in loaded)
print("rendered without jax and vri_tpu")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rendered without jax and vri_tpu" in out.stdout


def _canon(v):
    """A comparable form of an attribute value or metadata entry: arrays
    as (dtype, shape, bytes), values of the copies' own classes (asset
    paths, path references) as their class name and fields."""
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, dict):
        return ("dict", tuple(sorted((str(k), _canon(x))
                                     for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_canon(x) for x in v))
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, tuple(_canon(getattr(v, f.name))
                                        for f in dataclasses.fields(v)))
    return v


def _prims(stage):
    """Every prim of a stage in traversal order, canonicalized."""
    return [(p.path, p.type_name, p.specifier, _canon(p.metadata),
             tuple((n, a.type_name, a.uniform, a.custom, a.connect,
                    _canon(a.value), _canon(a.metadata))
                   for n, a in sorted(p.attributes.items())))
            for p in stage.root.traverse()]


@pytest.mark.parametrize("name", list(BUILTINS))
def test_host_copies_agree(name, tmp_path):
    """Each builtin stage from both copies exports identical ``.usda``
    text; the file read back by both parsers gives equal prims; a
    ``.usdc`` written by the port's crate writer is byte-equal to the
    reference's and reads back, through both readers, to equal prims."""
    from vri_tpu_torch.usd import Stage as TStage

    js = _stage(scenes, name, BUILTINS)
    ts = _stage(vri_tpu_torch.scenes, name, BUILTINS)
    text = ts.export()
    assert text == js.export()
    path = tmp_path / f"{name}.usda"
    path.write_text(text)
    jr, tr = Stage.open(str(path)), TStage.open(str(path))
    assert _prims(tr) == _prims(jr)
    jc, tc = tmp_path / "ref.usdc", tmp_path / "port.usdc"
    js.save(str(jc))
    ts.save(str(tc))
    assert tc.read_bytes() == jc.read_bytes()
    back = TStage.open(str(tc))
    assert _prims(back) == _prims(Stage.open(str(tc)))
    assert back.export() == Stage.open(str(jc)).export()


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
