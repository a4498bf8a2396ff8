"""The port's cell-binned SDF build against ``vri_tpu.ops.sdf_build``.

Both sides build the Cornell box from the same packed scene, after their
own ``demand_caps`` pass.  Tolerances, and why:

* demand caps, ``brick_map``, ``num_bricks``, ``overflow``,
  ``list_overflow`` and ``near_drop`` exactly equal: integer results of
  the same binning, sorting and occupancy tests.
* the u8 atlas within 1 on at most 0.1% of live texels: texel distances
  are float32 point-triangle distances that XLA fuses (contracting
  multiply-adds) and the port evaluates op by op; a value within an ulp
  of a rounding boundary of ``round(d * 255)`` may land one step apart.
* the march tables exactly equal, both as the port packs them from the
  reference's brick map and atlas and as the port's own build packs them
  (its atlas differs on too few texels to move a surface bit).

The r=16 configuration is the one of ``tests/test_march_kernel.py`` with
``truncation_voxels`` lowered to 1, the most the binned builder supports
at one voxel per cell; the r=64 one has 4-voxel cells like the room
preset and starts its list caps low so ``demand_caps`` escalates them.

The crowded cases hold cell lists longer than the JAX package's
512-reference auto-cap ceiling, as the port's own ceiling lets the main
path build the 49k-triangle kitchen (K = 3520): one box tessellated into
768 triangles puts 768 references into its cells.  Both sides get the same
explicit ``cell_list_cap``: 1024 at r=16 keeps every reference, 640 at
r=64 (the room preset's 4-voxel cells) drops 128 through the stratified
subsample.  Among 768 overlapping triangles the k nearest by AABB
distance are near-ties, so an XLA multiply-add contraction moves whole
triangles in or out of a brick's candidate set (texels 19 steps apart, a
flipped brick normal); the JAX side therefore builds these cases in a
subprocess whose XLA:CPU has no fused multiply-add
(``--xla_cpu_max_isa=AVX``), and every result, the atlas and the brick
payload included, must be exactly equal.
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
from vri_tpu.config import RenderConfig, SDFConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.ops import sdf as jsdf  # noqa: E402
from vri_tpu.ops import sdf_build as jbuild  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu.usd.stage import Stage  # noqa: E402
from vri_tpu.usd.usda import Prim  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.ops import sdf_build as tbuild  # noqa: E402
from vri_tpu_torch.registry import bake_world, scene_from_numpy  # noqa: E402

CONFIGS = {
    "r16": SDFConfig(num_cascades=2, cascade_resolution=16, brick_size=8,
                     max_bricks=4096, base_voxel_size=0.15,
                     truncation_voxels=1.0, max_triangles_per_brick=16,
                     march_max_steps=48),
    "r64": SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                     max_bricks=16384, base_voxel_size=0.075,
                     truncation_voxels=3.0, max_triangles_per_brick=16,
                     cell_list_cap=32, global_list_cap=64),
}


CROWDED = {
    "crowded_r16_k1024": dataclasses.replace(
        CONFIGS["r16"], num_cascades=1, max_bricks=1024, cell_list_cap=1024,
        global_list_cap=64),
    "crowded_r64_k640": dataclasses.replace(
        CONFIGS["r64"], num_cascades=1, max_bricks=1024, cell_list_cap=640,
        global_list_cap=64),
}
CASES = [*CONFIGS, *CROWDED]
_CAS_FIELDS = ("num_bricks", "overflow", "near_drop", "brick_map",
               "brick_voxel", "atlas", "brick_albedo", "brick_normal",
               "brick_emissive", "march_coarse", "march_fine0",
               "march_fine1")


def _crowded_stage():
    """One 0.16-wide box of 6 x 8^2 quads (768 triangles)."""
    stage = Stage(Prim(name=""), {"defaultPrim": "World", "metersPerUnit": 1})
    stage.define_prim("/World", "Xform")
    scenes._author_material(stage, "/World/Materials/Red",
                            (0.63, 0.065, 0.05))
    pts, counts, idx, st = scenes.box_mesh((0.16, 0.16, 0.16),
                                           (0.1, 0.05, 0.2), tess=8)
    scenes._author_mesh(stage, "/World/Crowd", pts, counts, idx, st,
                        material="/World/Materials/Red")
    stage._reindex()
    return stage


def _sync(stage):
    """The JAX package's SceneBuffers and the port's copy of them."""
    d = RenderDelegate(RenderConfig(width=32, height=32))
    d.populate(stage)
    s = d.sync()
    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)
              if f.name != "mip_atlas" and getattr(s, f.name) is not None}
    return s, scene_from_numpy(arrays, "cpu")


def _reference_arrays(s, cfg, demand_caps):
    """The JAX build of scene ``s`` as numpy: (config, arrays)."""
    jc, jw = jsdf.default_centers(cfg, np.zeros(3, np.float32)), \
        jbake_world(s)
    if demand_caps:
        cfg = jbuild.demand_caps(s, jw, jc, cfg)
    jcas, jst = jbuild.build_for_scene(s, jw, jc, cfg)
    out = {k: np.asarray(getattr(jcas, k)) for k in _CAS_FIELDS}
    out["list_overflow"] = np.asarray(jst.list_overflow)
    out["demand"] = np.asarray([int(x) for x in jbuild.list_demand(
        jw, s.tri_vertices, s.num_faces, jc, config=cfg)])
    return cfg, out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_sdf_build as T
s, _ = T._sync(T._crowded_stage())
out = {}
for name, cfg in T.CROWDED.items():
    _, ref = T._reference_arrays(s, cfg, demand_caps=False)
    out.update({f"{name}/{k}": v for k, v in ref.items()})
np.savez(sys.argv[1], **out)
"""


def _no_fma_reference(tmp_path_factory):
    """The crowded cases built by an XLA:CPU limited to AVX (no fused
    multiply-add), in its own interpreter because XLA reads its flags
    once."""
    path = tmp_path_factory.mktemp("no_fma_build") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))
    return {name: {k.split("/", 1)[1]: v for k, v in ref.items()
                   if k.startswith(name + "/")} for name in CROWDED}


def _port_cfg(cfg):
    """The same SDF configuration in the port's own class."""
    return vri_tpu_torch.SDFConfig(**{f.name: getattr(cfg, f.name)
                                      for f in dataclasses.fields(cfg)})


def _port_build(ts, cfg, demand_caps):
    cfg = _port_cfg(cfg)
    tc = tsdf.default_centers(cfg, np.zeros(3, np.float32), device="cpu")
    tw = bake_world(ts)
    if demand_caps:
        cfg = tbuild.demand_caps(ts, tw, tc, cfg)
    tcas, tst = tbuild.build_for_scene(ts, tw, tc, cfg)
    demand = tbuild.list_demand(tw, ts.tri_vertices, ts.num_faces, tc,
                                config=cfg)
    return cfg, tcas, tst, demand


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """name -> (reference config, reference arrays, port config, port
    cascades, port build state, port list demand, reference is free of
    contraction)."""
    s, ts = _sync(scenes.cornell_box())
    out = {}
    for name, cfg in CONFIGS.items():
        jcfg, ref = _reference_arrays(s, cfg, demand_caps=True)
        out[name] = (jcfg, ref, *_port_build(ts, cfg, demand_caps=True),
                     False)
    refs = _no_fma_reference(tmp_path_factory)
    _, ts = _sync(_crowded_stage())
    for name, cfg in CROWDED.items():
        out[name] = (cfg, refs[name], *_port_build(ts, cfg, demand_caps=False),
                     True)
    return out


@pytest.mark.parametrize("name", CASES)
def test_counts_and_brick_map_exact(builds, name):
    jcfg, ref, tcfg, tcas, tst, demand, no_fma = builds[name]
    assert (tcfg.cell_list_cap, tcfg.global_list_cap) == \
        (jcfg.cell_list_cap, jcfg.global_list_cap)
    np.testing.assert_array_equal(np.asarray(demand), ref["demand"])
    if name in CROWDED:
        assert ref["demand"][0] > 512
    for field in ("num_bricks", "overflow", "near_drop"):
        assert int(getattr(tcas, field)) == int(ref[field]), field
    assert int(tst.list_overflow) == int(ref["list_overflow"])
    np.testing.assert_array_equal(tcas.brick_map.numpy(), ref["brick_map"])
    np.testing.assert_array_equal(tcas.brick_voxel.numpy(),
                                  ref["brick_voxel"])
    if no_fma:
        for field in ("brick_albedo", "brick_normal", "brick_emissive"):
            np.testing.assert_array_equal(getattr(tcas, field).numpy(),
                                          ref[field])


@pytest.mark.parametrize("name", CASES)
def test_atlas_within_one_step(builds, name):
    _, ref, _, tcas, _, _, no_fma = builds[name]
    nb = int(ref["num_bricks"])
    diff = np.abs(tcas.atlas.numpy()[:nb].astype(np.int32)
                  - ref["atlas"][:nb].astype(np.int32))
    print(f"{name}: {int((diff > 0).sum())} of {diff.size} live texels "
          f"differ (max {int(diff.max())})")
    # without contraction on the JAX side the atlas is bit-equal
    assert diff.max() <= (0 if no_fma else 1)
    assert (diff > 0).mean() <= 1e-3
    # dead slots hold the constant far value
    assert (tcas.atlas.numpy()[nb:] == 255).all()


@pytest.mark.parametrize("name", CASES)
def test_march_tables_exact(builds, name):
    jcfg, ref, _, tcas, _, _, _ = builds[name]
    packed = tsdf.build_march_tables(
        torch.as_tensor(np.array(ref["brick_map"])),
        torch.as_tensor(np.array(ref["atlas"])), config=_port_cfg(jcfg))
    for key, got in zip(("march_coarse", "march_fine0", "march_fine1"),
                        packed):
        np.testing.assert_array_equal(got.numpy(), ref[key])
        np.testing.assert_array_equal(getattr(tcas, key).numpy(), ref[key])


def test_supports_matches_reference():
    for cfg in (*CONFIGS.values(), SDFConfig.preset("room"),
                SDFConfig(cascade_resolution=48),
                SDFConfig(cascade_resolution=16, truncation_voxels=3.0)):
        assert tbuild.supports(_port_cfg(cfg)) == jbuild.supports(cfg)
