"""The port's dense SDF build (``vri_tpu_torch.ops.sdf.build_cascades``,
the builder of the configurations the cell binning cannot hold) against
``vri_tpu.ops.sdf.build_cascades``, and the renderer's dense path.

Both sides build from the same packed scene, centered on the origin, at
``SDFConfig.preset("tiny")`` (r 16, truncation 3 voxels, past one
cell): the Cornell box; the Cornell box with an f32 atlas; the Cornell
box with ``max_bricks`` 256, which overflows; and a small kitchen (16
objects, tess 1), whose 64-triangle boxes put many triangles at AABB
distance 0 from a brick center, so the K nearest are decided by ties.
The JAX side builds in a subprocess whose XLA:CPU runs without fused
multiply-adds (``--xla_cpu_max_isa=AVX``), as
``tests/test_torch_sdf_build.py`` does.  Tolerances, and why:

* ``brick_map``, ``brick_voxel``, ``num_bricks``, ``overflow`` and
  ``near_drop`` exactly equal: integer results of the same occupancy
  tests (the plane distance summed in the same order) and the same
  cumulative-sum allocation.
* The atlas within one u8 step (within 1e-6 in f32) on the live bricks,
  the dead ones at distance 1: texel distances are the same float32
  operations, so in practice they are bit-equal; the count of differing
  texels is printed.
* Albedo, emissive and normal exactly equal: the nearest triangle under
  the same tie rule (lower index first).
* The march tables exactly equal.

The renderer: ``Renderer(RenderConfig(sdf=preset("tiny")),
device="cpu").render(gi=True)`` on the Cornell box at 64x64 takes the
dense build ("rebuilt (dense)"), renders a finite frame with coverage
above 50%, and matches ``vri_tpu``'s renderer (in the same subprocess,
with the march patches of ``tests/test_torch_frame.py``) with the JAX
frame's GI uniforms: ``instance_id`` equal on at least 99% of the
pixels and every other pixel a tie (both hit, at depths within rtol
1e-5: the box corners and quad diagonals project through pixel centers,
and the two rasters break such ties by different rules, as
``tests/test_torch_frame.py`` counts them), and ``color`` within 2e-3
(bf16 ``voxel_shade``) where the ids agree.
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
from vri_tpu.config import SDFConfig  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.ops import sdf_build as tbuild  # noqa: E402
from vri_tpu_torch.registry import bake_world  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402

TINY = SDFConfig.preset("tiny")
CASES = {
    "cornell": ("cornell", TINY),
    "cornell_f32": ("cornell", dataclasses.replace(TINY, atlas_u8=False)),
    "cornell_overflow": ("cornell", dataclasses.replace(TINY,
                                                        max_bricks=256)),
    "kitchen": ("kitchen", TINY),
}
STAGES = {"cornell": scenes.cornell_box,
          "kitchen": lambda: scenes.kitchen_stress(num_objects=16, tess=1)}
_FIELDS = ("num_bricks", "overflow", "near_drop", "brick_map", "brick_voxel",
           "atlas", "brick_albedo", "brick_normal", "brick_emissive",
           "march_coarse", "march_fine0", "march_fine1")
RES = 64


def _sync(stage):
    from test_torch_sdf_build import _sync as sync

    return sync(stage)


def _reference():
    """The JAX dense builds (``<case>/<field>``) and the JAX renderer's
    tiny-preset frame (``frame/<aov>``, ``frame/uniforms``) as numpy."""
    import jax

    import test_torch_frame as F
    from vri_tpu import renderer as jrenderer
    from vri_tpu.config import RenderConfig
    from vri_tpu.ops import sdf as jsdf
    from vri_tpu.ops import sdf_trace as jtrace
    from vri_tpu.registry import bake_world as jbake_world

    out = {}
    synced = {name: _sync(make())[0] for name, make in STAGES.items()}
    for case, (stage, cfg) in CASES.items():
        s = synced[stage]
        cas = jsdf.build_for_scene(s, jbake_world(s), np.zeros(3, np.float32),
                                   cfg)
        out.update({f"{case}/{k}": np.asarray(getattr(cas, k))
                    for k in _FIELDS})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", F._tpu_march)
        mp.setattr(jtrace, "occlusion", F._tpu_occlusion)
        jr = jrenderer.Renderer(RenderConfig(width=RES, height=RES, sdf=TINY))
        jr.load_stage(scenes.cornell_box())
        out.update({f"frame/{k}": np.asarray(v)
                    for k, v in jr.render(gi=True).items()})
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    out["frame/uniforms"] = np.asarray(
        jax.random.uniform(jax.random.fold_in(key, 0), (RES * RES, 2)))
    return out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_sdf_dense as T
np.savez(sys.argv[1], **T._reference())
"""


def _port_cfg(cfg):
    return vri_tpu_torch.SDFConfig(**{f.name: getattr(cfg, f.name)
                                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """(reference arrays, case -> port cascades)."""
    path = tmp_path_factory.mktemp("sdf_dense") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))
    synced = {name: _sync(make())[1] for name, make in STAGES.items()}
    port = {}
    for case, (stage, cfg) in CASES.items():
        ts = synced[stage]
        port[case] = tsdf.build_for_scene(ts, bake_world(ts),
                                          np.zeros(3, np.float32),
                                          _port_cfg(cfg))
    return ref, port


def test_tiny_preset_needs_the_dense_build():
    assert not tbuild.supports(_port_cfg(TINY))


@pytest.mark.parametrize("case", list(CASES))
def test_counts_and_brick_map_exact(builds, case):
    ref, port = builds
    cas = port[case]
    print(f"{case}: {int(cas.num_bricks)} bricks, {int(cas.overflow)} "
          "overflowed")
    for field in ("num_bricks", "overflow", "near_drop"):
        assert int(getattr(cas, field)) == int(ref[f"{case}/{field}"]), field
    np.testing.assert_array_equal(cas.brick_map.numpy(),
                                  ref[f"{case}/brick_map"])
    np.testing.assert_array_equal(cas.brick_voxel.numpy(),
                                  ref[f"{case}/brick_voxel"])


@pytest.mark.parametrize("case", list(CASES))
def test_atlas_within_one_step(builds, case):
    ref, port = builds
    cas = port[case]
    nb = int(cas.num_bricks)
    got, want = cas.atlas.numpy(), ref[f"{case}/atlas"]
    assert got.dtype == want.dtype
    if got.dtype == np.uint8:
        diff = np.abs(got[:nb].astype(np.int32) - want[:nb].astype(np.int32))
        step, far = 1, 255
    else:
        diff = np.abs(got[:nb] - want[:nb])
        step, far = 1e-6, 1.0
    print(f"{case}: {int((diff > 0).sum())} of {diff.size} live texels "
          f"differ (max {diff.max()})")
    assert diff.max() <= step
    assert (got[nb:] == far).all() and (want[nb:] == far).all()


@pytest.mark.parametrize("case", list(CASES))
def test_payload_exact(builds, case):
    ref, port = builds
    for field in ("brick_albedo", "brick_emissive", "brick_normal"):
        np.testing.assert_array_equal(getattr(port[case], field).numpy(),
                                      ref[f"{case}/{field}"], err_msg=field)


@pytest.mark.parametrize("case", list(CASES))
def test_march_tables_exact(builds, case):
    ref, port = builds
    for field in ("march_coarse", "march_fine0", "march_fine1"):
        np.testing.assert_array_equal(getattr(port[case], field).numpy(),
                                      ref[f"{case}/{field}"], err_msg=field)


def test_overflow_counted(builds):
    """Past ``max_bricks`` the occupied voxels are counted, not kept: the
    256 first in (cascade, z, y, x) order hold bricks."""
    ref, port = builds
    full, small = port["cornell"], port["cornell_overflow"]
    assert int(small.num_bricks) == 256
    assert int(small.overflow) == int(full.num_bricks) - 256 > 0
    np.testing.assert_array_equal(small.brick_voxel.numpy(),
                                  full.brick_voxel.numpy()[:256])


@pytest.fixture(scope="module")
def dense_renderer():
    r = Renderer(vri_tpu_torch.RenderConfig(width=RES, height=RES,
                                            sdf=vri_tpu_torch.SDFConfig.preset(
                                                "tiny")), device="cpu")
    r.load_stage(vri_tpu_torch.scenes.cornell_box())
    return r


def test_renderer_dense_frame_matches_reference(builds, dense_renderer):
    ref, _ = builds
    r = dense_renderer
    got = r.render(gi=True, uniforms=torch.as_tensor(
        ref["frame/uniforms"])[None])
    assert r.last_build_label == "rebuilt (dense)"
    assert r.list_overflow == 0
    a, b = ref["frame/instance_id"], got["instance_id"]
    cov = (b >= 0).mean()
    same = a == b
    tie = ~same & (a >= 0) & (b >= 0) & np.isclose(
        got["depth"], ref["frame/depth"], rtol=1e-5, atol=0)
    err = np.abs(got["color"] - ref["frame/color"]).max(-1)[same]
    print(f"dense frame: coverage {cov:.3f}, instance_id differs on "
          f"{int((~same).sum())} of {same.size} pixels ({int(tie.sum())} "
          f"ties), colour max {err.max():.2e} where they agree")
    assert np.isfinite(got["color"]).all() and cov > 0.5
    assert (same | tie).all() and same.mean() >= 0.99
    np.testing.assert_array_less(err, 2e-3)


def test_renderer_dense_rebuilds_on_change(dense_renderer):
    """Without a build state a moved focus or an edited scene rebuilds
    densely (no update, no scroll)."""
    r = dense_renderer
    r.render(gi=True)
    far = r.cascades.center[0].numpy() + 10.0 * TINY.voxel_size(1)
    r.ensure_cascades(focus=far)
    assert r.last_build_label == "rebuilt (dense)"
    assert r._build_state is None
