"""The port's LOD selection (``vri_tpu_torch.ops.lod``) and the LOD face
mask through the three raster tiers, the frame's dispatch and the
renderer, against ``vri_tpu.ops.lod`` and ``vri_tpu.ops.rasterize``.

The stage is ``tests/test_lod.py``'s: ``kitchen_stress(num_objects=16,
tess=4)`` packed with ``lod_levels=2, lod_min_faces=64`` at 160x120; the
port gets the JAX package's packed scene (``scene_from_numpy``), so both
sides select from the same chains.  Tolerances, and why:

* ``instance_levels`` and ``face_mask`` exactly equal at four views (the
  stage camera, eyes at distance 3 and 300 on the z axis, an eye inside
  an instance's box, where the distance is held at 1e-3) and three focal
  lengths, at tau 0.75 and 2.  The JAX side runs in a
  subprocess whose XLA:CPU has no fused multiply-add
  (``--xla_cpu_max_isa=AVX``): the sums of squares of the row norms and
  the distance would otherwise contract.
* Each masked tier (sorted, binned, ranged) against the same JAX tier
  (K1, K5, K6 interpreted) with the same mask at the stage camera, at
  the tolerances of ``tests/test_torch_raster_tiers.py``: triangle ids
  equal on 99.9% of the pixels counting ties and reference cracks, at
  most 1% ties, coverage equal on 99.95% counting reference cracks, u and
  v within 1e-5 of the float64 interpolation over the winning slot's
  setup, the overflow equal.  No masked face wins a pixel.  The port's
  three masked tiers are bit-equal to each other (``tri``, ``t``, ``u``,
  ``v``).
* The masked frame and the ``lod_tau=0`` parity, after
  ``tests/test_lod.py``: the LOD frame's colour within a mean of 0.01 of
  the full-rate frame's and at least one instance decimated; at
  ``lod_tau=0`` the frame of the LOD pack differs from a pack without
  chains on under 0.5% of the pixels.
* A face mask that drops one instance removes it from every tier's frame;
  an all-true mask changes nothing (``tests/test_lod.py``).
* The SDF build sees base geometry only: the build of the LOD pack equals
  the build of a pack without chains (``brick_map`` exactly equal).
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

from test_torch_raster import _barycentrics, _classify  # noqa: E402
from test_torch_raster_tiers import _port_tier, _setup_uv  # noqa: E402
import vri_tpu_torch  # noqa: E402
from vri_tpu.config import RenderConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.ops import rasterize as jraster  # noqa: E402
from vri_tpu.passes import frame as jframe  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.hydra.delegate import RenderDelegate as TDelegate  # noqa
from vri_tpu_torch.ops import lod as tlod  # noqa: E402
from vri_tpu_torch.ops import rasterize as traster  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import bake_world, scene_from_numpy  # noqa: E402

H, W = 120, 160
LOD_ARGS = dict(width=W, height=H, lod_levels=2, lod_min_faces=64)
#: (eye, focal length in pixels per unit tangent); None = the stage camera
VIEWS = {"camera": None, "near": ((0.0, 0.0, 3.0), 500.0),
         "far": ((0.0, 0.0, 300.0), 500.0), "coarse_focal": (None, 50.0)}
TAUS = (0.75, 2.0)
#: tests/test_sdf_build.py's CFG with 4^3-texel bricks (the renderer's
#: binned build needs r % 16 == 0 and a truncation within one cell)
SMALL_SDF = vri_tpu_torch.SDFConfig(
    num_cascades=2, cascade_resolution=32, base_voxel_size=0.1, brick_size=4,
    max_bricks=8192, truncation_voxels=2.0, max_triangles_per_brick=16)


def _jax_scene(**cfg):
    d = RenderDelegate(RenderConfig(**(cfg or LOD_ARGS)))
    d.populate(scenes.kitchen_stress(num_objects=16, tess=4))
    return d, d.sync()


def _port_scene(s):
    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)
              if f.name != "mip_atlas" and getattr(s, f.name) is not None}
    return scene_from_numpy(arrays, "cpu")


def _view(d, name):
    """(eye (3,), focal) of a view as numpy float32."""
    eye, focal = VIEWS[name] or (None, None)
    cam_focal = 1.0 / (2.0 * np.tan(0.5 * d.camera.fov_y) / H)
    return (np.asarray(eye if eye is not None else d.camera.eye, np.float32),
            np.float32(focal if focal is not None else cam_focal))


def _inside_eye(s):
    """An eye inside the box of the instance with the most LOD levels."""
    ni = int(s.num_instances)
    levels = np.isfinite(np.asarray(s.instance_lod_error)[:ni]).sum(1)
    i = int(np.argmax(levels))
    return 0.5 * (np.asarray(s.instance_aabb_lo[i])
                  + np.asarray(s.instance_aabb_hi[i]))


def _reference():
    """The JAX selections: ``<view>/<tau>/levels`` and ``.../mask``."""
    from vri_tpu.ops import lod as jlod

    d, s = _jax_scene()
    out = {}
    for name in [*VIEWS, "inside"]:
        if name == "inside":
            eye, focal = _inside_eye(s), _view(d, "camera")[1]
        else:
            eye, focal = _view(d, name)
        for tau in TAUS:
            mask, levels = jlod.face_mask(s, jnp.asarray(eye),
                                          jnp.float32(focal), tau)
            out[f"{name}/{tau}/levels"] = np.asarray(levels)
            out[f"{name}/{tau}/mask"] = np.asarray(mask)
            out[f"{name}/{tau}/eye"] = np.asarray(eye, np.float32)
            out[f"{name}/{tau}/focal"] = np.float32(focal)
    return out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_lod as T
np.savez(sys.argv[1], **T._reference())
"""


@pytest.fixture(scope="module")
def selections(tmp_path_factory):
    path = tmp_path_factory.mktemp("lod") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def lod_scene():
    d, s = _jax_scene()
    return d, s, _port_scene(s)


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("view", [*VIEWS, "inside"])
def test_selection_matches_reference(selections, lod_scene, view, tau):
    _, _, ts = lod_scene
    pre = f"{view}/{tau}/"
    mask, levels = tlod.face_mask(ts, torch.as_tensor(selections[pre + "eye"]),
                                  torch.as_tensor(selections[pre + "focal"]),
                                  tau)
    ni = int(ts.num_instances)
    hist = np.bincount(levels.numpy()[:ni], minlength=3)
    print(f"{view} tau {tau}: levels histogram {hist.tolist()}, "
          f"{int(mask.sum())} faces selected of {int(ts.num_faces_total)}")
    np.testing.assert_array_equal(levels.numpy(), selections[pre + "levels"])
    np.testing.assert_array_equal(mask.numpy(), selections[pre + "mask"])


# -- the masked tiers ---------------------------------------------------------

JTIERS = {"sorted": jraster.rasterize_sorted,
          "binned": jraster.rasterize_binned, "ranged": jraster.rasterize}


@pytest.fixture(scope="module")
def masked(lod_scene):
    """The stage camera's LOD mask through each tier of both packages."""
    d, s, ts = lod_scene
    eye, focal = _view(d, "camera")
    mask, _ = tlod.face_mask(ts, torch.as_tensor(eye),
                             torch.as_tensor(focal), 0.75)
    case = dict(h=H, w=W, cam=d.camera, world=np.asarray(jbake_world(s)),
                tri=np.asarray(s.tri_vertices), nf=int(s.num_faces_total),
                jcull=jframe._cull_sign(s), tcull=tframe._cull_sign(ts),
                tworld=bake_world(ts))
    jargs = (jnp.asarray(case["world"]), jnp.asarray(case["tri"]),
             jnp.int32(case["nf"]), jnp.asarray(d.camera.view_proj))
    ref = {t: fn(*jargs, height=H, width=W, cull_sign=case["jcull"],
                 face_mask=jnp.asarray(mask.numpy()), interpret=True)[0]
           for t, fn in JTIERS.items()}
    port = {t: _port_tier(case, t, face_mask=mask) for t in JTIERS}
    return case, mask, port, ref


@pytest.mark.parametrize("tier", list(JTIERS))
def test_masked_tier_matches_reference(masked, tier):
    case, mask, port, ref = masked
    hit, slot = port[tier]
    hj = ref[tier]
    a, b = np.asarray(hj.tri), hit.tri.numpy()
    n = a.size
    # no masked face wins a pixel
    assert mask.numpy()[b[b >= 0]].all()
    ties, edges, other = _classify(case, a, b)
    cov = (a >= 0) != (b >= 0)
    pix = np.nonzero(cov)[0]
    _, ue, ve = _barycentrics(case, pix, np.maximum(b[pix], 0))
    crack = np.zeros(n, bool)
    crack[pix] = (a[pix] < 0) & (b[pix] >= 0) & (
        np.abs(np.minimum(np.minimum(ue, ve), 1 - ue - ve)) <= 1e-5)
    print(f"masked {tier}: {int((a != b).sum())} of {n} pixels differ "
          f"({ties} ties, {int(crack.sum())} reference cracks, "
          f"{edges - int(crack.sum())} other on-edge, {other} other)")
    assert (n - other - edges + crack.sum()) / n >= 0.999
    assert other <= 0.001 * n and ties <= 0.01 * n
    assert (~cov | crack).mean() >= 0.9995
    pix = np.nonzero((a == b) & (a >= 0))[0]
    _, ue, ve = _barycentrics(case, pix, a[pix])
    us, vs = _setup_uv(case, tier, slot, pix)
    for got, want, exact, setup in ((hit.u, hj.u, ue, us),
                                    (hit.v, hj.v, ve, vs)):
        got, want = got.numpy()[pix], np.asarray(want)[pix]
        err_t, err_r = np.abs(got - exact), np.abs(want - exact)
        np.testing.assert_allclose(got, setup, rtol=0, atol=1e-5)
        assert (err_t <= np.maximum(
            1e-4, 1.25 * np.maximum(err_r, np.abs(setup - exact)))).all()
    if tier == "ranged":
        assert hj.overflow is None and hit.overflow is None
    else:
        assert int(hit.overflow) == int(hj.overflow)


def test_masked_tiers_bit_equal(masked):
    _, _, port, _ = masked
    for t in ("sorted", "binned"):
        assert int(port[t][0].overflow) == 0, t
    first = port["sorted"][0]
    for t in ("binned", "ranged"):
        for key in ("tri", "t", "u", "v"):
            assert torch.equal(getattr(port[t][0], key),
                               getattr(first, key)), (t, key)


@pytest.mark.parametrize("tier", ["rasterize", "rasterize_binned",
                                  "rasterize_sorted"])
def test_face_mask_culls_an_instance(tier):
    d = TDelegate(vri_tpu_torch.RenderConfig(width=48, height=48),
                  device="cpu")
    d.populate(vri_tpu_torch.scenes.cornell_box())
    scene = d.sync()
    world = bake_world(scene)
    vp = torch.as_tensor(d.camera.view_proj)
    fn = getattr(traster, tier)
    args = (world, scene.tri_vertices, scene.num_faces, vp)
    full, _ = fn(*args, height=48, width=48)
    kill = int(full.tri[full.tri >= 0][0])
    kill_inst = int(scene.tri_instance[kill])
    mask = scene.tri_instance != kill_inst
    part, _ = fn(*args, height=48, width=48, face_mask=mask)
    shown = part.tri[part.tri >= 0].long()
    assert bool((scene.tri_instance[shown] != kill_inst).all())
    all_on, _ = fn(*args, height=48, width=48,
                   face_mask=torch.ones_like(mask))
    assert torch.equal(all_on.tri, full.tri)


# -- frames, the SDF build and the renderer ----------------------------------

def _port_delegate(**cfg):
    d = TDelegate(vri_tpu_torch.RenderConfig(**cfg), device="cpu")
    d.populate(vri_tpu_torch.scenes.kitchen_stress(num_objects=16, tess=4))
    return d, d.sync()


def test_lod_frame_quality_and_tau_zero_parity():
    d, scene = _port_delegate(**LOD_ARGS)
    fp = tframe.FrameParams.from_camera(d.camera, H, device="cpu")

    def frame(s, **kw):
        out = tframe.render_frame(s, fp, height=H, width=W,
                                  backend="raster4x", shadows=False, **kw)
        assert int(out["raster_overflow_tiles"]) == 0
        return out["color"].numpy()
    off = frame(scene, lod_tau=0.0)
    on = frame(scene, lod_tau=0.75)
    err = np.abs(off - on).mean()
    focal = 1.0 / max(float(fp.pixel_spread), 1e-8)
    _, levels = tlod.face_mask(scene, fp.eye, torch.tensor(focal), 0.75)
    ni = int(scene.num_instances)
    print(f"LOD frame: mean colour difference {err:.2e}; levels histogram "
          f"{np.bincount(levels.numpy()[:ni], minlength=3).tolist()}")
    assert err < 0.01
    assert int(levels[:ni].max()) >= 1
    _, s0 = _port_delegate(width=W, height=H)      # no LOD chains
    base = frame(s0)
    frac = (np.abs(off - base).max(-1) > 1e-3).mean()
    print(f"lod_tau=0 against a pack without chains: {frac:.4f} of pixels "
          "differ")
    assert frac < 0.005


def test_sdf_build_sees_base_geometry_only(lod_scene):
    from vri_tpu_torch.ops import sdf as tsdf
    from vri_tpu_torch.ops import sdf_build as tbuild

    _, _, ts = lod_scene
    _, s0 = _jax_scene(width=W, height=H)
    t0 = _port_scene(s0)
    tiny = vri_tpu_torch.SDFConfig.preset("tiny")
    centers = tsdf.default_centers(tiny, np.zeros(3), device="cpu")
    # list caps that never truncate (tests/test_lod.py holds them at 512):
    # the two pools hold the same geometry at other triangle indices, so
    # a saturated cell would keep other refs
    cfg = tbuild.demand_caps(t0, bake_world(t0), centers, tiny)
    c1, st1 = tbuild.build_for_scene(ts, bake_world(ts), centers, cfg)
    c0, _ = tbuild.build_for_scene(t0, bake_world(t0), centers, cfg)
    assert int(st1.list_overflow) == 0
    assert int(c1.num_bricks) == int(c0.num_bricks) > 0
    assert torch.equal(c1.brick_map, c0.brick_map)


def test_renderer_renders_lod_at_default_tau():
    """``RenderConfig(lod_levels=2)`` renders a GI frame through
    ``Renderer.render`` at the default ``lod_tau``; its SDF build reads
    the base geometry."""
    from vri_tpu_torch.renderer import Renderer

    r = Renderer(vri_tpu_torch.RenderConfig(width=64, height=48,
                                            lod_levels=2, lod_min_faces=64,
                                            sdf=SMALL_SDF), device="cpu")
    r.load_stage(vri_tpu_torch.scenes.kitchen_stress(num_objects=16, tess=4))
    assert r.scene.base_pool_len is not None
    assert r.config.lod_tau > 0
    aovs = r.render(gi=True, gi_scale=2)
    assert r.last_build_label == "rebuilt"
    assert np.isfinite(aovs["color"]).all()
    assert (aovs["instance_id"] >= 0).mean() > 0.5
