"""The port's animated frame (``vri_tpu_torch.passes.frame.
render_frame_gi_dynamic``) and the renderer's bounded cascade paths
(``Renderer.ensure_cascades`` taking the update or the scroll,
``Renderer.render(time_code=...)``) against ``vri_tpu``.

* Two frames of ``render_frame_gi_dynamic`` on ``tests/test_temporal.py``'s
  ``TINY`` configuration (with the update capacities its dynamic tests
  use) and Cornell box at 48x32, the smallest instance moved by 0.05 then
  0.10 along x, from baked cascades and ``init_temporal``, through the
  raster.  The JAX side renders in the no-FMA subprocess of
  ``tests/test_torch_frame.py`` with its ``_tpu_march`` /
  ``_tpu_occlusion`` patches (K5 and K3 interpreted); it builds and bakes
  the cascades, which the port gets through ``cascades_from_numpy`` and
  ``build_state_from_numpy``, and each frame's GI uniforms
  (``jax.random.uniform(fold_in(PRNGKey(i), 0), (48 * 32, 2))``) are
  handed to the port.  The moved scene is each side's own (``bake_world``
  of the two packages differs by float32 ulps).  Tolerances, those of
  ``tests/test_torch_temporal.py``: ``instance_id`` equal on at least
  99.5% of the pixels; ``color`` within 2e-3 (bf16 ``voxel_shade``) and
  ``gi_history`` within 1e-5 where the ids agree; the packed state within
  1e-4 on those pixels; ``needs_full`` 0 on both sides and the updated
  ``brick_map`` equal.
* The port's dynamic step against its own full rebuild at the moved
  transforms, bake and temporal frame, through the brute-force tracer
  with the same uniforms: colour within rtol 1e-3, atol 2e-3
  (``tests/test_temporal.py``).
* The renderer (``tests/test_sdf_build.py``'s ``CFG`` with 4^3-texel
  bricks and ``max_bricks`` 16384, so no occupied voxel goes without a
  brick) on
  ``animated_stage(num_objects=4)``: a transforms-only sync takes the
  bounded update, a focus moved past one coarse voxel takes the scroll,
  and ``render(time_code=t)`` for t = 0, 4, 8 rebuilds once and then
  updates; the cascades after t = 8 are voxel-equal (occupancy, ESD,
  atlas and albedo per voxel; march tables equal) to a full build at
  t = 8 with the same list capacities.
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
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.ops import sdf_build as tbuild  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import scene_from_numpy  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402

H, W = 32, 48
#: tests/test_temporal.py's TINY with the capacities of its dynamic tests
TINY_ARGS = dict(num_cascades=2, cascade_resolution=16, brick_size=8,
                 max_bricks=8192, base_voxel_size=0.15,
                 truncation_voxels=3.0, max_triangles_per_brick=16,
                 march_max_steps=64, update_cell_cap=4096,
                 update_brick_cap=8192, update_tri_cap=4096)
TCFG = vri_tpu_torch.SDFConfig(**TINY_ARGS)
OFFSETS = (0.05, 0.10)
#: tests/test_sdf_build.py's CFG with 4^3-texel bricks and room for every
#: occupied voxel of the animated stage
ANIM_SDF = vri_tpu_torch.SDFConfig(
    num_cascades=2, cascade_resolution=32, base_voxel_size=0.1, brick_size=4,
    max_bricks=16384, truncation_voxels=2.0, max_triangles_per_brick=8,
    update_cell_cap=2048, update_brick_cap=8192, update_tri_cap=512)


def _jax_scene():
    d = RenderDelegate(RenderConfig(width=W, height=H))
    d.populate(scenes.cornell_box())
    return d, d.sync()


def _motion(s):
    """(instance k, transforms per frame, dirty-triangle mask, dirty boxes
    per frame): the smallest instance moved along x, each frame's boxes
    its previous and new AABB (two dead pad rows)."""
    ni = int(s.num_instances)
    lo = np.asarray(s.instance_aabb_lo)[:ni]
    hi = np.asarray(s.instance_aabb_hi)[:ni]
    k = int(np.argmin((hi - lo).max(-1)))
    tf0 = np.asarray(s.instance_transform).copy()
    dirty = np.asarray(s.tri_instance) == k
    frames = []
    prev = np.zeros(3, np.float32)
    for x in OFFSETS:
        off = np.asarray([x, 0.0, 0.0], np.float32)
        tf = tf0.copy()
        tf[k, :3, 3] += off
        dlo = np.full((4, 3), 3.0e38, np.float32)
        dhi = np.full((4, 3), -3.0e38, np.float32)
        dlo[0], dhi[0] = lo[k] + prev, hi[k] + prev
        dlo[1], dhi[1] = lo[k] + off, hi[k] + off
        frames.append((tf, dlo, dhi))
        prev = off
    return k, frames, dirty


def _uniforms(i: int):
    import jax

    return np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(i), 0), (H * W, 2)))


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _reference():
    """The JAX cascades (``build/<field>``) and frames (``<i>/<aov>``,
    ``<i>/state``, ``<i>/needs_full``, ``<i>/brick_map``,
    ``<i>/uniforms``)."""
    import jax
    import jax.numpy as jnp

    import test_torch_frame as F
    from vri_tpu.config import SDFConfig
    from vri_tpu.ops import sdf as jsdf
    from vri_tpu.ops import sdf_build as jbuild
    from vri_tpu.ops import sdf_trace as jtrace
    from vri_tpu.passes import frame as jframe
    from vri_tpu.registry import bake_world as jbake_world

    cfg = SDFConfig(**TINY_ARGS)
    d, s = _jax_scene()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", F._tpu_march)
        mp.setattr(jtrace, "occlusion", F._tpu_occlusion)
        centers = jsdf.default_centers(cfg, jnp.zeros(3))
        cas, st = jbuild.build_for_scene(s, jbake_world(s), centers, cfg)
        cas = jsdf.bake_brick_lighting(cas, s, config=cfg, alive=st.alive)
        for f in dataclasses.fields(cas):
            if getattr(cas, f.name) is not None:
                out[f"build/{f.name}"] = _np(getattr(cas, f.name))
        for f in dataclasses.fields(st):
            out[f"build/{f.name}"] = _np(getattr(st, f.name))
        _, frames, dirty = _motion(s)
        fp = jframe.FrameParams.from_camera(d.camera, H)
        ts = jframe.init_temporal(H, W, 1)
        for i, (tf, dlo, dhi) in enumerate(frames):
            s_i = s.replace(instance_transform=jnp.asarray(tf))
            aovs, ts, cas, st, nf = jframe.render_frame_gi_dynamic(
                s_i, fp, cas, st, jax.random.PRNGKey(i), ts,
                jnp.asarray(dirty), jnp.asarray(dlo), jnp.asarray(dhi),
                height=H, width=W, config=cfg, backend="raster", samples=1,
                use_cache=True)
            out.update({f"{i}/{k}": np.asarray(v) for k, v in aovs.items()})
            out[f"{i}/state"] = np.asarray(ts.data)
            out[f"{i}/needs_full"] = np.asarray(nf)
            out[f"{i}/brick_map"] = np.asarray(cas.brick_map)
            out[f"{i}/uniforms"] = _uniforms(i)
    return out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_dynamic as T
np.savez(sys.argv[1], **T._reference())
"""


def _port_scene(s):
    return scene_from_numpy({f.name: np.asarray(getattr(s, f.name))
                             for f in dataclasses.fields(s)
                             if f.name != "mip_atlas"
                             and getattr(s, f.name) is not None}, "cpu")


@pytest.fixture(scope="module")
def dynamic_frames(tmp_path_factory):
    """(reference, port frames, port scene, camera, motion, carried
    cascades and state)."""
    path = tmp_path_factory.mktemp("dynamic") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))

    d, s = _jax_scene()
    ts = _port_scene(s)
    build = {k.split("/", 1)[1]: v for k, v in ref.items()
             if k.startswith("build/")}
    cas0 = tsdf.cascades_from_numpy(build, "cpu")
    st0 = tsdf.build_state_from_numpy(build, "cpu")
    motion = _motion(s)
    _, frames, dirty = motion
    fp = tframe.FrameParams.from_camera(d.camera, H, device="cpu")
    state = tframe.init_temporal(H, W, 1, device="cpu")
    cas, st = cas0, st0
    got = {}
    for i, (tf, dlo, dhi) in enumerate(frames):
        s_i = ts.replace(instance_transform=torch.as_tensor(tf))
        aovs, state, cas, st, nf = tframe.render_frame_gi_dynamic(
            s_i, fp, cas, st, state, torch.as_tensor(dirty),
            torch.as_tensor(dlo), torch.as_tensor(dhi), height=H, width=W,
            config=TCFG, backend="raster", samples=1, use_cache=True,
            uniforms=torch.as_tensor(ref[f"{i}/uniforms"])[None])
        got.update({f"{i}/{k}": v.numpy() for k, v in aovs.items()})
        got[f"{i}/state"] = state.data.numpy()
        got[f"{i}/needs_full"] = int(nf)
        got[f"{i}/brick_map"] = cas.brick_map.numpy()
    return ref, got, ts, fp, motion, (cas0, st0)


@pytest.mark.parametrize("i", range(len(OFFSETS)))
def test_dynamic_frame_matches_reference(dynamic_frames, i):
    ref, got, _, _, _, _ = dynamic_frames
    pre = f"{i}/"
    assert got[pre + "needs_full"] == int(ref[pre + "needs_full"]) == 0
    np.testing.assert_array_equal(got[pre + "brick_map"],
                                  ref[pre + "brick_map"])
    same = ref[pre + "instance_id"] == got[pre + "instance_id"]
    print(f"dynamic frame {i}: instance_id differs on "
          f"{int((~same).sum())} of {same.size} pixels")
    assert same.mean() >= 0.995
    err = np.abs(got[pre + "color"] - ref[pre + "color"]).max(-1)[same]
    print(f"  colour max {err.max():.2e} where the ids agree")
    assert np.isfinite(got[pre + "color"]).all()
    np.testing.assert_array_less(err, 2e-3)
    np.testing.assert_allclose(got[pre + "gi_history"][same],
                               ref[pre + "gi_history"][same], atol=1e-5)
    np.testing.assert_allclose(got[pre + "state"][same.reshape(-1)],
                               ref[pre + "state"][same.reshape(-1)],
                               atol=1e-4)
    assert int(got[pre + "raster_overflow_tiles"]) == 0


def test_dynamic_step_matches_full_rebuild(dynamic_frames):
    """One dynamic step from the carried cascades against a full rebuild
    at the moved transforms, its bake and the temporal frame."""
    ref, _, ts, fp, motion, (cas0, st0) = dynamic_frames
    _, frames, dirty = motion
    tf, dlo, dhi = frames[0]
    s1 = ts.replace(instance_transform=torch.as_tensor(tf))
    uni = torch.as_tensor(ref["0/uniforms"])[None]
    kw = dict(height=H, width=W, config=TCFG, backend="brute", samples=1,
              use_cache=True, uniforms=uni)
    state = tframe.init_temporal(H, W, 1, device="cpu")
    aovs_d, _, _, _, nf = tframe.render_frame_gi_dynamic(
        s1, fp, cas0, st0, state, torch.as_tensor(dirty),
        torch.as_tensor(dlo), torch.as_tensor(dhi), **kw)
    assert int(nf) == 0
    from vri_tpu_torch.registry import bake_world

    cas_r, st_r = tbuild.build_for_scene(s1, bake_world(s1), cas0.center,
                                         TCFG)
    cas_r = tsdf.bake_brick_lighting(cas_r, s1, config=TCFG,
                                     alive=st_r.alive)
    aovs_r, _ = tframe.render_frame_gi_temporal(s1, fp, cas_r, state, **kw)
    cd, cr = aovs_d["color"].numpy(), aovs_r["color"].numpy()
    print(f"dynamic step against a full rebuild: colour at most "
          f"{np.abs(cd - cr).max():.2e} apart")
    assert np.isfinite(cd).all()
    np.testing.assert_allclose(cd, cr, rtol=1e-3, atol=2e-3)


# -- the renderer's bounded paths ---------------------------------------------

def _animated_renderer():
    r = Renderer(vri_tpu_torch.RenderConfig(width=32, height=32,
                                            sdf=ANIM_SDF), device="cpu")
    r.load_stage(vri_tpu_torch.scenes.animated_stage(num_objects=4))
    return r


def test_renderer_takes_update_then_scroll():
    r = _animated_renderer()
    r.render(gi=True)
    assert r.last_build_label == "rebuilt"
    before = r.cascades
    # transform-only animation: the registry reports dirty instances
    changed = vri_tpu_torch.scenes.animate(r.delegate.stage, 0.5)
    r.delegate.apply_animation(changed)
    r.sync()
    upd = r.delegate.registry.last_update
    assert upd["kind"] == "transforms" and len(upd["dirty_instances"]) > 0
    aovs = r.render(gi=True)
    print(f"after a transforms-only sync: {r.last_build_label}")
    assert r.last_build_label.startswith("updated (")
    assert r.cascades is not before
    assert np.isfinite(aovs["color"]).all()
    # a focus moved past one coarse voxel on an unchanged scene scrolls
    coarse = ANIM_SDF.voxel_size(ANIM_SDF.num_cascades - 1)
    focus = r._cascade_focus + np.asarray([2.0 * coarse, 0.0, 0.0],
                                          np.float32)
    r.ensure_cascades(focus=focus)
    print(f"after moving the focus by {2.0 * coarse:.2f}: "
          f"{r.last_build_label}")
    assert r.last_build_label.startswith("scrolled ")
    assert r.list_overflow == 0


def _voxel_fields(cas):
    bm = cas.brick_map.reshape(-1).numpy()
    occ = bm >= 0
    ids = bm[occ]
    return (occ, np.where(occ, 0, bm.clip(max=0)), cas.atlas.numpy()[ids],
            cas.brick_albedo.numpy()[ids])


def test_render_time_codes_take_the_update():
    r = _animated_renderer()
    labels = []
    for t in (0.0, 4.0, 8.0):
        aovs = r.render(gi=True, time_code=t)
        labels.append(r.last_build_label)
        assert np.isfinite(aovs["color"]).all()
    print(f"render(time_code=0, 4, 8): {labels}")
    assert labels[0] == "rebuilt"
    assert all(lab.startswith("updated (") for lab in labels[1:])
    # a full build at t = 8 with the same list capacities
    fresh = _animated_renderer()
    fresh._sdf_cfg_effective = r._sdf_cfg_effective
    fresh.sync(time_code=8.0)
    fresh.ensure_cascades(eye=r.camera.eye)
    assert fresh.last_build_label == "rebuilt"
    assert int(r.cascades.num_bricks) == int(fresh.cascades.num_bricks)
    for a, b in zip(_voxel_fields(r.cascades), _voxel_fields(fresh.cascades)):
        np.testing.assert_array_equal(a, b)
    for f in ("march_coarse", "march_fine0", "march_fine1"):
        assert torch.equal(getattr(r.cascades, f),
                           getattr(fresh.cascades, f)), f
