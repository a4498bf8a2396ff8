"""The port's band rendering (rows [y0, y0 + height) of a taller frame)
against ``vri_tpu``: the raster tiers' ``y_offset`` / ``proj_height``,
``gi_band_inputs``, ``render_frame_gi_temporal(band=...)`` and
``render_frame_gi_dynamic(band=..., rebake=...)``.

* The three tiers on the Cornell box band of rows [16, 48) of a 64x64
  frame, against the JAX tiers on the same band (``rasterize_sorted``,
  ``rasterize_binned``, ``rasterize``: K1, K5, K6 interpreted), with
  ties, reference cracks and on-edge coverage counted as
  ``tests/test_torch_raster_tiers.py`` counts them and bounded the same
  way (ids agreeing on at least 99.9% of the band's pixels with ties and
  cracks, other differences at most 0.1%, ties at most 1%); u and v where
  the ids agree within 1e-4 of the float64 ray-triangle barycentrics or
  1.25x the reference's own error.  The overflow equal.
* The port's band against rows 16-47 of the port's full frame on each
  tier: the band subtracts its offset after the projection, so a corner
  far outside the band can round one ulp apart from the full frame's;
  the pixels whose triangle or depth differ are counted, printed and
  bounded by 0.5% of the band.  The three tiers bit-equal on the band.
* The frames, on Cornell at 64 wide with the band (16, 64), 32 rows high,
  from the JAX package's binned cascades (``tests/test_torch_dynamic.py``'s
  ``TINY`` configuration, built and baked in JAX and carried across with
  ``cascades_from_numpy``).  The JAX side renders in a subprocess whose
  XLA:CPU runs without fused multiply-adds, with the march patches of
  ``tests/test_torch_frame.py`` (K5 and K3 interpreted); every frame's GI
  uniforms (``jax.random.uniform(fold_in(key, 0), (GI pixels, 2))``) are
  handed to the port.  ``gi_band_inputs`` at ``gi_scale`` 1 and 2;
  ``render_frame_gi_temporal(band=...)`` at ``gi_scale`` 1 and 2 over two
  frames of a moving camera; ``render_frame_gi_dynamic(band=...)`` over
  two frames of a moving instance with ``rebake`` True and False.
  Tolerances, those of ``tests/test_torch_temporal.py``: ``instance_id``
  equal on at least 99.5% of the band; ``color``, the direct and the
  indirect term within 2e-3 (bf16 ``voxel_shade``), ``depth`` within
  rtol 1e-5 and ``gi_history`` within 1e-5 where the ids agree; the
  packed history within 1e-4 on the GI pixels whose ids agree;
  ``needs_full`` 0 and the updated ``brick_map`` equal.
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

from test_torch_raster import _barycentrics, _classify, _stage_case  # noqa: E402
import vri_tpu_torch  # noqa: E402
from vri_tpu.ops import rasterize as jraster  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import rasterize as traster  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import scene_from_numpy  # noqa: E402

FULL = 64
W = 64
Y0 = 16
BAND = 32
TIERS = {"sorted": (traster.rasterize_sorted, jraster.rasterize_sorted),
         "binned": (traster.rasterize_binned, jraster.rasterize_binned),
         "ranged": (traster.rasterize, jraster.rasterize)}

# -- the tiers on a band --------------------------------------------------------


def _embed(case, band_ids):
    """Band triangle ids -> full-frame ids with -1 outside the band."""
    out = np.full(case["h"] * case["w"], -1, np.int64)
    out[Y0 * W:(Y0 + BAND) * W] = band_ids
    return out


@pytest.fixture(scope="module")
def band_tiers():
    c = _stage_case(scenes.cornell_box(), FULL, W)
    targs = (c["tworld"], torch.as_tensor(c["tri"]), c["nf"],
             torch.as_tensor(c["cam"].view_proj))
    jargs = (jnp.asarray(c["world"]), jnp.asarray(c["tri"]),
             jnp.int32(c["nf"]), jnp.asarray(c["cam"].view_proj))
    port, ref = {}, {}
    for t, (tfn, jfn) in TIERS.items():
        port[t] = tfn(*targs, height=BAND, width=W, proj_height=FULL,
                      y_offset=float(Y0), cull_sign=c["tcull"])[0]
        ref[t] = jfn(*jargs, height=BAND, width=W, proj_height=FULL,
                     y_offset=jnp.float32(Y0), cull_sign=c["jcull"],
                     interpret=True)[0]
    full = {t: tfn(*targs, height=FULL, width=W, cull_sign=c["tcull"])[0]
            for t, (tfn, _) in TIERS.items()}
    return c, port, ref, full


@pytest.mark.parametrize("tier", list(TIERS))
def test_band_tier_matches_reference(band_tiers, tier):
    case, port, ref, _ = band_tiers
    hit, hj = port[tier], ref[tier]
    a = _embed(case, np.asarray(hj.tri))
    b = _embed(case, hit.tri.numpy())
    n = BAND * W
    ties, edges, other = _classify(case, a, b)
    cov = (a >= 0) != (b >= 0)
    pix = np.nonzero(cov)[0]
    _, ue, ve = _barycentrics(case, pix, np.maximum(b[pix], 0))
    crack = np.zeros(a.size, bool)
    crack[pix] = (a[pix] < 0) & (b[pix] >= 0) & (
        np.abs(np.minimum(np.minimum(ue, ve), 1 - ue - ve)) <= 1e-5)
    print(f"band/{tier}: {int((a != b).sum())} of {n} pixels differ "
          f"({ties} ties, {int(crack.sum())} reference cracks, "
          f"{edges - int(crack.sum())} other on-edge, {other} other)")
    assert (n - other - edges + crack.sum()) / n >= 0.999
    assert other <= 0.001 * n and ties <= 0.01 * n
    assert 1.0 - (cov & ~crack).sum() / n >= 0.9995
    same = np.nonzero((a == b) & (a >= 0))[0]
    _, ue, ve = _barycentrics(case, same, a[same])
    band_pix = same - Y0 * W
    for label, got, want, exact in (("u", hit.u, hj.u, ue),
                                    ("v", hit.v, hj.v, ve)):
        got, want = got.numpy()[band_pix], np.asarray(want)[band_pix]
        err_t, err_r = np.abs(got - exact), np.abs(want - exact)
        print(f"  {label}: port error {err_t.max():.2e}, reference "
              f"{err_r.max():.2e}")
        assert (err_t <= np.maximum(1e-4, 1.25 * err_r)).all()
    if tier == "ranged":
        assert hj.overflow is None and hit.overflow is None
    else:
        assert int(hit.overflow) == int(hj.overflow) == 0


@pytest.mark.parametrize("tier", list(TIERS))
def test_band_equals_full_frame_rows(band_tiers, tier):
    _, port, _, full = band_tiers
    band = port[tier]
    rows = slice(Y0 * W, (Y0 + BAND) * W)
    tri_f, t_f = full[tier].tri[rows], full[tier].t[rows]
    diff = (band.tri != tri_f) | ((band.tri >= 0) & (band.t != t_f))
    print(f"{tier}: the band differs from the full frame's rows on "
          f"{int(diff.sum())} of {diff.numel()} pixels (triangle or depth)")
    assert float(diff.float().mean()) <= 0.005
    for key in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(band, key),
                           getattr(port["sorted"], key)), (tier, key)


# -- the band frames against the JAX frames ------------------------------------

#: tests/test_torch_dynamic.py's TINY configuration and motion
TINY_ARGS = dict(num_cascades=2, cascade_resolution=16, brick_size=8,
                 max_bricks=8192, base_voxel_size=0.15,
                 truncation_voxels=3.0, max_triangles_per_brick=16,
                 march_max_steps=64, update_cell_cap=4096,
                 update_brick_cap=8192, update_tri_cap=4096)
TCFG = vri_tpu_torch.SDFConfig(**TINY_ARGS)
ORBIT = dict(radius=3.2, height=0.3)
DT = 1.0 / 15.0
OFFSETS = (0.05, 0.10)
GI_SCALES = (1, 2)
REBAKE = (True, False)


def _cameras():
    from vri_tpu.hydra.camera import FreeCamera

    return [FreeCamera(**ORBIT).at_time(i * DT, W / FULL) for i in range(2)]


def _uniforms(seed: int, gs: int):
    import jax

    key = jax.random.PRNGKey(seed)
    n = (BAND // gs) * (W // gs)
    return np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (n, 2)))


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _jax_scene():
    from vri_tpu.config import RenderConfig
    from vri_tpu.hydra import RenderDelegate

    d = RenderDelegate(RenderConfig(width=W, height=FULL))
    d.populate(scenes.cornell_box())
    return d, d.sync()


def _motion(s):
    """The smallest instance moved along x by ``OFFSETS``: (instance,
    (transforms, dirty boxes) per frame, dirty-triangle mask), as
    tests/test_torch_dynamic.py moves it."""
    import test_torch_dynamic as D

    assert D.OFFSETS == OFFSETS
    return D._motion(s)


def _reference():
    """The JAX cascades (``build/<field>``) and band frames as numpy."""
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
    kw = dict(height=BAND, width=W, config=cfg, backend="raster", samples=1,
              use_cache=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", F._tpu_march)
        mp.setattr(jtrace, "occlusion", F._tpu_occlusion)
        centers = jsdf.default_centers(cfg, jnp.zeros(3))
        cas0, st0 = jbuild.build_for_scene(s, jbake_world(s), centers, cfg)
        cas0 = jsdf.bake_brick_lighting(cas0, s, config=cfg, alive=st0.alive)
        for f in dataclasses.fields(cas0):
            if getattr(cas0, f.name) is not None:
                out[f"build/{f.name}"] = _np(getattr(cas0, f.name))
        for f in dataclasses.fields(st0):
            out[f"build/{f.name}"] = _np(getattr(st0, f.name))
        cams = _cameras()
        for gs in GI_SCALES:
            fp = jframe.FrameParams.from_camera(cams[0], FULL)
            _, gb, direct, sub, valid_s, ind = jframe.gi_band_inputs(
                s, fp, cas0, jax.random.PRNGKey(10 + gs), gi_scale=gs,
                y0=Y0, proj_height=FULL, **kw)
            pre = f"inputs{gs}/"
            out[pre + "instance_id"] = np.asarray(gb.instance)
            out[pre + "depth"] = np.asarray(gb.depth)
            out[pre + "direct"] = np.asarray(direct)
            out[pre + "ind"] = np.asarray(ind)
            out[pre + "valid_s"] = np.asarray(valid_s)
            out[pre + "uniforms"] = _uniforms(10 + gs, gs)
            state = jframe.init_temporal(BAND, W, gs)
            for i, cam in enumerate(cams):
                key = jax.random.PRNGKey(20 + 2 * gs + i)
                aovs, state = jframe.render_frame_gi_temporal(
                    s, jframe.FrameParams.from_camera(cam, FULL), cas0, key,
                    state, gi_scale=gs, band=(Y0, FULL), **kw)
                pre = f"temporal{gs}/{i}/"
                out.update({pre + k: np.asarray(v) for k, v in aovs.items()})
                out[pre + "state"] = np.asarray(state.data)
                out[pre + "uniforms"] = _uniforms(20 + 2 * gs + i, gs)
        _, frames, dirty = _motion(s)
        fp = jframe.FrameParams.from_camera(d.camera, FULL)
        for rebake in REBAKE:
            cas, st = cas0, st0
            state = jframe.init_temporal(BAND, W, 1)
            for i, (tf, dlo, dhi) in enumerate(frames):
                seed = 40 + 2 * int(rebake) + i
                s_i = s.replace(instance_transform=jnp.asarray(tf))
                aovs, state, cas, st, nf = jframe.render_frame_gi_dynamic(
                    s_i, fp, cas, st, jax.random.PRNGKey(seed), state,
                    jnp.asarray(dirty), jnp.asarray(dlo), jnp.asarray(dhi),
                    band=(Y0, FULL), rebake=rebake, **kw)
                pre = f"dynamic{int(rebake)}/{i}/"
                out.update({pre + k: np.asarray(v) for k, v in aovs.items()})
                out[pre + "state"] = np.asarray(state.data)
                out[pre + "needs_full"] = np.asarray(nf)
                out[pre + "brick_map"] = np.asarray(cas.brick_map)
                out[pre + "irradiance"] = np.asarray(cas.brick_irradiance)
                out[pre + "uniforms"] = _uniforms(seed, 1)
    return out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_bands as T
np.savez(sys.argv[1], **T._reference())
"""


@pytest.fixture(scope="module")
def band_frames(tmp_path_factory):
    """(reference, port frames): the JAX band frames, rendered in their own
    interpreter by an XLA:CPU without fused multiply-adds, and the port's
    from the same cascades, scene and uniforms."""
    path = tmp_path_factory.mktemp("bands") / "ref.npz"
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
    ts = scene_from_numpy({f.name: np.asarray(getattr(s, f.name))
                           for f in dataclasses.fields(s)
                           if f.name != "mip_atlas"
                           and getattr(s, f.name) is not None}, "cpu")
    build = {k.split("/", 1)[1]: v for k, v in ref.items()
             if k.startswith("build/")}
    cas0 = tsdf.cascades_from_numpy(build, "cpu")
    st0 = tsdf.build_state_from_numpy(build, "cpu")
    kw = dict(height=BAND, width=W, config=TCFG, backend="raster", samples=1,
              use_cache=True)

    def uni(pre):
        return torch.as_tensor(ref[pre + "uniforms"])[None]

    got = {}
    cams = _cameras()
    for gs in GI_SCALES:
        pre = f"inputs{gs}/"
        fp = tframe.FrameParams.from_camera(cams[0], FULL, device="cpu")
        _, gb, direct, sub, valid_s, ind = tframe.gi_band_inputs(
            ts, fp, cas0, gi_scale=gs, y0=Y0, proj_height=FULL,
            uniforms=uni(pre), **kw)
        got[pre + "instance_id"] = gb.instance.numpy()
        got[pre + "depth"] = gb.depth.numpy()
        got[pre + "direct"] = direct.numpy()
        got[pre + "ind"] = ind.numpy()
        got[pre + "valid_s"] = valid_s.numpy()
        state = tframe.init_temporal(BAND, W, gs, device="cpu")
        for i, cam in enumerate(cams):
            pre = f"temporal{gs}/{i}/"
            aovs, state = tframe.render_frame_gi_temporal(
                ts, tframe.FrameParams.from_camera(cam, FULL, device="cpu"),
                cas0, state, gi_scale=gs, band=(Y0, FULL), uniforms=uni(pre),
                **kw)
            got.update({pre + k: v.numpy() for k, v in aovs.items()})
            got[pre + "state"] = state.data.numpy()
    _, frames, dirty = _motion(s)
    fp = tframe.FrameParams.from_camera(d.camera, FULL, device="cpu")
    for rebake in REBAKE:
        cas, st = cas0, st0
        state = tframe.init_temporal(BAND, W, 1, device="cpu")
        for i, (tf, dlo, dhi) in enumerate(frames):
            pre = f"dynamic{int(rebake)}/{i}/"
            s_i = ts.replace(instance_transform=torch.as_tensor(tf))
            aovs, state, cas, st, nf = tframe.render_frame_gi_dynamic(
                s_i, fp, cas, st, state, torch.as_tensor(dirty),
                torch.as_tensor(dlo), torch.as_tensor(dhi), band=(Y0, FULL),
                rebake=rebake, uniforms=uni(pre), **kw)
            got.update({pre + k: v.numpy() for k, v in aovs.items()})
            got[pre + "state"] = state.data.numpy()
            got[pre + "needs_full"] = int(nf)
            got[pre + "brick_map"] = cas.brick_map.numpy()
            got[pre + "irradiance"] = cas.brick_irradiance.numpy()
    return ref, got


def _agreeing(ref, got, pre):
    same = ref[pre + "instance_id"] == got[pre + "instance_id"]
    print(f"{pre}: instance_id differs on {int((~same).sum())} of "
          f"{same.size} pixels")
    assert same.mean() >= 0.995
    return same


@pytest.mark.parametrize("gs", GI_SCALES)
def test_gi_band_inputs_match(band_frames, gs):
    ref, got = band_frames
    pre = f"inputs{gs}/"
    same = _agreeing(ref, got, pre)
    np.testing.assert_allclose(got[pre + "depth"][same],
                               ref[pre + "depth"][same], rtol=1e-5)
    err = np.abs(got[pre + "direct"] - ref[pre + "direct"]).max(-1)[same]
    print(f"  direct max {err.max():.2e} where the ids agree")
    np.testing.assert_array_less(err, 2e-3)
    same_s = same.reshape(BAND, W)[::gs, ::gs].reshape(-1)
    np.testing.assert_array_equal(got[pre + "valid_s"][same_s],
                                  ref[pre + "valid_s"][same_s])
    err = np.abs(got[pre + "ind"] - ref[pre + "ind"]).max(-1)[same_s]
    print(f"  indirect max {err.max():.2e} where the ids agree")
    assert np.isfinite(got[pre + "ind"]).all()
    assert np.abs(ref[pre + "ind"]).max() > 0.0
    np.testing.assert_array_less(err, 2e-3)


def _frame_matches(ref, got, pre, gs):
    assert set(k for k in got if k.startswith(pre)) == \
        set(k for k in ref if k.startswith(pre) and k != pre + "uniforms")
    same = _agreeing(ref, got, pre)
    assert got[pre + "color"].shape == (BAND, W, 3)
    err = np.abs(got[pre + "color"] - ref[pre + "color"]).max(-1)[same]
    print(f"  colour max {err.max():.2e} where the ids agree")
    assert np.isfinite(got[pre + "color"]).all()
    np.testing.assert_array_less(err, 2e-3)
    np.testing.assert_allclose(got[pre + "gi_history"][same],
                               ref[pre + "gi_history"][same], atol=1e-5)
    same_s = same[::gs, ::gs].reshape(-1)
    np.testing.assert_allclose(got[pre + "state"][same_s],
                               ref[pre + "state"][same_s], atol=1e-4)
    assert int(got[pre + "raster_overflow_tiles"]) == 0
    return same


@pytest.mark.parametrize("i", range(2))
@pytest.mark.parametrize("gs", GI_SCALES)
def test_temporal_band_frame_matches(band_frames, gs, i):
    ref, got = band_frames
    pre = f"temporal{gs}/{i}/"
    same = _frame_matches(ref, got, pre, gs)
    hist = got[pre + "gi_history"]
    if i == 0:
        assert (hist == 1.0).all()
    else:
        cov = same & (ref[pre + "instance_id"] >= 0)
        assert (hist[cov] > 1.0).mean() > 0.5


@pytest.mark.parametrize("i", range(len(OFFSETS)))
@pytest.mark.parametrize("rebake", REBAKE)
def test_dynamic_band_frame_matches(band_frames, rebake, i):
    ref, got = band_frames
    pre = f"dynamic{int(rebake)}/{i}/"
    assert got[pre + "needs_full"] == int(ref[pre + "needs_full"]) == 0
    np.testing.assert_array_equal(got[pre + "brick_map"],
                                  ref[pre + "brick_map"])
    np.testing.assert_allclose(got[pre + "irradiance"],
                               ref[pre + "irradiance"], atol=1e-4)
    _frame_matches(ref, got, pre, 1)


def test_rebake_false_keeps_the_bake(band_frames):
    """Without the re-bake every brick keeps the irradiance of the first
    bake; with it, the re-baked bricks' irradiance changes."""
    ref, got = band_frames
    base = ref["build/brick_irradiance"]
    changed = {r: np.abs(got[f"dynamic{int(r)}/1/irradiance"]
                         - base).max() for r in REBAKE}
    print(f"irradiance moved by at most {changed[True]:.2e} with the "
          f"re-bake, {changed[False]:.2e} without")
    assert changed[True] > 0.0 and changed[False] == 0.0
