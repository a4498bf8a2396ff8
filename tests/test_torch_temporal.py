"""The port's temporal GI frame (``vri_tpu_torch.passes.frame.
render_frame_gi_temporal``) and reduced-rate GI (``render_frame_gi`` at
``gi_scale=2``) against ``vri_tpu.passes.frame``.

* ``_reproject`` against the JAX function, run eagerly on the same numpy
  inputs: a 16x24 history written by one camera, queried from cameras
  moved by a fraction of a pixel and by several pixels (columns at both
  screen edges reproject off-screen), with disoccluded history rows (depth
  off by 30%), flipped normals, rows without history, points behind the
  history camera, and a band case (``y0``, ``proj_height``,
  ``query_y0``); and on random positions through an identity camera,
  which sweep past both edges.  ``h_ind`` and ``h_count`` within 1e-5
  (the reference multiplies [p, 1] by the camera matrix with one matrix
  product, the port with per-column products).
* Three frames of ``render_frame_gi_temporal`` at ``gi_scale=2`` on the
  Cornell box at 64^2 along ``FreeCamera.at_time`` (several pixels of
  motion a frame), from ``init_temporal``, with the room preset's
  ``shadow_scale=2``, and one ``render_frame_gi(gi_scale=2)`` frame.
  The reference renders in the no-FMA subprocess of
  ``tests/test_torch_frame.py`` with its ``_tpu_march`` /
  ``_tpu_occlusion`` patches (K5 and K3 interpreted); each frame's GI
  uniforms are ``jax.random.uniform(fold_in(fold_in(PRNGKey(0), i), 0),
  (32 * 32, 2))``, handed to the port.  Each side builds its own
  cascades once, at the first camera.  Tolerances: ``instance_id`` equal
  on at least 99.5% of the pixels; ``color`` within 2e-3 (bf16
  ``voxel_shade``) and ``gi_history`` within 1e-5 where the ids agree; the
  packed state (indirect, depth, normal, count per GI pixel) within 1e-4
  on the GI pixels whose ids agree.
* One band frame: rows [16, 48) of the first camera's 64^2 frame at
  ``gi_scale=2`` (``band=(16, 64)``), against the JAX band frame with its
  uniforms, held as the whole frame is; ``gi_band_inputs`` with the same
  ``y0`` / ``proj_height`` gives the band frame's G-buffer.
* Port-only checks, after ``tests/test_temporal.py``: history survives a
  slow orbit through ``Renderer.render_flythrough(temporal=True)``, and a
  teleport resets far more pixels than a small step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vri_tpu_torch  # noqa: E402
from vri_tpu.passes import frame as jframe  # noqa: E402
from vri_tpu_torch.hydra.camera import FreeCamera, make_camera  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402

RES = 64
GS = 2
FRAMES = 3
DT = 1.0 / 15.0
#: the frame test's configuration with the room preset's shadow_scale
SDF_ARGS = dict(num_cascades=2, cascade_resolution=64, brick_size=8,
                max_bricks=16384, base_voxel_size=0.075,
                truncation_voxels=3.0, max_triangles_per_brick=16,
                approx_occlusion=True, shadow_scale=2)
ORBIT = dict(radius=3.2, height=0.3)

# -- _reproject ---------------------------------------------------------------

H, W = 16, 24


def _unproject_plane(cam, h, w, rows=None):
    """World points on the plane z = 0 under the pixel centers of
    ``cam`` (rows ``rows`` of an h x w frame)."""
    rows = np.arange(h) if rows is None else rows
    y, x = np.meshgrid(rows, np.arange(w), indexing="ij")
    ndc = np.stack([(x + 0.5) / w * 2 - 1, 1 - (y + 0.5) / h * 2],
                   -1).reshape(-1, 2)
    inv = np.linalg.inv(cam.view_proj.astype(np.float64))

    def point(z):
        q = np.concatenate([ndc, np.full((len(ndc), 1), z),
                            np.ones((len(ndc), 1))], 1) @ inv.T
        return q[:, :3] / q[:, 3:]
    o, f = point(0.1), point(0.9)
    d = f - o
    return (o - d * (o[:, 2:] / d[:, 2:])).astype(np.float32)


def _reproject_case(case):
    """(state fields, query position, normal, valid, kwargs) as numpy."""
    rng = np.random.default_rng(list(CASES).index(case))
    if case == "random":
        # the identity camera: positions sweep across and past both edges,
        # most of them at the history's depth 1.5 from the eye
        n = H * W
        data = rng.normal(size=(n, 8)).astype(np.float32)
        data[:, 3] = 1.5
        data[:, 7] = (rng.random(n) > 0.3) * 5.0
        nrm = np.asarray([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.3, (n, 3))
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
            np.float32)
        data[:, 4:7] = nrm
        pos = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
        pos[:, 2] = np.sqrt(np.maximum(2.25 - pos[:, 0] ** 2 - pos[:, 1] ** 2,
                                       0.0)) + rng.normal(0.0, 0.005, n)
        q_nrm = nrm[rng.integers(0, n, n)]
        q_nrm[rng.random(n) < 0.1] *= -1.0
        return ((data, np.eye(4, dtype=np.float32), np.zeros(3, np.float32)),
                pos, q_nrm, rng.random(n) > 0.2, {})
    shift = CASES[case]
    band = case == "band"
    hist_h, proj_h, y0, qy0 = (H, 24, 4, 2) if band else (H, H, 0, 0)
    cam_a = make_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), 45.0, W / proj_h)
    p_a = _unproject_plane(cam_a, proj_h, W, np.arange(y0, y0 + hist_h))
    n = len(p_a)
    data = np.zeros((n, 8), np.float32)
    data[:, 0:3] = rng.random((n, 3))
    data[:, 3] = np.linalg.norm(p_a - cam_a.eye, axis=-1)
    data[:, 4:7] = (0.0, 0.0, 1.0)
    data[:, 7] = rng.integers(0, 17, n)                  # 0: no history
    off = rng.random(n)
    data[off < 0.15, 3] *= 1.3                           # disoccluded
    data[(off >= 0.15) & (off < 0.2), 4:7] = (0.0, 0.0, -1.0)
    # one pixel of the frame spans 2 tan(22.5 deg) 3 / proj_h world units
    px = 2.0 * np.tan(np.radians(22.5)) * 3.0 / proj_h
    eye_b = (shift * px, 0.4 * shift * px, 3.0)
    cam_b = make_camera(eye_b, (eye_b[0], eye_b[1], 0.0), 45.0, W / proj_h)
    q_rows = np.arange(y0 + qy0, y0 + qy0 + (hist_h - qy0))
    pos = _unproject_plane(cam_b, proj_h, W, q_rows)
    m = len(pos)
    behind = rng.random(m) < 0.05
    pos[behind, 2] = 4.0                                 # behind camera A
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (m, 1))
    return ((data, cam_a.view_proj.astype(np.float32), cam_a.eye),
            pos, nrm, rng.random(m) > 0.1,
            dict(y0=y0, proj_height=proj_h if band else None,
                 query_y0=qy0))


#: camera motion in pixels a frame
CASES = {"random": None, "subpixel": 0.3, "multipixel": 3.7, "band": 1.6}


@pytest.mark.parametrize("case", list(CASES))
def test_reproject_matches(case):
    (data, vp, eye), pos, nrm, valid, kw = _reproject_case(case)
    hist_h = data.shape[0] // W
    jstate = jframe.TemporalState(data=jnp.asarray(data),
                                  view_proj=jnp.asarray(vp),
                                  eye=jnp.asarray(eye))
    want = jframe._reproject(jstate, jnp.asarray(pos), jnp.asarray(nrm),
                             jnp.asarray(valid), hist_h, W, **kw)
    tstate = tframe.TemporalState(data=torch.as_tensor(data),
                                  view_proj=torch.as_tensor(vp),
                                  eye=torch.as_tensor(eye))
    got = tframe._reproject(tstate, torch.as_tensor(pos),
                            torch.as_tensor(nrm), torch.as_tensor(valid),
                            hist_h, W, **kw)
    kept = np.asarray(want[1]) > 0
    diff = [np.abs(g.numpy() - np.asarray(w)).max() for g, w in zip(got, want)]
    print(f"{case}: {int(kept.sum())} of {len(pos)} queries keep history, "
          f"max differences {diff[0]:.1e} / {diff[1]:.1e}")
    assert 0 < kept.sum() < len(pos)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5)


# -- the temporal frame against the JAX frame ---------------------------------

def _uniforms(i: int):
    """Frame i's GI draws at GI resolution, as the JAX renderer takes
    them (``indirect_radiance`` folds sample 0 into the frame key)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), i)
    return np.asarray(jax.random.uniform(jax.random.fold_in(key, 0),
                                         ((RES // GS) ** 2, 2)))


def _reference():
    """The JAX frames as numpy: ``{i}/<aov>`` and ``{i}/state`` for the
    temporal frames, ``gi2/<aov>`` for render_frame_gi(gi_scale=2) at the
    first camera, ``{i}/uniforms``."""
    import test_torch_frame as F
    from vri_tpu import renderer as jrenderer
    from vri_tpu.config import RenderConfig, SDFConfig
    from vri_tpu.hydra.camera import FreeCamera as JFreeCamera
    from vri_tpu.ops import sdf_trace as jtrace
    from vri_tpu.usd import scenes

    cfg = SDFConfig(**SDF_ARGS)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", F._tpu_march)
        mp.setattr(jtrace, "occlusion", F._tpu_occlusion)
        jr = jrenderer.Renderer(RenderConfig(width=RES, height=RES, sdf=cfg))
        jr.load_stage(scenes.cornell_box())
        cams = [JFreeCamera(**ORBIT).at_time(i * DT, 1.0)
                for i in range(FRAMES)]
        cas = jr.ensure_cascades(eye=cams[0].eye)
        state = jframe.init_temporal(RES, RES, GS)
        for i, cam in enumerate(cams):
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            aovs, state = jframe.render_frame_gi_temporal(
                jr.scene, jframe.FrameParams.from_camera(cam, RES), cas,
                key, state, height=RES, width=RES, config=cfg,
                use_cache=True, gi_scale=GS)
            out.update({f"{i}/{k}": np.asarray(v) for k, v in aovs.items()})
            out[f"{i}/state"] = np.asarray(state.data)
            out[f"{i}/uniforms"] = _uniforms(i)
        aovs = jframe.render_frame_gi(
            jr.scene, jframe.FrameParams.from_camera(cams[0], RES), cas,
            jax.random.fold_in(jax.random.PRNGKey(0), 0), height=RES,
            width=RES, config=cfg, use_cache=True, gi_scale=GS)
        out.update({f"gi2/{k}": np.asarray(v) for k, v in aovs.items()})
        # the band frame: rows [RES / 4, 3 RES / 4) of the first camera's
        key = jax.random.fold_in(jax.random.PRNGKey(0), FRAMES)
        aovs, _ = jframe.render_frame_gi_temporal(
            jr.scene, jframe.FrameParams.from_camera(cams[0], RES), cas,
            key, jframe.init_temporal(RES // 2, RES, GS), height=RES // 2,
            width=RES, config=cfg, use_cache=True, gi_scale=GS,
            band=(RES // 4, RES))
        out.update({f"band/{k}": np.asarray(v) for k, v in aovs.items()})
        out["band/uniforms"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 0), ((RES // 2 // GS) * (RES // GS), 2)))
    return out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_temporal as T
np.savez(sys.argv[1], **T._reference())
"""


@pytest.fixture(scope="module")
def temporal_frames(tmp_path_factory):
    """The JAX frames, rendered in their own interpreter by an XLA:CPU
    without fused multiply-adds, and the port's with the same uniforms;
    returns (reference, port frames, port renderer)."""
    path = tmp_path_factory.mktemp("temporal") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))

    cfg = vri_tpu_torch.SDFConfig(**SDF_ARGS)
    tr = Renderer(vri_tpu_torch.RenderConfig(width=RES, height=RES, sdf=cfg),
                  device="cpu")
    tr.load_stage(vri_tpu_torch.scenes.cornell_box())
    cams = [FreeCamera(**ORBIT).at_time(i * DT, 1.0) for i in range(FRAMES)]
    cas = tr.ensure_cascades(eye=cams[0].eye)
    state = tframe.init_temporal(RES, RES, GS, device="cpu")
    got = {}
    for i, cam in enumerate(cams):
        aovs, state = tframe.render_frame_gi_temporal(
            tr.scene, tframe.FrameParams.from_camera(cam, RES, device="cpu"),
            cas, state, height=RES, width=RES, config=cfg, use_cache=True,
            gi_scale=GS, uniforms=torch.as_tensor(ref[f"{i}/uniforms"])[None])
        got.update({f"{i}/{k}": v.numpy() for k, v in aovs.items()})
        got[f"{i}/state"] = state.data.numpy()
    aovs = tframe.render_frame_gi(
        tr.scene, tframe.FrameParams.from_camera(cams[0], RES, device="cpu"),
        cas, height=RES, width=RES, config=cfg, use_cache=True, gi_scale=GS,
        uniforms=torch.as_tensor(ref["0/uniforms"])[None])
    got.update({f"gi2/{k}": v.numpy() for k, v in aovs.items()})
    aovs, _ = tframe.render_frame_gi_temporal(
        tr.scene, tframe.FrameParams.from_camera(cams[0], RES, device="cpu"),
        cas, tframe.init_temporal(RES // 2, RES, GS, device="cpu"),
        height=RES // 2, width=RES, config=cfg, use_cache=True, gi_scale=GS,
        band=(RES // 4, RES),
        uniforms=torch.as_tensor(ref["band/uniforms"])[None])
    got.update({f"band/{k}": v.numpy() for k, v in aovs.items()})
    return ref, got, tr


def _agreeing(ref, got, pre):
    same = ref[pre + "instance_id"] == got[pre + "instance_id"]
    print(f"{pre}: instance_id differs on {int((~same).sum())} of "
          f"{same.size} pixels")
    assert same.mean() >= 0.995
    return same


@pytest.mark.parametrize("i", range(FRAMES))
def test_temporal_frame_matches(temporal_frames, i):
    ref, got, _ = temporal_frames
    pre = f"{i}/"
    assert set(k for k in got if k.startswith(pre)) == \
        set(k for k in ref if k.startswith(pre) and k != pre + "uniforms")
    same = _agreeing(ref, got, pre)
    err = np.abs(got[pre + "color"] - ref[pre + "color"]).max(-1)[same]
    hist = got[pre + "gi_history"]
    cov = ref[pre + "instance_id"] >= 0
    print(f"  colour max {err.max():.2e} where they agree; mean gi_history "
          f"{hist[cov].mean():.3f} over covered pixels")
    assert np.isfinite(got[pre + "color"]).all()
    np.testing.assert_array_less(err, 2e-3)
    np.testing.assert_allclose(hist[same], ref[pre + "gi_history"][same],
                               atol=1e-5)
    assert int(got[pre + "raster_overflow_tiles"]) == 0
    # the GI pixels (every second pixel of every second row) whose ids
    # agree: their packed history rows
    same_s = same[::GS, ::GS].reshape(-1)
    np.testing.assert_allclose(got[pre + "state"][same_s],
                               ref[pre + "state"][same_s], atol=1e-4)
    if i == 0:
        assert (hist == 1.0).all()       # no history before the first frame
    else:
        assert (hist[cov] > 1.0).mean() > 0.5


def test_gi_scale_2_frame_matches(temporal_frames):
    ref, got, _ = temporal_frames
    same = _agreeing(ref, got, "gi2/")
    err = np.abs(got["gi2/color"] - ref["gi2/color"]).max(-1)[same]
    print(f"  colour max {err.max():.2e} where they agree")
    assert set(k for k in got if k.startswith("gi2/")) == \
        set(k for k in ref if k.startswith("gi2/"))
    assert np.isfinite(got["gi2/color"]).all()
    np.testing.assert_array_less(err, 2e-3)


def test_gi_band_inputs_refuses_bands(temporal_frames):
    """The band arguments are ported: the band frame (rows [RES / 4,
    3 RES / 4) at the first camera, ``gi_scale=2``) matches the JAX band
    frame with its uniforms, as ``test_gi_scale_2_frame_matches`` holds
    the whole frame, and ``gi_band_inputs`` with ``y0`` / ``proj_height``
    gives the same G-buffer.  (The name is kept from when the band
    arguments raised.)"""
    ref, got, tr = temporal_frames
    same = _agreeing(ref, got, "band/")
    err = np.abs(got["band/color"] - ref["band/color"]).max(-1)[same]
    print(f"  colour max {err.max():.2e} where they agree")
    assert got["band/color"].shape == (RES // 2, RES, 3)
    assert np.isfinite(got["band/color"]).all()
    np.testing.assert_array_less(err, 2e-3)
    assert (got["band/gi_history"] == 1.0).all()
    cam = FreeCamera(**ORBIT).at_time(0.0, 1.0)
    fp = tframe.FrameParams.from_camera(cam, RES, device="cpu")
    _, gb, _, _, _, _ = tframe.gi_band_inputs(
        tr.scene, fp, tr.cascades, height=RES // 2, width=RES,
        config=tr.config.sdf, gi_scale=GS, y0=RES // 4, proj_height=RES,
        use_cache=True, uniforms=torch.as_tensor(ref["band/uniforms"])[None])
    np.testing.assert_array_equal(
        gb.instance.reshape(RES // 2, RES).numpy(), got["band/instance_id"])


# -- port-only checks after tests/test_temporal.py ----------------------------

def test_port_history_accumulates_under_motion(temporal_frames):
    _, _, tr = temporal_frames
    frames = tr.render_flythrough(4, FreeCamera(**ORBIT), dt=1.0 / 60.0,
                                  temporal=True, gi_scale=1)
    assert np.all(frames[0]["gi_history"] == 1.0)     # no history yet
    # most pixels keep reprojected history through a slow orbit
    frac = (frames[3]["gi_history"] >= 3.0).mean()
    print(f"history of 3 frames or more on {frac:.3f} of pixels")
    assert frac > 0.5
    assert np.isfinite(frames[3]["color"]).all()


def test_port_teleport_resets_history(temporal_frames):
    _, _, tr = temporal_frames
    cfg = tr.config.sdf

    def reset_fraction(t_second):
        cam_a = FreeCamera(radius=3.2).at_time(0.0, 1.0)
        cam_b = FreeCamera(radius=3.2).at_time(t_second, 1.0)
        cascades = tr.ensure_cascades(eye=cam_a.eye)
        state = tframe.init_temporal(RES, RES, device="cpu")
        aovs = None
        for cam in (cam_a, cam_b):
            gen = torch.Generator()
            gen.manual_seed(0)
            aovs, state = tframe.render_frame_gi_temporal(
                tr.scene, tframe.FrameParams.from_camera(cam, RES,
                                                         device="cpu"),
                cascades, state, height=RES, width=RES, config=cfg,
                use_cache=True, generator=gen)
        hitpix = aovs["depth"] < 1e9            # sky never has history
        return float((aovs["gi_history"][hitpix] == 1.0).float().mean())

    small = reset_fraction(0.05)       # a tiny orbit step
    jump = reset_fraction(4.0)         # to the opposite side
    print(f"history restarts on {small:.3f} of hit pixels after a small "
          f"step, {jump:.3f} after a teleport")
    # surfaces seen from both sides keep their history legitimately
    assert jump > 0.3
    assert jump > 2.0 * small
