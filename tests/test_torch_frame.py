"""The whole slice: ``vri_tpu_torch.renderer.Renderer.render(gi=True)``
against ``vri_tpu.renderer.Renderer.render(gi=True)`` on the Cornell box at
64^2 with a room-like two-cascade r=64 configuration.

On the CPU the JAX package marches SDF rays with its XLA loop, because
``sdf_trace`` dispatches to the march kernel only on a TPU
(``sdf_trace.py:218``, ``:311``), and rasterizes a 64^2 frame with its
binned tier (``frame.py:258``).  The reference run therefore swaps
``sdf_trace.march`` / ``sdf_trace.occlusion`` for copies of those TPU
branches that run ``march_kernel.march_stream`` in interpret mode, and
``rasterize_binned`` for ``rasterize_sorted``: the frame then goes through
K1/K2 and K3, the kernels the port replaces.  No file of ``vri_tpu``
changes.  The reference renders in its own interpreter with an XLA:CPU
limited to AVX, which has no fused multiply-add, so XLA cannot contract
products and sums that the port rounds one by one.  The port gets the
reference frame's GI uniforms through ``uniforms=``.

Tolerances, and why:

* ``instance_id`` equal on at least 99.5% of the pixels, and every pixel
  that differs a reference crack: the reference misses a pixel center
  that the port covers, the center lies on an edge of the port's
  triangle (its float64 barycentrics within 1e-5 of it), and the
  reference covers the four neighbours.  K1/K2 test l1, l2 >= 0 and
  l1 + l2 <= 1 from per-slot coefficients and can lose a center on a
  shared edge to rounding; the port's canonical edge functions are
  watertight.  The count is printed.
* ``normal`` and ``albedo`` within 1e-5 and ``depth`` within rtol 1e-5
  where the ids agree (same triangle, same float32 interpolation up to
  rounding order).
* ``color`` within 2e-3 on every pixel where the ids agree
  (``voxel_shade`` is bf16 on both sides).
* ``raster_overflow_tiles`` 0 on both sides.
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

from vri_tpu import renderer as jrenderer  # noqa: E402
from vri_tpu.config import RenderConfig, SDFConfig  # noqa: E402
from vri_tpu.ops import march_kernel as jmarch  # noqa: E402
from vri_tpu.ops import rasterize as jraster  # noqa: E402
from vri_tpu.ops import sdf_trace as jtrace  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402

RES = 64
CFG = SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                max_bricks=16384, base_voxel_size=0.075,
                truncation_voxels=3.0, max_triangles_per_brick=16,
                approx_occlusion=True)


def _tpu_march(sdf, origins, dirs, t_max, *, config, max_steps=None,
               approx=False, compact=False):
    """sdf_trace.march's TPU branch (sdf_trace.py:218-229), interpreted."""
    assert approx and config.kernel_march and jmarch.supports(config)
    ks = (max_steps or config.march_max_steps) * 2 + 16
    return jmarch.march_stream(sdf, origins, dirs, t_max, config=config,
                               max_steps=ks, interpret=True)


def _tpu_occlusion(sdf, origins, dirs, t_max, *, config, max_steps=None):
    """sdf_trace.occlusion's TPU branch (sdf_trace.py:311-321)."""
    ks = (max_steps or config.march_max_steps) * 2 + 16
    rec = jmarch.march_stream(sdf, origins, dirs, t_max, config=config,
                              max_steps=ks, payload=False, interpret=True)
    return 1.0 - rec.hit.astype(jnp.float32)


def _sorted_tier(*args, caps_scale=1, **kw):
    """The sorted raster (K1/K2, the kernels kernel R replaces) in place of
    the binned tier the frame picks for small framebuffers."""
    return jraster.rasterize_sorted(*args, caps_scale=caps_scale, **kw)


def _reference_frame():
    """The JAX frame's AOVs and its GI uniforms, as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", _tpu_march)
        mp.setattr(jtrace, "occlusion", _tpu_occlusion)
        mp.setattr(jraster, "rasterize_binned", _sorted_tier)
        jr = jrenderer.Renderer(RenderConfig(width=RES, height=RES, sdf=CFG))
        jr.load_stage(scenes.cornell_box())
        ref = {k: np.asarray(v) for k, v in jr.render(gi=True).items()}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    ref["uniforms"] = np.asarray(
        jax.random.uniform(jax.random.fold_in(key, 0), (RES * RES, 2)))
    return ref


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_frame as T
np.savez(sys.argv[1], **T._reference_frame())
"""


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The JAX frame, rendered by an XLA:CPU limited to AVX (no fused
    multiply-add) in its own interpreter because XLA reads its flags
    once, and the port's frame with the same GI uniforms."""
    path = tmp_path_factory.mktemp("frame") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))
    tr = Renderer(RenderConfig(width=RES, height=RES, sdf=CFG), device="cpu")
    tr.load_stage(scenes.cornell_box())
    got = tr.render(gi=True, uniforms=torch.as_tensor(ref["uniforms"])[None])
    return ref, got, tr


def _edge_barycentric(tr, pix):
    """Float64 smallest barycentric of the port's winning triangle at each
    pixel center (0 on an edge), from the pixel's ray."""
    from vri_tpu_torch.passes import frame as tframe
    from vri_tpu_torch.registry import bake_world

    cam = tr.camera
    world = bake_world(tr.scene)
    hit = tframe._visibility_raster(
        tr.scene, world, tframe.FrameParams.from_camera(cam, RES,
                                                        device="cpu"),
        RES, RES)
    corners = world.numpy().astype(np.float64)[
        tr.scene.tri_vertices.numpy()[hit.tri.numpy()[pix]]]
    inv = np.linalg.inv(cam.view_proj.astype(np.float64))
    y, x = np.divmod(pix, RES)
    ndc = np.stack([(x + 0.5) / RES * 2 - 1, 1 - (y + 0.5) / RES * 2], -1)

    def unproject(z):
        q = np.concatenate([ndc, np.full((len(pix), 1), z),
                            np.ones((len(pix), 1))], 1) @ inv.T
        return q[:, :3] / q[:, 3:]
    o = unproject(0.02)
    d = unproject(0.98) - o
    e1, e2 = corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0]
    pv = np.cross(d, e2)
    det = (pv * e1).sum(-1)
    tv = o - corners[:, 0]
    u = (tv * pv).sum(-1) / det
    v = (d * np.cross(tv, e1)).sum(-1) / det
    return np.minimum(np.minimum(u, v), 1 - u - v)


def test_gbuffer_matches(frames):
    ref, got, tr = frames
    a, b = ref["instance_id"].reshape(-1), got["instance_id"].reshape(-1)
    same = a == b
    covered = np.pad(ref["instance_id"] >= 0, 1, constant_values=True)
    ring = np.ones((RES, RES), bool)
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        ring &= covered[dy:dy + RES, dx:dx + RES]
    crack = ~same & (a < 0) & (b >= 0) & ring.reshape(-1)
    pix = np.nonzero(crack)[0]
    on_edge = np.abs(_edge_barycentric(tr, pix)) <= 1e-5
    print(f"instance_id differs on {int((~same).sum())} of {a.size} pixels "
          f"({int(crack.sum())} reference cracks, {int(on_edge.sum())} of "
          "them on an edge of the port's triangle)")
    assert same.mean() >= 0.995
    assert (same | crack).all() and on_edge.all()
    da, db = ref["depth"].reshape(-1), got["depth"].reshape(-1)
    for key in ("normal", "albedo"):
        np.testing.assert_allclose(got[key].reshape(-1, 3)[same],
                                   ref[key].reshape(-1, 3)[same], atol=1e-5)
    np.testing.assert_allclose(db[same], da[same], rtol=1e-5)
    assert int(ref["raster_overflow_tiles"]) == 0
    assert int(got["raster_overflow_tiles"]) == 0


def test_color_matches(frames):
    ref, got, _ = frames
    same = (ref["instance_id"] == got["instance_id"]).reshape(-1)
    err = np.abs(got["color"].reshape(-1, 3)
                 - ref["color"].reshape(-1, 3)).max(-1)[same]
    print(f"colour: {int((err > 2e-3).sum())} of {err.size} agreeing pixels "
          f"beyond 2e-3, max {err.max():.2e}")
    assert np.isfinite(got["color"]).all()
    np.testing.assert_array_less(err, 2e-3)


def test_render_progressive_accumulates(frames):
    _, _, tr = frames
    img = tr.render_progressive(2)
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("argv", [["--no-gi"], ["--mode", "sdf_distance"],
                                  ["--backend", "bvh"], ["--multichip"],
                                  ["--builtin", "animated"]])
def test_app_refuses_unported_flags(argv):
    """``python -m vri_tpu_torch.app`` exits with 2 on a flag whose path is
    not ported, before it loads anything."""
    from vri_tpu_torch import app

    assert app.main(argv) == 2
