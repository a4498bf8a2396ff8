"""The whole slice: ``vri_tpu_torch.renderer.Renderer.render(gi=True)``
against ``vri_tpu.renderer.Renderer.render(gi=True)`` on the Cornell box at
64^2 with a room-like two-cascade r=64 configuration, through the raster
and through the LBVH (``backend="bvh"``), with ``approx_occlusion=False``
as the ``reference`` preset has it (GI rays march the trilinear loop),
and the six SDF debug views (``render(mode=SDF_*)``); and the direct-only
frame (``render(gi=False)``) through the brute-force tracer, the LBVH and
the raster on the Cornell box at 48^2.  Each side renders with its own
package's stage and configuration classes.

On the CPU the JAX package marches SDF rays with its XLA loop, because
``sdf_trace`` dispatches to the march kernel only on a TPU
(``sdf_trace.py:218``, ``:311``).  The reference run therefore swaps
``sdf_trace.march`` / ``sdf_trace.occlusion`` for copies of those TPU
branches that run ``march_kernel.march_stream`` in interpret mode; calls
outside the kernel's approximate tier still go to the XLA loop.  Both
frames rasterize the 64^2 frame with their binned tier (``frame.py:258``):
K5, interpreted, in the reference and kernel R over the binned lists in
the port.  The frame then goes through K5 and K3, kernels the port
replaces.  No file of ``vri_tpu`` changes.  The reference renders in its
own interpreter with an XLA:CPU limited to AVX, which has no fused
multiply-add, so XLA cannot contract products and sums that the port
rounds one by one.  The port gets the
reference frame's GI uniforms through ``uniforms=``.

Tolerances, and why:

* ``instance_id`` equal on at least 99.5% of the pixels counting ties,
  and every pixel that differs a tie or a reference crack.  A tie: both
  cover the pixel at depths within rtol 1e-5, and its center lies on an
  edge of the port's triangle (float64 barycentric within 1e-5), where
  two instances meet.  The box's wall junctions project exactly through
  pixel centers along the frame's diagonals, and K5 breaks such ties by
  its Morton group position while the port takes the lowest setup slot.
  A reference crack: the reference misses a pixel center that the port
  covers, the center lies on an edge of the port's triangle, and the
  reference covers the four neighbours.  K5 tests l1, l2 >= 0 and
  l1 + l2 <= 1 from per-slot coefficients split into bf16 terms and can
  lose a center on a shared edge to rounding (12 in the binned raster of
  ``tests/test_torch_raster_tiers.py``, where XLA contracts
  multiply-adds; this frame, without them, has 21 ties and no crack);
  the port's canonical edge functions are watertight.  Both counts are
  printed.
* ``normal`` and ``albedo`` within 1e-5 and ``depth`` within rtol 1e-5
  where the ids agree (same triangle, same float32 interpolation up to
  rounding order).
* ``color`` within 2e-3 on every pixel where the ids agree
  (``voxel_shade`` is bf16 on both sides).
* ``raster_overflow_tiles`` 0 on both sides.
* The BVH GI frame (the reference's second frame, so its GI uniforms are
  those of frame index 1): ``instance_id`` equal on at least 99.5% of the
  pixels, every differing pixel a tie (both hit at depths within rtol
  1e-5), counted; ``color`` within 2e-3 where the ids agree.  Without
  contraction the two BVH walks are bit-equal (``tests/test_torch_bvh.py``),
  so no tie is expected.
* The ``approx_occlusion=False`` GI frame: the raster frame's
  tolerances (``instance_id`` equal on at least 99.5% of the pixels and
  every differing pixel a tie, ``color`` within 2e-3 where the ids
  agree).
* The SDF debug views (each side marches its own cascades): the hit set
  equal on at least 99.9% of the pixels; ``depth`` and ``color`` within
  rtol 1e-5 (atol 1e-6 for colour channels near 0) where both hit, the
  iteration heat everywhere.  Each view returns only ``color`` and
  ``depth``.
* The direct-only frames (the reference's in the same interpreter without
  fused multiply-adds): the hit triangle (``instance_id`` and
  ``prim_id``) equal on at least 99% of the pixels, and all but 0.1% of
  the differing pixels ties as above (the two triangles of a quad meet on
  its diagonal), counted.  The world vertices differ by float32 ulps
  (``bake_world``, ``tests/test_torch_scene.py``), which moves such ties
  and can turn a ray grazing a silhouette edge from a hit into a miss
  (one pixel on the brute-force and BVH frames).  ``depth`` within rtol
  1e-5, ``normal`` within 1e-5 and ``color`` within 2e-3 where the
  triangle agrees.
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
from vri_tpu import renderer as jrenderer  # noqa: E402
from vri_tpu.config import DebugMode, RenderConfig, SDFConfig  # noqa: E402
from vri_tpu.ops import march_kernel as jmarch  # noqa: E402
from vri_tpu.ops import sdf_trace as jtrace  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.renderer import Renderer  # noqa: E402

RES = 64
DIRECT_RES = 48
DIRECT_BACKENDS = ("brute", "bvh", "raster")
SDF_ARGS = dict(num_cascades=2, cascade_resolution=64, brick_size=8,
                max_bricks=16384, base_voxel_size=0.075,
                truncation_voxels=3.0, max_triangles_per_brick=16,
                approx_occlusion=True)
CFG = SDFConfig(**SDF_ARGS)
#: the same configuration in the port's own classes
TCFG = vri_tpu_torch.SDFConfig(**SDF_ARGS)
#: the reference preset's defining flag: GI rays march trilinear samples
REF_CFG = SDFConfig(**dict(SDF_ARGS, approx_occlusion=False))
TREF_CFG = vri_tpu_torch.SDFConfig(**dict(SDF_ARGS, approx_occlusion=False))
SDF_MODES = range(DebugMode.SDF_DISTANCE, DebugMode.SDF_CASCADE_ID + 1)


def _port_renderer(res: int, sdf=TCFG) -> Renderer:
    tr = Renderer(vri_tpu_torch.RenderConfig(width=res, height=res,
                                             sdf=sdf), device="cpu")
    tr.load_stage(vri_tpu_torch.scenes.cornell_box())
    return tr


#: the XLA loop, which sdf_trace.march's TPU branch runs for every call
#: that is not the kernel's approximate tier
_XLA_MARCH = jtrace.march


def _tpu_march(sdf, origins, dirs, t_max, *, config, max_steps=None,
               approx=False, compact=False):
    """sdf_trace.march's TPU branch (sdf_trace.py:218-229), interpreted;
    other calls go to the XLA loop, as on a TPU."""
    if not (approx and config.kernel_march and jmarch.supports(config)):
        return _XLA_MARCH(sdf, origins, dirs, t_max, config=config,
                          max_steps=max_steps, approx=approx,
                          compact=compact)
    assert not compact
    ks = (max_steps or config.march_max_steps) * 2 + 16
    return jmarch.march_stream(sdf, origins, dirs, t_max, config=config,
                               max_steps=ks, interpret=True)


def _tpu_occlusion(sdf, origins, dirs, t_max, *, config, max_steps=None):
    """sdf_trace.occlusion's TPU branch (sdf_trace.py:311-321)."""
    ks = (max_steps or config.march_max_steps) * 2 + 16
    rec = jmarch.march_stream(sdf, origins, dirs, t_max, config=config,
                              max_steps=ks, payload=False, interpret=True)
    return 1.0 - rec.hit.astype(jnp.float32)


def _uniforms(frame_index: int):
    """The GI sample draws of the reference renderer's frame."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), frame_index)
    return np.asarray(
        jax.random.uniform(jax.random.fold_in(key, 0), (RES * RES, 2)))


def _reference_frame():
    """The JAX frames' AOVs and their GI uniforms, as numpy: the raster
    frame, then the BVH frame (keys prefixed ``bvh/``), and the
    direct-only frames at 48^2 (``direct/<backend>/``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", _tpu_march)
        mp.setattr(jtrace, "occlusion", _tpu_occlusion)
        jr = jrenderer.Renderer(RenderConfig(width=RES, height=RES, sdf=CFG))
        jr.load_stage(scenes.cornell_box())
        ref = {k: np.asarray(v) for k, v in jr.render(gi=True).items()}
        ref.update({f"bvh/{k}": np.asarray(v) for k, v in
                    jr.render(gi=True, backend="bvh").items()})
        jq = jrenderer.Renderer(RenderConfig(width=RES, height=RES,
                                             sdf=REF_CFG))
        jq.load_stage(scenes.cornell_box())
        ref.update({f"reference/{k}": np.asarray(v) for k, v in
                    jq.render(gi=True).items()})
        for mode in SDF_MODES:
            ref.update({f"sdf{mode}/{k}": np.asarray(v) for k, v in
                        jr.render(mode=mode).items()})
    jd = jrenderer.Renderer(RenderConfig(width=DIRECT_RES, height=DIRECT_RES,
                                         sdf=CFG))
    jd.load_stage(scenes.cornell_box())
    for be in DIRECT_BACKENDS:
        ref.update({f"direct/{be}/{k}": np.asarray(v) for k, v in
                    jd.render(gi=False, backend=be).items()})
    ref["uniforms"] = _uniforms(0)
    ref["bvh/uniforms"] = _uniforms(1)
    ref["reference/uniforms"] = _uniforms(0)
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
    tr = _port_renderer(RES)
    got = tr.render(gi=True, uniforms=torch.as_tensor(ref["uniforms"])[None])
    got.update({f"bvh/{k}": v for k, v in tr.render(
        gi=True, backend="bvh",
        uniforms=torch.as_tensor(ref["bvh/uniforms"])[None]).items()})
    for mode in SDF_MODES:
        got.update({f"sdf{mode}/{k}": v
                    for k, v in tr.render(mode=mode).items()})
    tq = _port_renderer(RES, TREF_CFG)
    got.update({f"reference/{k}": v for k, v in tq.render(
        gi=True,
        uniforms=torch.as_tensor(ref["reference/uniforms"])[None]).items()})
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
    da, db = ref["depth"].reshape(-1), got["depth"].reshape(-1)
    tie = ~same & (a >= 0) & (b >= 0) & np.isclose(db, da, rtol=1e-5,
                                                    atol=0)
    pix = np.nonzero(crack | tie)[0]
    on_edge = np.abs(_edge_barycentric(tr, pix)) <= 1e-5
    print(f"instance_id differs on {int((~same).sum())} of {a.size} pixels "
          f"({int(tie.sum())} ties, {int(crack.sum())} reference cracks; "
          f"{int(on_edge.sum())} of them on an edge of the port's triangle)")
    assert (same | tie).mean() >= 0.995
    assert (same | tie | crack).all() and on_edge.all()
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


def test_bvh_gi_frame_matches(frames):
    ref, got, _ = frames
    a = ref["bvh/instance_id"].reshape(-1)
    b = got["bvh/instance_id"].reshape(-1)
    same = a == b
    tie = ~same & (a >= 0) & (b >= 0) & np.isclose(
        got["bvh/depth"].reshape(-1), ref["bvh/depth"].reshape(-1),
        rtol=1e-5, atol=0)
    err = np.abs(got["bvh/color"].reshape(-1, 3)
                 - ref["bvh/color"].reshape(-1, 3)).max(-1)[same]
    print(f"BVH frame: instance_id differs on {int((~same).sum())} of "
          f"{a.size} pixels ({int(tie.sum())} ties); colour max "
          f"{err.max():.2e} where they agree")
    assert same.mean() >= 0.995 and (same | tie).all()
    assert "bvh/raster_overflow_tiles" not in got
    assert np.isfinite(got["bvh/color"]).all()
    np.testing.assert_array_less(err, 2e-3)


def test_reference_preset_gi_frame_matches(frames):
    """The GI frame with ``approx_occlusion=False``, the reference
    preset's defining flag: shadow rays still take the march kernel, GI
    rays the trilinear loop.  The existing frame's tolerances."""
    ref, got, _ = frames
    a = ref["reference/instance_id"].reshape(-1)
    b = got["reference/instance_id"].reshape(-1)
    same = a == b
    tie = ~same & (a >= 0) & (b >= 0) & np.isclose(
        got["reference/depth"].reshape(-1), ref["reference/depth"].reshape(-1),
        rtol=1e-5, atol=0)
    err = np.abs(got["reference/color"].reshape(-1, 3)
                 - ref["reference/color"].reshape(-1, 3)).max(-1)[same]
    print(f"reference preset frame: instance_id differs on "
          f"{int((~same).sum())} of {a.size} pixels ({int(tie.sum())} "
          f"ties); colour max {err.max():.2e} where they agree")
    assert (same | tie).mean() >= 0.995 and (same | tie).all()
    assert np.isfinite(got["reference/color"]).all()
    np.testing.assert_array_less(err, 2e-3)
    assert int(got["reference/raster_overflow_tiles"]) == 0


@pytest.mark.parametrize("mode", SDF_MODES)
def test_sdf_debug_frame_matches(frames, mode):
    """``render(mode=SDF_*)``: camera rays marched by the trilinear loop
    to the far plane; ``color`` and ``depth`` within rtol 1e-5 where both
    hit (and everywhere for the iteration heat, which shows misses)."""
    ref, got, _ = frames
    pre = f"sdf{mode}/"
    assert set(k for k in got if k.startswith(pre)) == {pre + "color",
                                                          pre + "depth"}
    d_ref, d_got = ref[pre + "depth"], got[pre + "depth"]
    both = (d_ref < 1e30) & (d_got < 1e30)
    print(f"SDF mode {mode}: {both.mean():.4f} of pixels hit on both sides, "
          f"{int(((d_ref < 1e30) != (d_got < 1e30)).sum())} hit on one")
    assert ((d_ref < 1e30) == (d_got < 1e30)).mean() >= 0.999
    np.testing.assert_allclose(d_got[both], d_ref[both], rtol=1e-5)
    where = (np.ones_like(both) if mode == DebugMode.SDF_ITERATIONS
             else both)
    np.testing.assert_allclose(got[pre + "color"][where],
                               ref[pre + "color"][where], rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def direct_frames(frames):
    """The direct-only frame through each backend, the reference's and
    the port's."""
    ref = frames[0]
    tr = _port_renderer(DIRECT_RES)
    out = {}
    for be in DIRECT_BACKENDS:
        pre = f"direct/{be}/"
        out[be] = ({k[len(pre):]: v for k, v in ref.items()
                    if k.startswith(pre)}, tr.render(gi=False, backend=be))
    return out


@pytest.mark.parametrize("backend", DIRECT_BACKENDS)
def test_direct_frame_matches(direct_frames, backend):
    ref, got = direct_frames[backend]
    assert set(got) == set(ref)
    same = ((ref["instance_id"] == got["instance_id"])
            & (ref["prim_id"] == got["prim_id"]))
    tie = ~same & (ref["instance_id"] >= 0) & (got["instance_id"] >= 0) \
        & np.isclose(got["depth"], ref["depth"], rtol=1e-5, atol=0)
    print(f"{backend}: the hit triangle differs on {int((~same).sum())} of "
          f"{same.size} pixels ({int(tie.sum())} ties)")
    assert same.mean() >= 0.99
    assert (~(same | tie)).mean() <= 1e-3
    np.testing.assert_allclose(got["depth"][same], ref["depth"][same],
                               rtol=1e-5)
    np.testing.assert_allclose(got["normal"][same], ref["normal"][same],
                               atol=1e-5)
    np.testing.assert_allclose(got["color"][same], ref["color"][same],
                               atol=2e-3)
    assert np.isfinite(got["color"]).all()
    if backend == "raster":
        assert int(got["raster_overflow_tiles"]) == 0


def test_direct_frame_shadows_darken(direct_frames):
    """The brute-force shadow rays remove light: the shadowed frame is
    nowhere brighter than the frame without shadows, and darker
    somewhere."""
    from vri_tpu_torch.passes import frame as tframe

    tr = _port_renderer(DIRECT_RES)
    fp = tframe.FrameParams.from_camera(tr.camera, DIRECT_RES, device="cpu")
    lit = tframe.render_frame(tr.scene, fp, height=DIRECT_RES,
                              width=DIRECT_RES, shadows=False)["color"]
    shadowed = torch.as_tensor(direct_frames["brute"][1]["color"])
    assert bool((shadowed <= lit + 1e-6).all())
    assert bool((shadowed < lit - 1e-3).any())


@pytest.mark.parametrize("argv", [["--multichip"]])
def test_app_refuses_unported_flags(argv, monkeypatch):
    """Every flag of ``python -m vri_tpu_torch.app`` is ported; the sharded
    frame (``--multichip``) renders on the card only: on a host without
    one its mesh refuses to start, before the app loads anything (no
    fallback to the CPU)."""
    from vri_tpu_torch import app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        app.main(argv)


@pytest.mark.parametrize("argv", [["--no-gi"], ["--backend", "bvh"],
                                  ["--no-gi", "--backend", "bvh"],
                                  ["--mode", "sdf_distance"], ["--lod", "2"],
                                  ["--builtin", "animated"],
                                  ["--cache", "scene.cache"],
                                  ["--trace", "trace_dir"],
                                  ["--sdf", "tiny"], ["--multichip"]])
def test_app_takes_ported_flags(argv):
    """The direct-only frame, the BVH backend, the SDF debug views, LOD
    chains, the animated builtin, the scene cache, the profiler trace,
    the tiny preset's dense SDF build and the sharded frame parse and are
    ported."""
    from vri_tpu_torch import app

    args = app.parse_args(argv)
    assert args.multichip == ("--multichip" in argv)
    assert args.no_gi == ("--no-gi" in argv)
    assert args.backend == ("bvh" if "bvh" in argv else "raster")
    assert args.mode == (argv[1] if "--mode" in argv else "none")
    assert args.lod == (int(argv[1]) if "--lod" in argv else 0)
    assert args.builtin == (argv[1] if "--builtin" in argv else "cornell")


# -- the frame's spans -----------------------------------------------------------

#: a small kitchen with a sparse two-cascade SDF and room for the bounded
#: update of one prop
SPAN_SDF = vri_tpu_torch.SDFConfig(
    num_cascades=2, cascade_resolution=16, brick_size=8, max_bricks=8192,
    base_voxel_size=0.3, truncation_voxels=1.0, max_triangles_per_brick=16,
    march_max_steps=64, update_cell_cap=4096, update_brick_cap=8192,
    update_tri_cap=4096)
STAGES = ["visibility", "gbuffer", "direct", "indirect", "history"]


def _kitchen_frame_args(entry):
    """A frame call of ``entry`` on the small kitchen at 32x48 (the
    dynamic frame marks the smallest prop dirty over its own box)."""
    import torch

    from vri_tpu_torch.passes import frame as tframe

    r = Renderer(vri_tpu_torch.RenderConfig(width=48, height=32,
                                            sdf=SPAN_SDF), device="cpu")
    r.load_stage(vri_tpu_torch.scenes.kitchen_stress(num_objects=6, seed=7,
                                                     tess=2))
    cas = r.ensure_cascades()
    s = r.scene
    fp = tframe.FrameParams.from_camera(r.camera, 32, device="cpu")
    state = tframe.init_temporal(32, 48, 2, device="cpu")
    # the build's own configuration: its list caps scaled to the demand
    cfg = r._sdf_cfg_effective or SPAN_SDF
    kw = dict(height=32, width=48, config=cfg, samples=1, gi_scale=2,
              use_cache=True, uniforms=torch.rand((1, 16 * 24, 2)))
    if entry == "temporal":
        return lambda: tframe.render_frame_gi_temporal(s, fp, cas, state,
                                                       **kw)
    ni = int(s.num_instances)
    lo, hi = s.instance_aabb_lo[:ni], s.instance_aabb_hi[:ni]
    k = int(torch.argmin((hi - lo).amax(-1)))
    dlo = torch.full((2, 3), 3.0e38)
    dhi = torch.full((2, 3), -3.0e38)
    dlo[0], dhi[0] = lo[k], hi[k]
    dirty = s.tri_instance == k
    return lambda: tframe.render_frame_gi_dynamic(
        s, fp, cas, r._build_state, state, dirty, dlo, dhi, **kw)


@pytest.mark.parametrize("entry", ["temporal", "dynamic"])
def test_frame_span_tree(entry):
    """Each call of a production frame records one ``frame`` root whose
    children are its stages in order (the dynamic frame's SDF update and
    re-bake first), every span of the call sharing the root's frame id
    and lying inside its parent."""
    from vri_tpu_torch.runtime import profiler

    call = _kitchen_frame_args(entry)
    profiler.start_recording()
    try:
        call()
        call()
    finally:
        recs = profiler.stop_recording()
    roots = [i for i, r in enumerate(recs) if r.parent == -1]
    assert [recs[i].name for i in roots] == ["frame", "frame"]
    assert [recs[i].frame for i in roots] == [0, 1]
    want = (["sdf_update", "rebake"] if entry == "dynamic" else []) + STAGES
    for i in roots:
        assert [r.name for r in recs if r.parent == i] == want
    names = {r.name for r in recs}
    assert ("sdf.emit" in names) == (entry == "dynamic")
    for i, r in enumerate(recs):
        assert r.host_start_ns < r.host_end_ns
        assert r.device_start_s is None and r.device_end_s is None
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.host_start_ns <= r.host_start_ns
            assert r.host_end_ns <= p.host_end_ns
            assert r.frame == p.frame and r.parent < i
