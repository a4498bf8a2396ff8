"""The port's runtime layer (``vri_tpu_torch.runtime``: the scene cache,
scene validation, the profiler), ``render_to_numpy`` and the app's
``--cache``, ``--trace`` and ``--sdf tiny``, against ``vri_tpu``'s
(``tests/test_runtime.py``, ``tests/test_materials_checks.py``).

* The cache round trip renders identically: the Cornell box saved and
  loaded into a fresh registry renders the same instance ids on at least
  99.5% of the pixels at 48^2 (uint16 quantization may flip edge pixels),
  with colour within 5e-2 / 2e-2 where they agree, as the JAX test holds
  its own round trip.
* Interchange: a cache written by ``vri_tpu`` loads in the port to a
  ``SceneBuffers`` exactly equal, field by field, to the one ``vri_tpu``
  loads from it, and a cache written by the port loads in ``vri_tpu`` to
  the scene the port loads from it.  Both packages build the native
  quantizer from ``native/src``, so the positions are bit-equal.
* The format version is the JAX package's (3) and a mismatch raises.
* ``validate_scene`` gives the JAX package's findings, in order and word
  for word, on the clean Cornell box, with a NaN position, with an
  out-of-range triangle index and on a stage without lights; a NaN
  raises ``SceneValidationError`` on request.
* The profiler on the CPU: ``span`` / ``FrameStats``, a trace started and
  stopped around a span writes a Chrome trace that holds the span, and
  ``device_memory_stats`` is empty without a card.
* ``render_to_numpy`` on the CPU: numpy AOVs equal to ``render_frame``'s
  and instance ids equal to ``vri_tpu``'s on at least 99% of the pixels.
* ``python -m vri_tpu_torch.app`` at 32^2, its renderer forced onto the
  CPU: ``--cache`` writes the cache on the first run and reads it on the second,
  ``--trace`` writes a trace holding the ``frame0`` span, ``--sdf tiny``
  renders GI frames through the dense SDF build; each exits 0 and writes
  its PNGs.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import vri_tpu_torch  # noqa: E402
from vri_tpu.config import RenderConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.runtime import cache as jcache  # noqa: E402
from vri_tpu.runtime import checks as jchecks  # noqa: E402
from vri_tpu.usd import Stage, scenes  # noqa: E402
from vri_tpu_torch.hydra.delegate import RenderDelegate as TDelegate  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import scene_from_numpy  # noqa: E402
from vri_tpu_torch.runtime import cache, checks, profiler  # noqa: E402

STAGES = {"cornell": (scenes.cornell_box, vri_tpu_torch.scenes.cornell_box),
          "kitchen": (lambda: scenes.kitchen_stress(num_objects=8, tess=1),
                      lambda: vri_tpu_torch.scenes.kitchen_stress(
                          num_objects=8, tess=1))}


def _port_delegate(res=48):
    return TDelegate(vri_tpu_torch.RenderConfig(width=res, height=res),
                     device="cpu")


def _jax_delegate(res=48):
    return RenderDelegate(RenderConfig(width=res, height=res))


def _fields(scene, to_np):
    return {f.name: to_np(getattr(scene, f.name))
            for f in dataclasses.fields(scene)
            if f.name not in ("mip_atlas", "base_pool_len")
            and getattr(scene, f.name) is not None}


def _assert_same_scene(jscene, tscene):
    want = _fields(jscene, np.asarray)
    got = _fields(tscene, lambda t: t.cpu().numpy())
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# -- the scene cache -----------------------------------------------------------

def test_cache_roundtrip_renders_identically(tmp_path):
    d = _port_delegate()
    d.populate(vri_tpu_torch.scenes.cornell_box())
    scene = d.sync()
    p = str(tmp_path / "scene.npz")
    cache.save_scene_cache(d.registry, p)
    assert os.path.exists(p)

    d2 = _port_delegate()
    cache.load_scene_cache(d2.registry, p)
    scene2 = d2.registry.commit()
    for name in ("num_faces", "num_instances", "num_lights"):
        assert int(getattr(scene2, name)) == int(getattr(scene, name))
    fp = tframe.FrameParams.from_camera(d.camera, device="cpu")
    kw = dict(height=48, width=48, shadows=False, backend="brute")
    a = tframe.render_frame(scene, fp, **kw)
    b = tframe.render_frame(scene2, fp, **kw)
    same = (a["instance_id"] == b["instance_id"]).numpy()
    print(f"cache round trip: instance ids equal on {same.mean():.4f}")
    assert same.mean() > 0.995
    np.testing.assert_allclose(a["color"].numpy()[same],
                               b["color"].numpy()[same], atol=5e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("stage", list(STAGES))
def test_jax_cache_loads_in_port(tmp_path, stage):
    d = _jax_delegate()
    d.populate(STAGES[stage][0]())
    d.sync()
    p = str(tmp_path / "jax.npz")
    jcache.save_scene_cache(d.registry, p)
    dj = _jax_delegate()
    jcache.load_scene_cache(dj.registry, p)
    dt = _port_delegate()
    cache.load_scene_cache(dt.registry, p)
    _assert_same_scene(dj.registry.commit(), dt.registry.commit())


@pytest.mark.parametrize("stage", list(STAGES))
def test_port_cache_loads_in_jax(tmp_path, stage):
    d = _port_delegate()
    d.populate(STAGES[stage][1]())
    d.sync()
    p = str(tmp_path / "port.npz")
    cache.save_scene_cache(d.registry, p)
    dj = _jax_delegate()
    jcache.load_scene_cache(dj.registry, p)
    dt = _port_delegate()
    cache.load_scene_cache(dt.registry, p)
    _assert_same_scene(dj.registry.commit(), dt.registry.commit())


def test_version_check(tmp_path):
    assert cache._FORMAT_VERSION == jcache._FORMAT_VERSION == 3
    d = _port_delegate(16)
    d.populate(vri_tpu_torch.scenes.cornell_box())
    d.sync()
    p = str(tmp_path / "scene.npz")
    cache.save_scene_cache(d.registry, p)
    cache._FORMAT_VERSION += 1
    try:
        with pytest.raises(ValueError, match="version"):
            cache.load_scene_cache(_port_delegate(16).registry, p)
    finally:
        cache._FORMAT_VERSION -= 1


# -- scene validation ----------------------------------------------------------

def _check_scene(kind):
    """The JAX scene of one validation case."""
    from test_materials_checks import MTLX_STAGE

    d = _jax_delegate(16)
    d.populate(Stage.from_string(MTLX_STAGE) if kind == "no_light"
               else scenes.cornell_box())
    s = d.sync()
    if kind == "nan":
        s = s.replace(positions=s.positions.at[0, 0].set(float("nan")))
    elif kind == "bad_index":
        s = s.replace(tri_vertices=s.tri_vertices.at[0, 0].set(10 ** 6))
    return s


@pytest.mark.parametrize("kind", ["clean", "nan", "bad_index", "no_light"])
def test_validate_scene_matches_reference(kind):
    s = _check_scene(kind)
    ts = scene_from_numpy(_fields(s, np.asarray), "cpu")
    want = [(f.severity, f.message) for f in jchecks.validate_scene(s)]
    got = [(f.severity, f.message) for f in checks.validate_scene(ts)]
    print(f"{kind}: {got}")
    assert got == want
    errors = any(sev == "error" for sev, _ in want)
    assert errors == (kind in ("nan", "bad_index"))
    if errors:
        with pytest.raises(checks.SceneValidationError):
            checks.validate_scene(ts, raise_on_error=True)


# -- profiler ------------------------------------------------------------------

def test_span_trace_and_stats(tmp_path):
    fs = profiler.FrameStats()
    profiler.start_trace(str(tmp_path))
    with profiler.span("vri_test_span", log_ms=True):
        torch.ones(64).sum()
        fs.tick()
        fs.tick()
    path = profiler.stop_trace()
    assert fs.fps > 0 and "fps" in fs.summary()
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "vri_test_span" in names
    with pytest.raises(RuntimeError):
        profiler.stop_trace()
    if not torch.cuda.is_available():
        assert profiler.device_memory_stats() == {}


def test_spans_off_are_free_and_unseen():
    """With neither a trace nor a recording running a span is the shared
    null context: nothing is recorded, and a bare ``torch.profiler`` run
    sees no span name."""
    assert profiler.span("vri_off") is profiler.span("other")
    frame = profiler.frame_root(lambda: torch.ones(8).sum())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("vri_off_span"):
            frame()
    names = {e.key for e in prof.key_averages()}
    assert "aten::sum" in names
    assert not names & {"vri_off_span", "frame"}
    profiler.start_recording()
    recs = profiler.stop_recording()
    assert recs == []


def test_recording_keeps_the_span_tree():
    """Spans recorded in memory: parents, one frame id a frame, one root
    however deep the frame functions nest, spans outside a frame at -1,
    and a span still open when the recording stops ended then."""
    @profiler.frame_root
    def outer():
        with profiler.span("a"):
            with profiler.span("b"):
                pass
        with profiler.span("c"):
            pass

    @profiler.frame_root
    def stops():
        outer()
        with profiler.span("open"):
            return profiler.stop_recording()

    profiler.start_recording()
    with pytest.raises(RuntimeError):
        profiler.start_recording()
    outer()
    with profiler.span("outside"):
        pass
    recs = stops()
    with pytest.raises(RuntimeError):
        profiler.stop_recording()
    got = [(r.name, r.parent, r.frame) for r in recs]
    assert got == [("frame", -1, 0), ("a", 0, 0), ("b", 1, 0), ("c", 0, 0),
                   ("outside", -1, -1), ("frame", -1, 1), ("a", 5, 1),
                   ("b", 6, 1), ("c", 5, 1), ("open", 5, 1)]
    assert all(r.host_end_ns >= r.host_start_ns > 0 for r in recs)
    # the spans open at the stop ended then; a later frame opens a root
    assert recs[-1].host_end_ns >= recs[-2].host_end_ns
    assert recs[5].host_end_ns >= recs[-1].host_end_ns
    assert profiler.span("x") is profiler.span("y")
    profiler.start_recording()
    outer()
    assert [r.name for r in profiler.stop_recording()] == [
        "frame", "a", "b", "c"]


def test_sparse_build_records_emit_and_bake():
    """The sparse SDF build of a small kitchen records one ``sdf.emit``
    (its bricks) and one ``sdf.bake`` (the radiance bake)."""
    from vri_tpu_torch import RenderConfig as TConfig
    from vri_tpu_torch import SDFConfig as TSDF
    from vri_tpu_torch import scenes as tscenes
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.renderer import Renderer

    cfg = TSDF(num_cascades=2, cascade_resolution=16, base_voxel_size=0.3,
               truncation_voxels=1.0, max_bricks=8192)
    assert sdf_build.supports(cfg)
    r = Renderer(TConfig(width=32, height=24, sdf=cfg), device="cpu")
    r.load_stage(tscenes.kitchen_stress(num_objects=6, seed=7, tess=2))
    profiler.start_recording()
    try:
        r.ensure_cascades()
    finally:
        recs = profiler.stop_recording()
    assert r.last_build_label == "rebuilt"
    assert [(x.name, x.parent, x.frame) for x in recs] == [
        ("sdf.emit", -1, -1), ("sdf.bake", -1, -1)]


# -- render_to_numpy -------------------------------------------------------------

def test_render_to_numpy_matches():
    from vri_tpu.passes import frame as jframe

    d = _jax_delegate(32)
    d.populate(scenes.cornell_box())
    s = d.sync()
    cfg = RenderConfig(width=32, height=32)
    want = jframe.render_to_numpy(s, d.camera, cfg)
    ts = scene_from_numpy(_fields(s, np.asarray), "cpu")
    got = tframe.render_to_numpy(ts, d.camera, cfg, device="cpu")
    assert set(got) == set(want)
    assert all(isinstance(v, np.ndarray) for v in got.values())
    plain = tframe.render_frame(
        ts, tframe.FrameParams.from_camera(d.camera, device="cpu"),
        height=32, width=32)
    for k, v in plain.items():
        np.testing.assert_array_equal(got[k], v.numpy())
    same = (got["instance_id"] == want["instance_id"]).mean()
    print(f"render_to_numpy: instance ids equal on {same:.4f}")
    assert same >= 0.99


# -- the app --------------------------------------------------------------------

@pytest.fixture
def cpu_app(monkeypatch):
    """The app with its renderer forced onto the CPU (the app renders on
    the card)."""
    from vri_tpu_torch import app
    from vri_tpu_torch import renderer as renderer_mod

    class CpuRenderer(renderer_mod.Renderer):
        def __init__(self, config=None, device="cpu"):
            super().__init__(config, device="cpu")

    monkeypatch.setattr(renderer_mod, "Renderer", CpuRenderer)
    return app


def _app(app, tmp_path, tag, *argv):
    out = str(tmp_path / tag)
    rc = app.main(["--builtin", "cornell", "--width", "32", "--height", "32",
                   "--out", out, *argv])
    return rc, sorted(glob.glob(os.path.join(out, "*.png")))


def test_app_cache_writes_then_reads(tmp_path, monkeypatch, cpu_app):
    from vri_tpu_torch import renderer as renderer_mod

    p = str(tmp_path / "scene.cache.npz")
    rc, pngs = _app(cpu_app, tmp_path, "write", "--no-gi", "--cache", p)
    assert rc == 0 and len(pngs) == 1 and os.path.exists(p)
    loads = []
    real = renderer_mod.Renderer.load_stage
    monkeypatch.setattr(renderer_mod.Renderer, "load_stage",
                        lambda self, *a: loads.append(a) or real(self, *a))
    rc, pngs = _app(cpu_app, tmp_path, "read", "--no-gi", "--cache", p)
    assert rc == 0 and len(pngs) == 1
    assert loads == []          # the second run read the cache, no stage


def test_app_trace(tmp_path, cpu_app):
    trace_dir = str(tmp_path / "trace")
    rc, pngs = _app(cpu_app, tmp_path, "trace", "--no-gi", "--trace",
                    trace_dir)
    assert rc == 0 and len(pngs) == 1
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "frame" in names     # the program's root span of each frame


def test_app_sdf_tiny(tmp_path, cpu_app):
    rc, pngs = _app(cpu_app, tmp_path, "tiny", "--sdf", "tiny", "--frames",
                    "2", "--orbit")
    assert rc == 0 and len(pngs) == 2
