"""The port's bounded SDF update, clipmap scroll, lighting-dirty mask and
partial radiance bake (``vri_tpu_torch.ops.sdf_build.update_cascades`` /
``scroll_cascades``, ``ops.sdf.lighting_dirty_bricks`` /
``bake_brick_lighting_partial``) against ``vri_tpu``'s.

The configuration is ``tests/test_sdf_build.py``'s ``CFG`` (2 cascades,
r 32) on the Cornell box.  The JAX package builds and bakes the cascades
once and both sides start every path from that one state: the port gets
the arrays through ``cascades_from_numpy`` and ``build_state_from_numpy``
and the same world vertices (``bake_world`` of the two packages differs by
float32 ulps).  The moves are ``tests/test_sdf_build.py``'s: the smallest
instance by (0.15, 0, 0.1), and instance 3 (a wall) by (0.25, 0.1, 0) at
``update_cell_cap=8``; the scroll recenters on (0.35, 0, 0.25).  The JAX
side runs in a subprocess whose XLA:CPU has no fused multiply-add
(``--xla_cpu_max_isa=AVX``), as ``tests/test_torch_sdf_build.py``'s crowded
cases do, and marches shadow rays with K3 interpreted
(``tests/test_torch_frame.py``'s ``_tpu_occlusion``), the kernel the port's
``march_rays`` replaces.  Tolerances, and why:

* Against the JAX functions, exactly equal: ``brick_map``, ``alive``,
  ``brick_voxel``, ``num_bricks``, ``overflow``, ``near_drop``,
  ``cell_tris``, ``cell_count``, ``glob_tris``, ``list_overflow``,
  ``emit_bricks`` and ``needs_full`` (integer results of the same
  binning, sorts, free-slot order and tests), and the atlas, albedo,
  emissive and normal payloads (the same float32 operations, neither side
  contracting).  ``needs_full`` at ``update_cell_cap=8`` is non-zero on
  both sides and equal.
* The lighting-dirty mask exactly equal; eight dead pad boxes flag nothing.
* The partial bake: visibility exactly equal and irradiance within 1e-6
  (the light sums of ``direct_radiance_analytic`` round in another order
  than XLA's reduction), ``dropped`` equal at ``cap=4``; against the
  port's own full bake of the updated cascades, irradiance, visibility
  and ``voxel_shade`` bit-equal (every point's march is independent of
  the others).
* The port's scroll also re-emits the surviving cells beside the moved
  window edges, which the JAX package's keeps as they were emitted from
  the old window's candidates; it runs with ``update_cell_cap`` raised to
  hold them.  Against the JAX scroll every field above is exactly equal
  but for those bricks' ``emit_bricks``, atlas, albedo, emissive and
  normal, which equal a fresh port build's at the new centers per voxel.
* The port's update against the port's own full build at the moved
  vertices: voxel-equal (occupancy, ESD, atlas and albedo per voxel) with
  equal march tables.  The scroll against a fresh port build at the new
  centers, both without scene colours as ``tests/test_sdf_build.py``
  holds the JAX scroll: occupancy and ESD equal, atlas within 2e-6 plus
  one u8 step and albedo within 2e-6 (surviving bricks keep content
  computed at the old origin), and per cell the two reference lists nest.
  With scene colours a surviving brick's albedo can differ from the fresh
  build's where its nearest candidates tie in AABB distance (the
  candidates come in the old window's list order): 39 bricks of the JAX
  scroll on this stage, so that contract is held without colours.
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
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.ops import sdf_build as tbuild  # noqa: E402
from vri_tpu_torch.registry import scene_from_numpy  # noqa: E402

#: tests/test_sdf_build.py's CFG
CFG_ARGS = dict(num_cascades=2, cascade_resolution=32, base_voxel_size=0.1,
                max_bricks=8192, truncation_voxels=2.0,
                max_triangles_per_brick=16, update_cell_cap=2048,
                update_brick_cap=8192, update_tri_cap=512)
TCFG = vri_tpu_torch.SDFConfig(**CFG_ARGS)
TINY_ARGS = dict(CFG_ARGS, update_cell_cap=8)
SCROLL_TO = (0.35, 0.0, 0.25)
CAS_FIELDS = ("brick_map", "brick_voxel", "num_bricks", "overflow",
              "near_drop", "atlas", "brick_albedo", "brick_emissive",
              "brick_normal", "march_coarse", "march_fine0", "march_fine1",
              "center", "voxel_size", "brick_irradiance", "brick_light_vis",
              "voxel_shade")
STATE_FIELDS = ("cell_tris", "cell_count", "cell_rows", "glob_tris",
                "glob_rows", "alive", "list_overflow", "emit_bricks")
EXACT = ("brick_map", "alive", "brick_voxel", "num_bricks", "overflow",
         "near_drop", "cell_tris", "cell_count", "glob_tris",
         "list_overflow", "emit_bricks", "atlas", "brick_albedo",
         "brick_emissive", "brick_normal", "march_coarse")
#: per-brick fields the port's scroll re-emits in the edge layers
EDGE_FIELDS = ("emit_bricks", "atlas", "brick_albedo", "brick_emissive",
               "brick_normal")


def _jax_scene():
    d = RenderDelegate(RenderConfig(width=32, height=32))
    d.populate(scenes.cornell_box())
    s = d.sync()
    return s, np.asarray(jbake_world(s))


def _move(s, world, inst, offset):
    """World vertices with instance ``inst`` moved by ``offset``, its
    dirty-triangle mask and dirty boxes (old and new AABB, two dead pad
    rows), as tests/test_sdf_build.py's ``_move_instance``."""
    ti = np.asarray(s.tri_instance)
    mask = (ti == inst) & (np.arange(ti.shape[0]) < int(s.num_faces))
    vi = np.asarray(s.tri_vertices)
    w1 = world.copy()
    w1[np.unique(vi[mask])] += np.asarray(offset, np.float32)
    dlo = np.full((4, 3), 3.0e38, np.float32)
    dhi = np.full((4, 3), -3.0e38, np.float32)
    dlo[0], dhi[0] = world[vi[mask]].min((0, 1)), world[vi[mask]].max((0, 1))
    dlo[1], dhi[1] = w1[vi[mask]].min((0, 1)), w1[vi[mask]].max((0, 1))
    return w1, mask, dlo, dhi


def _smallest_instance(s):
    ni = int(s.num_instances)
    ext = (np.asarray(s.instance_aabb_hi)
           - np.asarray(s.instance_aabb_lo))[:ni].max(-1)
    return int(np.argmin(ext))


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _reference():
    """The JAX side as numpy arrays keyed ``<case>/<field>``."""
    import jax.numpy as jnp

    import test_torch_frame as F
    from vri_tpu.config import SDFConfig
    from vri_tpu.ops import sdf as jsdf
    from vri_tpu.ops import sdf_build as jbuild
    from vri_tpu.ops import sdf_trace as jtrace

    cfg = SDFConfig(**CFG_ARGS)
    s, world = _jax_scene()
    out = {}

    def keep(case, cas=None, st=None, **extra):
        for f in CAS_FIELDS if cas is not None else ():
            if getattr(cas, f) is not None:
                out[f"{case}/{f}"] = _np(getattr(cas, f))
        for f in STATE_FIELDS if st is not None else ():
            out[f"{case}/{f}"] = _np(getattr(st, f))
        out.update({f"{case}/{k}": _np(v) for k, v in extra.items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "occlusion", F._tpu_occlusion)
        centers = jsdf.default_centers(cfg, jnp.zeros(3))
        cas0, st0 = jbuild.build_for_scene(s, jnp.asarray(world), centers,
                                           cfg)
        cas0 = jsdf.bake_brick_lighting(cas0, s, config=cfg, alive=st0.alive)
        keep("build", cas0, st0)

        w1, mask, dlo, dhi = _move(s, world, _smallest_instance(s),
                                   (0.15, 0.0, 0.1))
        args = [jnp.asarray(x) for x in (w1, mask, dlo, dhi)]
        cas1, st1, nf = jbuild.update_for_scene(cas0, st0, s, *args, cfg)
        keep("update", cas1, st1, needs_full=nf)
        light = jsdf.lighting_dirty_bricks(cas1, s, args[2], args[3],
                                           config=cfg)
        par, drop = jsdf.bake_brick_lighting_partial(
            cas1, s, st1.emit_bricks | light, st1.alive, config=cfg,
            cap=cfg.bake_brick_cap)
        _, drop4 = jsdf.bake_brick_lighting_partial(
            cas1, s, st1.emit_bricks | light, st1.alive, config=cfg, cap=4)
        keep("bake", par, None, light=light, dropped=drop, dropped4=drop4)

        tiny = SDFConfig(**TINY_ARGS)
        args = [jnp.asarray(x) for x in _move(s, world, 3, (0.25, 0.1, 0.0))]
        _, _, nf = jbuild.update_for_scene(cas0, st0, s, *args, tiny)
        keep("tiny", needs_full=nf)

        c1 = jsdf.default_centers(cfg, jnp.asarray(SCROLL_TO))
        scrolled = tuple(bool(x) for x in
                         np.any(np.asarray(c1) != np.asarray(centers), -1))
        cas2, st2, nf = jbuild.scroll_for_scene(
            cas0, st0, s, jnp.asarray(world), c1, scrolled, cfg)
        keep("scroll", cas2, st2, needs_full=nf,
             scrolled=np.asarray(scrolled))
        # the build without scene colours (every brick's albedo 0.5), the
        # start of tests/test_sdf_build.py's scroll contract
        keep("gray", *jbuild.build_cascades_binned(
            jnp.asarray(world), s.tri_vertices, s.num_faces, centers,
            config=cfg))
    return out


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_sdf_update as T
np.savez(sys.argv[1], **T._reference())
"""


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(reference arrays, port scene, JAX world vertices, port results):
    the port's update, scroll and bakes started from the JAX build."""
    path = tmp_path_factory.mktemp("sdf_update") / "ref.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    proc = subprocess.run([sys.executable, "-c", _NO_FMA_REFERENCE,
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))

    s, world = _jax_scene()
    ts = scene_from_numpy({f.name: np.asarray(getattr(s, f.name))
                           for f in dataclasses.fields(s)
                           if f.name != "mip_atlas"
                           and getattr(s, f.name) is not None}, "cpu")

    def case(name):
        return {k.split("/", 1)[1]: v for k, v in ref.items()
                if k.startswith(name + "/")}
    build = case("build")
    cas0 = tsdf.cascades_from_numpy(build, "cpu")
    st0 = tsdf.build_state_from_numpy(build, "cpu")
    got = {}
    w1, mask, dlo, dhi = (torch.as_tensor(x) for x in _move(
        s, world, _smallest_instance(s), (0.15, 0.0, 0.1)))
    got["update"] = tbuild.update_for_scene(cas0, st0, ts, w1, mask, dlo,
                                            dhi, TCFG)
    cas1, st1, _ = got["update"]
    light = tsdf.lighting_dirty_bricks(cas1, ts, dlo, dhi, config=TCFG)
    got["bake"] = (light, *tsdf.bake_brick_lighting_partial(
        cas1, ts, st1.emit_bricks | light, st1.alive, config=TCFG,
        cap=TCFG.bake_brick_cap))
    got["dropped4"] = tsdf.bake_brick_lighting_partial(
        cas1, ts, st1.emit_bricks | light, st1.alive, config=TCFG, cap=4)[1]
    got["full_bake"] = tsdf.bake_brick_lighting(cas1, ts, config=TCFG,
                                                alive=st1.alive)
    got["rebuild"] = tbuild.build_for_scene(ts, w1, cas0.center, TCFG)
    tiny = vri_tpu_torch.SDFConfig(**TINY_ARGS)
    args = [torch.as_tensor(x) for x in _move(s, world, 3, (0.25, 0.1, 0.0))]
    got["tiny"] = tbuild.update_for_scene(cas0, st0, ts, *args, tiny)[2]
    c1 = tsdf.default_centers(TCFG, SCROLL_TO, device="cpu")
    scrolled = tuple(bool(x) for x in case("scroll")["scrolled"])
    tw = torch.as_tensor(world)
    # the port's scroll also re-emits the surviving cells beside the moved
    # window edges, past the JAX package's update_cell_cap on this
    # two-cascade, two-axis move
    wide = dataclasses.replace(TCFG, update_cell_cap=2 * 4096)
    got["scroll"] = tbuild.scroll_for_scene(cas0, st0, ts, tw, c1, scrolled,
                                            wide)
    got["fresh"] = tbuild.build_for_scene(ts, tw, c1, TCFG)
    got["edges"] = _edge_bricks(got["scroll"][0], cas0.center)
    gray = case("gray")
    got["scroll_gray"] = tbuild.scroll_cascades(
        tsdf.cascades_from_numpy(gray, "cpu"),
        tsdf.build_state_from_numpy(gray, "cpu"), c1, tw, ts.tri_vertices,
        ts.num_faces, config=wide, scrolled=scrolled)
    got["fresh_gray"] = tbuild.build_cascades_binned(
        tw, ts.tri_vertices, ts.num_faces, c1, config=TCFG)
    return ref, case, got


def _edge_bricks(cas, old_centers) -> torch.Tensor:
    """(max_bricks,) bool: the live bricks of the scrolled cascades ``cas``
    in the surviving cells beside a window edge the scroll from
    ``old_centers`` moved (``sdf_build._edge_cells``), which the port's
    scroll re-emits and the JAX package's keeps."""
    r = TCFG.cascade_resolution
    s = r // 16
    cw = cas.voxel_size * s
    dc = torch.round((cas.center - old_centers) / cw[:, None]).long()
    edge = torch.stack([tbuild._edge_cells(d.tolist(), "cpu") for d in dc])
    bv = cas.brick_voxel.long()
    rem = bv % r ** 3
    z, y, x = rem // (r * r) // s, rem // r % r // s, rem % r // s
    slots = torch.arange(bv.shape[0], dtype=torch.int32)
    return edge[bv // r ** 3, z, y, x] & (cas.brick_map.reshape(-1)[bv]
                                          == slots)


def _field(cas, st, name):
    obj = st if name in STATE_FIELDS else cas
    return getattr(obj, name).numpy()


@pytest.mark.parametrize("name", EXACT)
@pytest.mark.parametrize("path", ["update", "scroll"])
def test_path_matches_reference_exactly(sides, path, name):
    _, case, got = sides
    ref = case(path)
    cas, st, _ = got[path]
    want = ref[name]
    have = _field(cas, st, name).reshape(want.shape)
    if name == "emit_bricks":
        print(f"{path}: {int(want.sum())} bricks re-emitted, "
              f"{int(ref['num_bricks'])} live")
    if path == "scroll" and name in EDGE_FIELDS:
        # the edge layers' bricks: test_scroll_edge_layers_match_fresh_build
        keep = ~got["edges"].numpy()
        have, want = have[keep], want[keep]
    np.testing.assert_array_equal(have, want, err_msg=f"{path} {name}")


@pytest.mark.parametrize("path", ["update", "scroll", "tiny"])
def test_needs_full_matches_reference(sides, path):
    _, case, got = sides
    have = got[path] if path == "tiny" else got[path][2]
    want = int(case(path)["needs_full"])
    print(f"{path}: needs_full {int(have)}")
    assert int(have) == want
    assert (want > 0) == (path == "tiny")


def test_lighting_dirty_mask_matches_reference(sides):
    _, case, got = sides
    want = case("bake")["light"]
    have = got["bake"][0].numpy()
    print(f"lighting-dirty bricks: {int(have.sum())} of {have.size}")
    np.testing.assert_array_equal(have, want)


def test_dead_pad_boxes_flag_nothing(sides):
    """Inverted (+BIG/-BIG) pad boxes flag no brick; one real box flags a
    bounded subset (``tests/test_sdf_build.py``)."""
    _, _, got = sides
    cas = got["update"][0]
    scene = _port_scene()
    dlo = torch.full((8, 3), 3.0e38)
    dhi = torch.full((8, 3), -3.0e38)
    assert int(tsdf.lighting_dirty_bricks(cas, scene, dlo, dhi,
                                          config=TCFG).sum()) == 0
    dlo[0], dhi[0] = -0.3, 0.3
    n = int(tsdf.lighting_dirty_bricks(cas, scene, dlo, dhi,
                                       config=TCFG).sum())
    assert 0 < n < cas.atlas.shape[0]


def _port_scene():
    s, _ = _jax_scene()
    return scene_from_numpy({f.name: np.asarray(getattr(s, f.name))
                             for f in dataclasses.fields(s)
                             if f.name != "mip_atlas"
                             and getattr(s, f.name) is not None}, "cpu")


def test_partial_bake_matches_reference(sides):
    _, case, got = sides
    ref = case("bake")
    _, par, dropped = got["bake"]
    assert int(dropped) == int(ref["dropped"]) == 0
    np.testing.assert_array_equal(par.brick_light_vis.numpy(),
                                  ref["brick_light_vis"])
    err = np.abs(par.brick_irradiance.numpy()
                 - ref["brick_irradiance"]).max()
    print(f"partial bake: irradiance at most {err:.1e} from the reference")
    np.testing.assert_allclose(par.brick_irradiance.numpy(),
                               ref["brick_irradiance"], rtol=0, atol=1e-6)
    assert int(got["dropped4"]) == int(ref["dropped4"]) > 0


def test_partial_bake_equals_full_bake(sides):
    _, _, got = sides
    _, par, _ = got["bake"]
    full = got["full_bake"]
    for f in ("brick_irradiance", "brick_light_vis", "voxel_shade"):
        assert torch.equal(getattr(par, f), getattr(full, f)), f


def _voxel_fields(cas):
    bm = cas.brick_map.reshape(-1).numpy()
    occ = bm >= 0
    ids = bm[occ]
    return (occ, np.where(occ, 0, bm.clip(max=0)),
            cas.atlas.numpy()[ids].astype(np.float32) / 255.0,
            cas.brick_albedo.numpy()[ids])


def test_update_matches_port_full_build(sides):
    _, _, got = sides
    cas, _, _ = got["update"]
    ref, _ = got["rebuild"]
    assert int(cas.num_bricks) == int(ref.num_bricks)
    a, b = _voxel_fields(cas), _voxel_fields(ref)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for f in ("march_coarse", "march_fine0", "march_fine1"):
        assert torch.equal(getattr(cas, f), getattr(ref, f)), f


def test_scroll_matches_port_fresh_build(sides):
    _, _, got = sides
    cas, st, _ = got["scroll_gray"]
    ref, refst = got["fresh_gray"]
    a, b = _voxel_fields(cas), _voxel_fields(ref)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert np.abs(a[2] - b[2]).max() <= 2e-6 + 1.0 / 255.0
    assert np.abs(a[3] - b[3]).max() <= 2e-6
    at, bt = st.cell_tris.numpy(), refst.cell_tris.numpy()
    differ = 0
    for n in range(at.shape[0]):
        for cell in np.argwhere((at[n] != bt[n]).any(-1)).ravel():
            sa = set(at[n, cell][at[n, cell] >= 0].tolist())
            sb = set(bt[n, cell][bt[n, cell] >= 0].tolist())
            differ += 1
            assert sa <= sb or sb <= sa, (n, cell, sa, sb)
    print(f"scroll: {differ} cell lists differ from the fresh build's, "
          "each nesting")


def test_scroll_edge_layers_match_fresh_build(sides):
    """The bricks the port's scroll re-emits beside the moved window edges
    (and the JAX package's keeps): each voxel's atlas, albedo, emissive
    and normal equal the port's fresh build's at the new centers."""
    _, _, got = sides
    cas, st, _ = got["scroll"]
    ref, _ = got["fresh"]
    edge = got["edges"]
    emitted = st.emit_bricks
    print(f"scroll: {int(edge.sum())} edge-layer bricks, "
          f"{int(emitted.sum())} emitted")
    assert int(edge.sum()) > 0 and bool(emitted[edge].all())
    vox = cas.brick_voxel[edge].long()
    ids = ref.brick_map.reshape(-1)[vox].long()
    assert bool((ids >= 0).all())
    for f in ("atlas", "brick_albedo", "brick_emissive", "brick_normal"):
        a, b = getattr(cas, f)[edge], getattr(ref, f)[ids]
        print(f"{f}: {int((a != b).reshape(a.shape[0], -1).any(1).sum())} "
              "bricks differ")
        assert torch.equal(a, b), f
