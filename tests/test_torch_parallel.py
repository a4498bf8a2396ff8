"""The port's multi-device rendering (``vri_tpu_torch.parallel``) against
``vri_tpu.parallel`` and against the port's own single-device frames.

The JAX side runs in a subprocess on four virtual CPU devices
(``--xla_force_host_platform_device_count=4``) whose XLA:CPU runs without
fused multiply-adds (``--xla_cpu_max_isa=AVX``), with the march patches of
``tests/test_torch_frame.py`` (K3 and K5 interpreted), as
``tests/test_torch_bands.py`` runs it.  It builds and bakes the cascades
of ``tests/test_torch_dynamic.py``'s ``TINY`` configuration (with
``update_brick_cap`` 1,024 and ``bake_brick_cap`` 4,096, so that the
sharded emit and re-bake split over several ranks and leave some empty)
on the Cornell box at 32 rows by 16 columns (``__graft_entry__.py``'s
dry-run shape), and renders every sharded function; every device's GI
uniforms (``uniform(fold_in(fold_in(key, dev), 0), ...)``) are handed to
the port's rank of the same index.  The port side runs once per module:
four ``gloo`` ranks on the CPU started by ``mesh.launch``, which carry the
JAX cascades across (``cascades_from_numpy``).  Checks:

* halo: ``exchange_halo``, ``exchange_halo_fill``, ``scroll_slab`` (shift
  0, 2, one slab, more than one slab; with and without halo planes) and
  ``esd_sharded`` equal to the JAX functions exactly;
* the static tiled frame (brute and raster, ``samples`` 0 and 1), the
  temporal frame (two frames of a vertical pan at ``gi_scale`` 1 with
  ``halo_rows`` 1 and at 2 with 2), the dynamic frame and the 2-D mesh's
  frame, with ``tests/test_torch_temporal.py``'s tolerances:
  ``instance_id`` equal on at least 99.5% of the pixels, ``color`` within
  2e-3 and ``gi_history`` within 1e-5 where the ids agree, the history
  state within 1e-4 there, ``stats`` exactly;
* the sharded update and re-bake: ``brick_map``, ``atlas`` and
  ``voxel_shade`` equal to the JAX sharded frame's, ``needs_full`` equal,
  and ``atlas`` and ``voxel_shade`` bit-equal to the port's
  single-device dynamic frame's;
* ``render_frame_gi_dynamic(shard_proxy=4)`` equal to the JAX proxy;
* ``merge_scene_partitions`` on a 2 x 2 mesh whose hosts hold garbage in
  the rows they do not own equal to the whole scene (the JAX merge of the
  replicated scene, itself);
* at world size 1 (one process, no process group) the tiled frames
  bit-equal to the single-device frames;
* ``python -m vri_tpu_torch.parallel.dryrun 4`` exits 0;
* ``ValueError`` for a height the ranks do not divide, and the refusal
  of an ``nccl`` mesh whose ranks share a card.
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
from vri_tpu_torch.ops import sdf as tsdf  # noqa: E402
from vri_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from vri_tpu_torch.parallel import tiling as ttiling  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import scene_from_numpy  # noqa: E402

N = 4
H, W = 32, 16
BAND = H // N
#: tests/test_torch_dynamic.py's TINY with caps that split the sharded
#: emit (426 bricks for the moved box: shares 256, 170, 0, 0) and re-bake
#: (3,098 bricks: shares 1,024, 1,024, 1,024, 26) unevenly
CFG_ARGS = dict(num_cascades=2, cascade_resolution=16, brick_size=8,
                max_bricks=8192, base_voxel_size=0.15,
                truncation_voxels=3.0, max_triangles_per_brick=16,
                march_max_steps=64, update_cell_cap=4096,
                update_brick_cap=1024, update_tri_cap=4096,
                bake_brick_cap=4096)
CFG = vri_tpu_torch.SDFConfig(**CFG_ARGS)
STATIC = [("brute", 0), ("brute", 1), ("raster", 0), ("raster", 1)]
TEMPORAL = [(1, 1), (2, 2)]        # (gi_scale, halo_rows)
SHIFTS = [0, 2, 8, 11]             # none, local, one slab, past one slab
FP_FIELDS = ("view_proj", "inv_view_proj", "eye", "near", "far",
             "pixel_spread")


def _halo_inputs():
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(32, 4, 4)).astype(np.float32)
    occ = np.random.default_rng(1).random((16, 16, 16)) < 0.04
    return vol, occ


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _band_uniforms(key, n_px: int):
    """Each device's GI uniforms of one sample: what JAX's lightloop draws
    from ``fold_in(key, dev)``."""
    import jax

    return {f"u{dev}": np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, dev), 0), (n_px, 2)))
        for dev in range(N)}


def _pan_cameras(aspect: float):
    """Two frames of a vertical pan, about 1.5 rows a frame at 32 rows."""
    from vri_tpu.hydra.camera import make_camera

    return [make_camera((0.0, 0.3 + 0.07 * i, 2.8), (0.0, 0.3 + 0.07 * i,
                                                     0.0), 45.0, aspect)
            for i in range(2)]


def _reference(part: str):
    """The JAX outputs this file checks, as numpy (see the module
    docstring), with the inputs the port needs: ``scene/``, ``build/``,
    the cameras ``fp/<name>/`` and the uniforms.  Part ``a`` holds the
    halo functions, the static frames and the 2-D mesh, part ``b`` the
    temporal and dynamic frames and the proxy; the two run at once in two
    processes, each building the same cascades."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    import test_torch_frame as F
    from vri_tpu.config import RenderConfig, SDFConfig
    from vri_tpu.hydra import RenderDelegate
    from vri_tpu.ops import sdf as jsdf
    from vri_tpu.ops import sdf_build as jbuild
    from vri_tpu.ops import sdf_trace as jtrace
    from vri_tpu.parallel import halo, make_mesh
    from vri_tpu.passes import frame as jframe
    from vri_tpu.registry import bake_world as jbake_world
    from vri_tpu.usd import scenes

    assert len(jax.devices()) == N
    cfg = SDFConfig(**CFG_ARGS)
    mesh = make_mesh(N)
    out = {}

    def put_fp(name, fp):
        for f in FP_FIELDS:
            out[f"fp/{name}/{f}"] = np.asarray(getattr(fp, f))

    if part == "a":
        # -- halo --------------------------------------------------------------
        vol, occ = _halo_inputs()

        slabs = vol.reshape(N, 8, 4, 4)
        z = np.zeros((N, 1, 4, 4), np.float32)
        padded = np.concatenate([z, slabs, z], 1).reshape(-1, 4, 4)

        def halo_ops(vol, padded, occ):
            res = {"exchange": halo.exchange_halo(padded, 1, "tiles"),
                   "fill": halo.exchange_halo_fill(vol, 2, "tiles", -1.0),
                   "scroll_halo": halo.scroll_slab(padded, 3, 1, "tiles"),
                   "esd": halo.esd_sharded(occ, "tiles", max_esd=6)}
            res.update({f"scroll{sh}": halo.scroll_slab(vol, sh, 0, "tiles")
                        for sh in SHIFTS})
            return res

        # one program for every halo function
        res = jax.jit(shard_map(halo_ops, mesh=mesh, in_specs=P("tiles"),
                                out_specs=P("tiles"), check_vma=False))(
            jnp.asarray(vol), jnp.asarray(padded), jnp.asarray(occ))
        out.update({"halo/" + k: np.asarray(v) for k, v in res.items()})

    d = RenderDelegate(RenderConfig(width=W, height=H))
    d.populate(scenes.cornell_box())
    s = d.sync()
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if v is not None and f.name != "mip_atlas":
            out[f"scene/{f.name}"] = np.asarray(v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrace, "march", F._tpu_march)
        mp.setattr(jtrace, "occlusion", F._tpu_occlusion)
        centers = jsdf.default_centers(cfg, jnp.zeros(3))
        cas, st = jbuild.build_for_scene(s, jbake_world(s), centers, cfg)
        cas = jsdf.bake_brick_lighting(cas, s, config=cfg, alive=st.alive)
        fp = jframe.FrameParams.from_camera(d.camera, H)
        if part == "a":
            for f in dataclasses.fields(cas):
                if getattr(cas, f.name) is not None:
                    out[f"build/{f.name}"] = _np(getattr(cas, f.name))
            for f in dataclasses.fields(st):
                out[f"build/{f.name}"] = _np(getattr(st, f.name))
            put_fp("stage", fp)
            _reference_a(out, s, fp, cas, mesh, cfg)
        else:
            _reference_b(out, put_fp, s, fp, cas, st, mesh, cfg)
    return out


def _reference_a(out, s, fp, cas, mesh, cfg):
    """The static tiled frames and the 2-D mesh (JAX side)."""
    import jax
    import jax.numpy as jnp

    from vri_tpu.parallel import multihost, tiling

    for i, (be, smp) in enumerate(STATIC):
        key = jax.random.PRNGKey(100 + i)
        aovs = tiling.render_frame_tiled(
            s, fp, cas, key, mesh=mesh, height=H, width=W, config=cfg,
            samples=smp, backend=be, use_cache=True)
        pre = f"static/{be}{smp}/"
        out.update({pre + k: np.asarray(v) for k, v in aovs.items()})
        out.update({pre + k: v for k, v in
                    _band_uniforms(key, BAND * W).items()})
    mesh2 = multihost.make_mesh_2d(2, N // 2)
    owner = jnp.asarray(np.arange(s.instance_transform.shape[0]) % 2,
                        jnp.int32)
    merged = multihost.merge_scene_partitions(s, owner, mesh2)
    for f in dataclasses.fields(merged):
        v = getattr(merged, f.name)
        if v is not None and f.name != "mip_atlas":
            out[f"merged/{f.name}"] = np.asarray(v)
    key = jax.random.PRNGKey(400)
    aovs = multihost.render_frame_tiled_2d(
        s, fp, cas, key, mesh=mesh2, height=H, width=W, config=cfg,
        samples=1, backend="raster")
    out.update({"mesh2d/" + k: np.asarray(v) for k, v in aovs.items()})
    out.update({"mesh2d/" + k: v for k, v in
                _band_uniforms(key, BAND * W).items()})


def _reference_b(out, put_fp, s, fp, cas, st, mesh, cfg):
    """The temporal frames over a vertical pan, the sharded dynamic frame
    and the one-device proxy (JAX side)."""
    import jax
    import jax.numpy as jnp

    import test_torch_dynamic as D
    from vri_tpu.parallel import tiling
    from vri_tpu.passes import frame as jframe

    def ids(scene, fpi, key):
        # the JAX temporal frames return no ids: the direct frame's
        return np.asarray(tiling.render_frame_tiled(
            scene, fpi, cas, key, mesh=mesh, height=H, width=W, config=cfg,
            gi=False, backend="raster")["instance_id"])

    for gs, hr in TEMPORAL:
        state = jframe.init_temporal(H, W, gs)
        for i, cam in enumerate(_pan_cameras(W / H)):
            fpi = jframe.FrameParams.from_camera(cam, H)
            put_fp(f"pan{i}", fpi)
            key = jax.random.PRNGKey(200 + 10 * gs + i)
            aovs, state = tiling.render_frame_tiled_temporal(
                s, fpi, cas, key, state, mesh=mesh, height=H, width=W,
                config=cfg, samples=1, backend="raster", use_cache=True,
                gi_scale=gs, halo_rows=hr)
            pre = f"temporal/{gs}/{i}/"
            out.update({pre + k: np.asarray(v) for k, v in aovs.items()})
            out[pre + "state"] = np.asarray(state.data)
            out[pre + "instance_id"] = ids(s, fpi, key)
            out.update({pre + k: v for k, v in _band_uniforms(
                key, (BAND // gs) * (W // gs)).items()})

    _, frames, dirty = D._motion(s)
    tf, dlo, dhi = frames[0]
    out.update({"dyn/tf": tf, "dyn/dlo": dlo, "dyn/dhi": dhi,
                "dyn/dirty": dirty})
    s1 = s.replace(instance_transform=jnp.asarray(tf))
    args = (jnp.asarray(dirty), jnp.asarray(dlo), jnp.asarray(dhi))
    key = jax.random.PRNGKey(300)
    aovs, state, cas1, _, nf = tiling.render_frame_tiled_dynamic(
        s1, fp, cas, st, key, jframe.init_temporal(H, W, 1), *args,
        mesh=mesh, height=H, width=W, config=cfg, samples=1,
        backend="raster", use_cache=True, gi_scale=1, halo_rows=1)
    out.update({"dyn/" + k: np.asarray(v) for k, v in aovs.items()})
    out["dyn/state"] = np.asarray(state.data)
    out["dyn/needs_full"] = np.asarray(nf)
    out["dyn/instance_id"] = out["proxy/instance_id"] = ids(s1, fp, key)
    for f in ("brick_map", "atlas", "voxel_shade", "brick_irradiance"):
        out["dyn/" + f] = _np(getattr(cas1, f))
    out.update({"dyn/" + k: v for k, v in
                _band_uniforms(key, BAND * W).items()})
    key = jax.random.PRNGKey(301)
    aovs, _, cas1, _, nf = jframe.render_frame_gi_dynamic(
        s1, fp, cas, st, key, jframe.init_temporal(H, W, 1), *args,
        height=H, width=W, config=cfg, samples=1, backend="raster",
        use_cache=True, shard_proxy=N)
    out.update({"proxy/" + k: np.asarray(v) for k, v in aovs.items()})
    out["proxy/needs_full"] = np.asarray(nf)
    for f in ("brick_map", "atlas", "voxel_shade", "brick_irradiance"):
        out["proxy/" + f] = _np(getattr(cas1, f))
    out["proxy/u"] = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0), (H * W, 2)))


_NO_FMA_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import test_torch_parallel as T
np.savez(sys.argv[1], **T._reference(sys.argv[2]))
"""

# -- the port's ranks ------------------------------------------------------------


def _fp(ref, name, device="cpu"):
    return tframe.FrameParams(**{
        f: torch.as_tensor(ref[f"fp/{name}/{f}"], device=device)
        for f in FP_FIELDS})


def _inputs(ref):
    """(scene, cascades, build state) of the reference, on the CPU."""
    pick = lambda pre: {k[len(pre):]: v for k, v in ref.items()  # noqa: E731
                        if k.startswith(pre)}
    build = pick("build/")
    return (scene_from_numpy(pick("scene/"), "cpu"),
            tsdf.cascades_from_numpy(build, "cpu"),
            tsdf.build_state_from_numpy(build, "cpu"))


def _garbage_view(scene, owner, host: int):
    """``scene`` with random values in the per-vertex, per-face and
    per-instance rows that ``host`` does not own (what a host that synced
    only its partition may hold there); ``vertex_instance`` and
    ``tri_instance``, which say who owns a row, are stage layout and stay
    right, as the merge's contract requires."""
    rng = np.random.default_rng(10 + host)
    own_i = torch.as_tensor(owner == host)
    own = {"v": own_i[scene.vertex_instance.long()],
           "f": own_i[scene.tri_instance.long()], "i": own_i}
    kinds = {"positions": "v", "tri_vertices": "f", "tri_uv": "f",
             "tri_face": "f",
             "instance_transform": "i", "instance_material": "i",
             "instance_face_offset": "i", "instance_face_count": "i",
             "instance_double_sided": "i", "instance_aabb_lo": "i",
             "instance_aabb_hi": "i"}
    out = {}
    for name, kind in kinds.items():
        a = getattr(scene, name)
        if a is None:
            continue
        a = a.clone()
        bad = ~own[kind]
        junk = rng.integers(-50, 50, size=a[bad].shape)
        a[bad] = torch.as_tensor(junk).to(a.dtype)
        out[name] = a
    return scene.replace(**out)


def _port_rank(ref_path: str, out_path: str) -> None:
    """One rank of the port's side: every sharded function on the
    reference's inputs; rank 0 writes the gathered results."""
    from vri_tpu_torch.parallel import halo, multihost

    ref = dict(np.load(ref_path))
    mesh = tmesh.make_mesh(N, backend="gloo", device="cpu")
    ax, rank = mesh.axis(), mesh.rank
    out = {}

    # -- halo ------------------------------------------------------------------
    vol, occ = _halo_inputs()
    vol, occ = torch.as_tensor(vol), torch.as_tensor(occ)
    mine = tmesh.shard_rows(vol, mesh)
    z = torch.zeros((1, 4, 4))
    padded = torch.cat([z, mine, z])
    gather = lambda x: tmesh.gather_rows(x, mesh).numpy()  # noqa: E731
    out["halo/exchange"] = gather(halo.exchange_halo(padded, 1, ax))
    out["halo/fill"] = gather(halo.exchange_halo_fill(mine, 2, ax, -1.0))
    for sh in SHIFTS:
        out[f"halo/scroll{sh}"] = gather(halo.scroll_slab(mine, sh, 0, ax))
    out["halo/scroll_halo"] = gather(halo.scroll_slab(padded, 3, 1, ax))
    out["halo/esd"] = gather(halo.esd_sharded(
        tmesh.shard_rows(occ, mesh), ax, 6))

    scene, cas, st = _inputs(ref)
    fp = _fp(ref, "stage")

    def uni(pre):
        return torch.as_tensor(ref[f"{pre}u{rank}"])[None]

    for be, smp in STATIC:
        pre = f"static/{be}{smp}/"
        aovs = ttiling.render_frame_tiled(
            scene, fp, cas, mesh=mesh, height=H, width=W, config=CFG,
            samples=smp, backend=be, uniforms=uni(pre) if smp else None)
        out.update({pre + k: v.numpy() for k, v in aovs.items()})

    for gs, hr in TEMPORAL:
        state = tframe.init_temporal(BAND, W, gs, device="cpu")
        for i in range(2):
            pre = f"temporal/{gs}/{i}/"
            aovs, state = ttiling.render_frame_tiled_temporal(
                scene, _fp(ref, f"pan{i}"), cas, state, mesh=mesh, height=H,
                width=W, config=CFG, samples=1, gi_scale=gs, halo_rows=hr,
                uniforms=uni(pre))
            out.update({pre + k: v.numpy() for k, v in aovs.items()})
            out[pre + "state"] = gather(state.data)

    dyn = [torch.as_tensor(ref[f"dyn/{k}"]) for k in ("dirty", "dlo", "dhi")]
    s1 = scene.replace(instance_transform=torch.as_tensor(ref["dyn/tf"]))
    aovs, state, cas1, _, nf = ttiling.render_frame_tiled_dynamic(
        s1, fp, cas, st, tframe.init_temporal(BAND, W, 1, device="cpu"),
        *dyn, mesh=mesh, height=H, width=W, config=CFG, samples=1,
        halo_rows=1, uniforms=uni("dyn/"))
    out.update({"dyn/" + k: v.numpy() for k, v in aovs.items()})
    out["dyn/state"] = gather(state.data)
    out["dyn/needs_full"] = int(nf)
    for f in ("brick_map", "atlas", "voxel_shade", "brick_irradiance"):
        out["dyn/" + f] = _np(getattr(cas1, f).float()
                              if f == "voxel_shade" else getattr(cas1, f))
    if rank == 0:
        # the unsharded update and re-bake on the same inputs
        _, _, cas_s, _, nf_s = tframe.render_frame_gi_dynamic(
            s1, fp, cas, st, tframe.init_temporal(H, W, 1, device="cpu"),
            *dyn, height=H, width=W, config=CFG, samples=0, use_cache=True)
        out["single/needs_full"] = int(nf_s)
        out["single/atlas_equal"] = torch.equal(cas_s.atlas, cas1.atlas)
        out["single/shade_equal"] = torch.equal(cas_s.voxel_shade,
                                                cas1.voxel_shade)

    mesh2 = multihost.make_mesh_2d(2, N // 2, backend="gloo", device="cpu")
    owner = np.arange(scene.instance_transform.shape[0]) % 2
    host = mesh2.coords[0]
    merged = multihost.merge_scene_partitions(
        _garbage_view(scene, owner, host), torch.as_tensor(owner), mesh2)
    for f in dataclasses.fields(merged):
        v = getattr(merged, f.name)
        if torch.is_tensor(v):
            out[f"merged/{f.name}"] = v.numpy()
    aovs = multihost.render_frame_tiled_2d(
        merged, fp, cas, mesh=mesh2, height=H, width=W, config=CFG,
        samples=1, uniforms=uni("mesh2d/"))
    out.update({"mesh2d/" + k: v.numpy() for k, v in aovs.items()})
    for name in ("jax", "vri_tpu"):
        assert sys.modules.get(name) is None, f"a rank imported {name}"
    if rank == 0:
        np.savez(out_path, **out)
    tmesh.close(mesh)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(reference, port): the JAX outputs from the no-FMA subprocess on
    four virtual devices, and the port's from four gloo ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests)]))
    # the reference's two parts at once, each in its own interpreter
    procs = {}
    for part in "ab":
        with open(tmp / f"ref_{part}.log", "w") as log:
            procs[part] = subprocess.Popen(
                [sys.executable, "-c", _NO_FMA_REFERENCE,
                 str(tmp / f"ref_{part}.npz"), part], env=env,
                stdout=log, stderr=subprocess.STDOUT)
    for part, proc in procs.items():
        proc.wait(timeout=900)
        assert proc.returncode == 0, \
            (tmp / f"ref_{part}.log").read_text()[-3000:]
    ref = {**np.load(tmp / "ref_a.npz"), **np.load(tmp / "ref_b.npz")}
    np.savez(tmp / "ref.npz", **ref)
    proc = tmesh.launch(N, [os.path.abspath(__file__), "--rank",
                            str(tmp / "ref.npz"), str(tmp / "port.npz")],
                        capture=True, timeout=600)
    if proc.returncode:
        pytest.fail(f"a rank failed (exit {proc.returncode}):\n"
                    f"{proc.stderr[-8000:]}", pytrace=False)
    return ref, dict(np.load(tmp / "port.npz"))


# -- halo ------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["exchange", "fill", "scroll_halo", "esd"]
                         + [f"scroll{s}" for s in SHIFTS])
def test_halo_matches_reference(frames, what):
    ref, got = frames
    np.testing.assert_array_equal(got["halo/" + what], ref["halo/" + what])


def test_scroll_is_a_roll(frames):
    _, got = frames
    vol, _ = _halo_inputs()
    for sh in SHIFTS:
        np.testing.assert_array_equal(got[f"halo/scroll{sh}"],
                                      np.roll(vol, -sh, 0))


# -- frames ----------------------------------------------------------------------

def _agreeing(ref, got, pre):
    same = ref[pre + "instance_id"] == got[pre + "instance_id"]
    print(f"{pre}: instance_id differs on {int((~same).sum())} of "
          f"{same.size} pixels")
    assert same.mean() >= 0.995
    return same


def _colour(ref, got, pre, same):
    assert got[pre + "color"].shape == (H, W, 3)
    assert np.isfinite(got[pre + "color"]).all()
    err = np.abs(got[pre + "color"] - ref[pre + "color"]).max(-1)[same]
    print(f"  colour max {err.max():.2e} where the ids agree")
    np.testing.assert_array_less(err, 2e-3)


@pytest.mark.parametrize("be,smp", STATIC)
def test_static_frame_matches(frames, be, smp):
    ref, got = frames
    pre = f"static/{be}{smp}/"
    same = _agreeing(ref, got, pre)
    _colour(ref, got, pre, same)
    np.testing.assert_allclose(got[pre + "depth"][same],
                               ref[pre + "depth"][same], rtol=1e-5)
    np.testing.assert_array_equal(got[pre + "stats"], ref[pre + "stats"])
    assert got[pre + "stats"][0] == H * W


def _history(ref, got, pre, gs, same):
    np.testing.assert_allclose(got[pre + "gi_history"][same],
                               ref[pre + "gi_history"][same], atol=1e-5)
    same_s = same[::gs, ::gs].reshape(-1)
    np.testing.assert_allclose(got[pre + "state"][same_s],
                               ref[pre + "state"][same_s], atol=1e-4)


@pytest.mark.parametrize("i", range(2))
@pytest.mark.parametrize("gs,hr", TEMPORAL)
def test_temporal_frame_matches(frames, gs, hr, i):
    ref, got = frames
    pre = f"temporal/{gs}/{i}/"
    same = _agreeing(ref, got, pre)
    _colour(ref, got, pre, same)
    _history(ref, got, pre, gs, same)
    np.testing.assert_array_equal(got[pre + "stats"], ref[pre + "stats"])
    hist = got[pre + "gi_history"]
    if i == 1:
        # the pan moves the history across the band borders: the halo
        # carries it there (the reprojection drops it on the top rows,
        # in the reference too)
        cov = same & (ref[pre + "instance_id"] >= 0)
        assert (hist[cov] > 1.0).mean() > 0.5
        assert max((hist[row][cov[row]] > 1.0).mean()
                   for row in range(BAND, H, BAND)) > 0.5


def test_dynamic_frame_matches(frames):
    ref, got = frames
    assert got["dyn/needs_full"] == int(ref["dyn/needs_full"]) == 0
    for f in ("brick_map", "atlas", "voxel_shade"):
        np.testing.assert_array_equal(got["dyn/" + f], ref["dyn/" + f],
                                      err_msg=f)
    np.testing.assert_allclose(got["dyn/brick_irradiance"],
                               ref["dyn/brick_irradiance"], atol=1e-4)
    same = _agreeing(ref, got, "dyn/")
    _colour(ref, got, "dyn/", same)
    _history(ref, got, "dyn/", 1, same)


def test_sharded_update_equals_unsharded(frames):
    _, got = frames
    assert got["single/needs_full"] == 0
    assert got["single/atlas_equal"] and got["single/shade_equal"]


def test_mesh2d_frame_matches(frames):
    ref, got = frames
    same = _agreeing(ref, got, "mesh2d/")
    _colour(ref, got, "mesh2d/", same)
    np.testing.assert_array_equal(got["mesh2d/stats"], ref["mesh2d/stats"])


def test_merge_rebuilds_the_scene(frames):
    ref, got = frames
    names = [k for k in got if k.startswith("merged/")]
    assert "merged/positions" in names and "merged/tri_vertices" in names
    for k in names:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(
            got[k], ref["scene/" + k.split("/", 1)[1]], err_msg=k)


# -- the one-device proxy of the sharded animated frame ---------------------------

def test_shard_proxy_matches(frames):
    ref, _ = frames
    scene, cas, st = _inputs(ref)
    dyn = [torch.as_tensor(ref[f"dyn/{k}"]) for k in ("dirty", "dlo", "dhi")]
    s1 = scene.replace(instance_transform=torch.as_tensor(ref["dyn/tf"]))
    kw = dict(height=H, width=W, config=CFG, samples=1, use_cache=True)
    aovs, _, cas1, _, nf = tframe.render_frame_gi_dynamic(
        s1, _fp(ref, "stage"), cas, st,
        tframe.init_temporal(H, W, 1, device="cpu"), *dyn, shard_proxy=N,
        uniforms=torch.as_tensor(ref["proxy/u"])[None], **kw)
    assert int(nf) == int(ref["proxy/needs_full"]) == 0
    for f in ("brick_map", "atlas", "voxel_shade"):
        v = getattr(cas1, f)
        np.testing.assert_array_equal(_np(v.float() if f == "voxel_shade"
                                          else v), ref["proxy/" + f],
                                      err_msg=f)
    got = {"proxy/" + k: v.numpy() for k, v in aovs.items()}
    same = _agreeing(ref, got, "proxy/")
    _colour(ref, got, "proxy/", same)
    # the proxy re-emits one share only: its atlas is not the full update's
    assert not np.array_equal(ref["proxy/atlas"], ref["dyn/atlas"])


# -- world size 1: the single-device frames bit for bit ---------------------------

@pytest.fixture(scope="module")
def one_rank(frames):
    ref, _ = frames
    scene, cas, st = _inputs(ref)
    return ref, scene, cas, st, tmesh.make_mesh(device="cpu")


def _equal(a: dict, b: dict, keys):
    for k in keys:
        assert torch.equal(a[k], b[k]), k


def test_world_size_1_static(one_rank):
    ref, scene, cas, _, mesh = one_rank
    assert mesh.size == 1 and mesh.backend is None
    fp = _fp(ref, "stage")
    u = torch.rand((1, H * W, 2), generator=torch.Generator().manual_seed(0))
    tiled = ttiling.render_frame_tiled(scene, fp, cas, mesh=mesh, height=H,
                                       width=W, config=CFG, uniforms=u)
    single = tframe.render_frame_gi(scene, fp, cas, height=H, width=W,
                                    config=CFG, uniforms=u, use_cache=True)
    _equal(tiled, single, ("color", "depth", "instance_id"))
    assert tiled["stats"].tolist() == [H * W,
                                       int((single["instance_id"] >= 0).sum())]


@pytest.mark.parametrize("gs", [1, 2])
def test_world_size_1_temporal(one_rank, gs):
    ref, scene, cas, _, mesh = one_rank
    n = (H // gs) * (W // gs)
    sts = [tframe.init_temporal(H, W, gs, device="cpu") for _ in range(2)]
    for i in range(2):
        fp = _fp(ref, f"pan{i}")
        u = torch.rand((1, n, 2), generator=torch.Generator().manual_seed(i))
        tiled, sts[0] = ttiling.render_frame_tiled_temporal(
            scene, fp, cas, sts[0], mesh=mesh, height=H, width=W,
            config=CFG, gi_scale=gs, uniforms=u)
        single, sts[1] = tframe.render_frame_gi_temporal(
            scene, fp, cas, sts[1], height=H, width=W, config=CFG,
            gi_scale=gs, uniforms=u, use_cache=True)
        _equal(tiled, single, ("color", "depth", "instance_id",
                               "gi_history"))
        assert torch.equal(sts[0].data, sts[1].data)


def test_world_size_1_dynamic(one_rank):
    ref, scene, cas, st, mesh = one_rank
    dyn = [torch.as_tensor(ref[f"dyn/{k}"]) for k in ("dirty", "dlo", "dhi")]
    s1 = scene.replace(instance_transform=torch.as_tensor(ref["dyn/tf"]))
    fp = _fp(ref, "stage")
    u = torch.rand((1, H * W, 2), generator=torch.Generator().manual_seed(3))
    kw = dict(height=H, width=W, config=CFG, uniforms=u)
    tiled = ttiling.render_frame_tiled_dynamic(
        s1, fp, cas, st, tframe.init_temporal(H, W, 1, device="cpu"), *dyn,
        mesh=mesh, **kw)
    single = tframe.render_frame_gi_dynamic(
        s1, fp, cas, st, tframe.init_temporal(H, W, 1, device="cpu"), *dyn,
        use_cache=True, **kw)
    _equal(tiled[0], single[0], ("color", "depth", "gi_history"))
    for f in ("atlas", "voxel_shade", "brick_irradiance", "brick_map"):
        assert torch.equal(getattr(tiled[2], f), getattr(single[2], f)), f
    assert int(tiled[4]) == int(single[4]) == 0


# -- the dry run and the refusals ---------------------------------------------------

def test_dryrun_multichip_4():
    from vri_tpu_torch.parallel.dryrun import dryrun_multichip

    assert dryrun_multichip(4, timeout=600) == 0


def test_height_must_split():
    fake = tmesh.Mesh(("tiles",), (3,), (0,), torch.device("cpu"), None,
                      (None,))
    with pytest.raises(ValueError, match="height 32 % devices 3"):
        ttiling.render_frame_tiled(None, None, None, mesh=fake, height=32,
                                   width=W, config=CFG)
    fake = tmesh.Mesh(("tiles",), (4,), (1,), torch.device("cpu"), None,
                      (None,))
    with pytest.raises(ValueError, match="gi_scale"):
        ttiling.render_frame_tiled_temporal(
            None, None, None, None, mesh=fake, height=36, width=W,
            config=CFG, gi_scale=2)


def test_nccl_refuses_a_shared_card(monkeypatch):
    # two local ranks on one card
    with pytest.raises(ValueError, match="must pass backend='gloo'"):
        tmesh.check_nccl_devices(1, 2, torch.device("cuda:0"), 1)
    with pytest.raises(ValueError, match="must pass backend='gloo'"):
        tmesh.check_nccl_devices(0, 2, torch.device("cuda:0"), 1)
    tmesh.check_nccl_devices(1, 2, torch.device("cuda:1"), 2)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tmesh.make_mesh(backend="nccl", device="cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="requested 2 ranks"):
        tmesh.make_mesh(2, device="cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["--rank"]:
    _port_rank(sys.argv[2], sys.argv[3])
