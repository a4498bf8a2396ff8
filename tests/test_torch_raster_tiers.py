"""The port's binned and ranged raster tiers, the frame's tier dispatch
with frustum compaction, and the renderer's overflow ladder.

The tiers are held against ``vri_tpu.ops.rasterize.rasterize_binned`` (K5)
and ``rasterize`` (K6), both run in interpret mode on the CPU as the JAX
package's own tests run them; the port runs kernel R's and the ranged
kernel's plain PyTorch versions, which the CUDA kernels match bit for bit
on the card (``tests/test_torch_cuda.py``).  The cases are those of
``tests/test_torch_raster.py``: the Cornell box at 64^2, the 48-object
kitchen at tess 1 at 64x256 with the stage's camera inside the room (it
near-clips slots) and the 600-sliver strip.

Tolerances, and why:

* Triangle ids equal on at least 99.9% of pixels, counting a pixel as
  agreeing when its two winners tie (both contain the pixel center within
  1e-5 in float64 barycentrics, at depths within 1e-5) or when it is a
  reference crack (below).  The tie rules differ: K6 takes the exact
  nearest depth and the lowest Morton index, K5 packs the list position
  into 9 low depth bits, the port takes the minimum of (depth with 7 low
  bits cleared, setup slot index).  The Cornell box's corners and quad
  diagonals project exactly through pixel centers, so ties are common
  there; their number is printed and bounded by 1%.
* Coverage equal on at least 99.95% of pixels, counting reference cracks
  as agreeing.  A reference crack is a pixel whose center the reference
  misses and the port covers, lying on an edge of the port's triangle
  (float64 barycentric within 1e-5): K5 and K6 test l1, l2 >= 0 and
  l1 + l2 <= 1 from per-slot coefficients and lose such centers to
  rounding (on Cornell, 12 in K5 and 21 in K6); the port's canonical
  edge functions are watertight.  The crack count is printed.
* u and v where the ids agree: within 1e-5 of the float64
  perspective-correct interpolation over the winning slot's own float32
  setup, and no further from the float64 ray-triangle barycentrics than
  the largest of 1e-4 and 1.25x the reference's or the setup's own error
  (the bound of ``tests/test_torch_raster.py``, for the same reasons).
* The overflow equal (K5 counts overflowed tiles; K6 reports none).
* Between the port's own tiers, on every case where none overflows:
  ``tri``, ``t``, ``u`` and ``v`` bit-equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_raster import (CASES, _barycentrics,  # noqa: E402
                               _classify, _stage_case)
import vri_tpu_torch  # noqa: E402
from vri_tpu.config import RenderConfig, SDFConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.hydra.camera import make_camera  # noqa: E402
from vri_tpu.ops import rasterize as jraster  # noqa: E402
from vri_tpu.passes import frame as jframe  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import rasterize as traster  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import bake_world, scene_from_numpy  # noqa: E402

TIERS = {
    "sorted": (traster.prepare_sorted, None),
    "binned": (traster.prepare_binned, jraster.rasterize_binned),
    "ranged": (traster.prepare_ranged, jraster.rasterize),
}


def _args(case):
    return (case["tworld"], torch.as_tensor(case["tri"]), case["nf"],
            torch.as_tensor(case["cam"].view_proj))


def _port_tier(case, tier, **kw):
    """(HitRecord, winning setup slot per pixel) of one port tier."""
    h, w = case["h"], case["w"]
    prep = TIERS[tier][0](*_args(case), height=h, width=w,
                          cull_sign=case["tcull"], **kw)
    if tier == "ranged":
        out = traster.raster_ranged(
            prep["coef"], prep["order"], prep["ranges"], prep["words"],
            n_global=prep["n_global"], num_tx=prep["num_tx"])
        overflow = None
    else:
        out = traster.raster_tiles(prep["coef"], prep["lists"],
                                   prep["starts"], prep["counts"],
                                   num_tx=prep["num_tx"], cap=prep["cap"])
        overflow = prep["overflow"]
    hit, _ = traster._frame_hit(prep, out, height=h, width=w, tile_h=8,
                                tile_w=128, overflow=overflow)
    gy, gx = prep["grid"]
    slot = out[1].reshape(gy, gx, 8, 128).permute(0, 2, 1, 3).reshape(
        gy * 8, gx * 128)[:h, :w].reshape(-1)
    return hit, slot.numpy()


def _setup_uv(case, tier, slot, pix):
    """Float64 perspective-correct (u, v) at pixels ``pix`` over each
    winning slot's float32 screen-space triangle from the tier's setup."""
    extra = (max(case["tri"].shape[0] // 16, 256) if tier == "sorted"
             else None)
    setup = traster.triangle_setup_clipped(
        *_args(case), case["h"], case["w"], extra_cap=extra,
        cull_sign=case["tcull"])
    s = slot[pix]
    tx, ty, tw, b1, b2 = (setup[k].numpy().astype(np.float64)[s]
                          for k in (0, 1, 3, 4, 5))
    y, x = np.divmod(pix, case["w"])
    px, py = x + 0.5, y + 0.5

    def edge(i, j):
        return ((tx[:, j] - tx[:, i]) * (py - ty[:, i])
                - (ty[:, j] - ty[:, i]) * (px - tx[:, i]))
    wl = np.stack([edge(1, 2), edge(2, 0), edge(0, 1)], 1) * tw
    den = wl.sum(1)
    return (wl * b1).sum(1) / den, (wl * b2).sum(1) / den


@pytest.fixture(scope="module")
def tiers():
    out = {}
    for name, make in CASES.items():
        c = make()
        port = {t: _port_tier(c, t) for t in TIERS}
        jargs = (jnp.asarray(c["world"]), jnp.asarray(c["tri"]),
                 jnp.int32(c["nf"]), jnp.asarray(c["cam"].view_proj))
        ref = {t: fn(*jargs, height=c["h"], width=c["w"],
                     cull_sign=c["jcull"], interpret=True)[0]
               for t, (_, fn) in TIERS.items() if fn is not None}
        out[name] = (c, port, ref)
    return out


@pytest.mark.parametrize("tier", ["binned", "ranged"])
@pytest.mark.parametrize("name", list(CASES))
def test_tier_matches_reference(tiers, name, tier):
    case, port, ref = tiers[name]
    hit, slot = port[tier]
    hj = ref[tier]
    a, b = np.asarray(hj.tri), hit.tri.numpy()
    n = a.size
    ties, edges, other = _classify(case, a, b)
    cov = (a >= 0) != (b >= 0)
    pix = np.nonzero(cov)[0]
    _, ue, ve = _barycentrics(case, pix, np.maximum(b[pix], 0))
    crack = np.zeros(n, bool)
    crack[pix] = (a[pix] < 0) & (b[pix] >= 0) & (
        np.abs(np.minimum(np.minimum(ue, ve), 1 - ue - ve)) <= 1e-5)
    print(f"{name}/{tier}: {int((a != b).sum())} of {n} pixels differ "
          f"({ties} ties, {int(crack.sum())} reference cracks, "
          f"{edges - int(crack.sum())} other on-edge, {other} other)")
    assert (n - other - edges + crack.sum()) / n >= 0.999
    assert other <= 0.001 * n and ties <= 0.01 * n
    assert (~cov | crack).mean() >= 0.9995
    pix = np.nonzero((a == b) & (a >= 0))[0]
    _, ue, ve = _barycentrics(case, pix, a[pix])
    us, vs = _setup_uv(case, tier, slot, pix)
    for label, got, want, exact, setup in (("u", hit.u, hj.u, ue, us),
                                           ("v", hit.v, hj.v, ve, vs)):
        got, want = got.numpy()[pix], np.asarray(want)[pix]
        err_t, err_r = np.abs(got - exact), np.abs(want - exact)
        err_s = np.abs(setup - exact)
        print(f"  {label}: port error {err_t.max():.2e}, reference "
              f"{err_r.max():.2e}, float32 setup {err_s.max():.2e}, port "
              f"from its setup {np.abs(got - setup).max():.2e}")
        np.testing.assert_allclose(got, setup, rtol=0, atol=1e-5)
        assert (err_t <= np.maximum(1e-4, 1.25 * np.maximum(err_r, err_s))
                ).all()
    if tier == "ranged":
        assert hj.overflow is None and hit.overflow is None
    else:
        assert int(hit.overflow) == int(hj.overflow)


@pytest.mark.parametrize("name", list(CASES))
def test_tiers_bit_equal(tiers, name):
    """Every port tier that reports no overflow gives the same tri, t, u
    and v at every pixel; on Cornell and the kitchen none overflows (the
    strip overflows the binned tier's 64 groups, in the reference too)."""
    _, port, _ = tiers[name]
    clean = [t for t, (h, _) in port.items()
             if h.overflow is None or int(h.overflow) == 0]
    print(f"{name}: tiers without overflow {clean}")
    assert "ranged" in clean and "sorted" in clean
    if name != "strip":
        assert clean == list(TIERS)
    first = port[clean[0]][0]
    for t in clean[1:]:
        for key in ("tri", "t", "u", "v"):
            assert torch.equal(getattr(port[t][0], key),
                               getattr(first, key)), (t, key)


def test_tiers_bit_equal_wide():
    """The three tiers at a larger shape with screen-spanning slots (the
    ranged tier's global chunks) and near-clipped slots: the 48-object
    kitchen at tess 2, 96x384.  Two binned tiles overflow 64 groups there,
    so the binned tier runs at the ladder's 2x capacities."""
    c = _stage_case(scenes.kitchen_stress(num_objects=48, tess=2), 96, 384)
    hits = {"sorted": _port_tier(c, "sorted")[0],
            "binned": _port_tier(c, "binned", caps_scale=2)[0],
            "ranged": _port_tier(c, "ranged")[0]}
    assert int(_port_tier(c, "binned")[0].overflow) > 0
    prep = traster.prepare_ranged(*_args(c), height=96, width=384,
                                  cull_sign=c["tcull"])
    assert prep["n_global"] >= 1
    assert int(hits["sorted"].overflow) == 0
    assert int(hits["binned"].overflow) == 0
    for t in ("binned", "ranged"):
        for key in ("tri", "t", "u", "v"):
            assert torch.equal(getattr(hits[t], key),
                               getattr(hits["sorted"], key)), (t, key)


# -- frame dispatch: frustum compaction ---------------------------------------

def _torch_scene(s):
    import dataclasses

    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)
              if f.name != "mip_atlas" and getattr(s, f.name) is not None}
    return scene_from_numpy(arrays, "cpu")


@pytest.fixture(scope="module")
def city():
    """A small instanced city (17 instances, 770 faces) and a camera in
    its middle that sees 5 of them."""
    d = RenderDelegate(RenderConfig(width=128, height=64))
    d.populate(scenes.city_stress(num_buildings=16, tess=2))
    s = d.sync()
    cam = make_camera(np.array([0.0, 3.0, 0.0]), np.array([10.0, 1.0, 10.0]),
                      50.0, 2.0)
    return s, _torch_scene(s), cam


@pytest.mark.parametrize("cap", [128, 1024])
def test_compaction_matches_reference(city, cap):
    """``_compact_visible_faces`` against the JAX one: face ids, live
    count, entry instances and overflow equal (cap 128 overflows)."""
    s, ts, cam = city
    want = jframe._compact_visible_faces(s, jnp.asarray(cam.view_proj), cap)
    got = tframe._compact_visible_faces(
        ts, torch.as_tensor(cam.view_proj), cap)
    print(f"cap {cap}: live {int(got[1])}, overflow {int(got[3])}")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[3]) > 0) == (cap == 128)
    assert 0 < int(got[1]) < int(s.num_faces)


def test_compacted_raster_equals_uncompacted(city):
    """With ``cull_instances`` forced and a budget that holds every
    visible face, the compacted sorted raster gives the HitRecord of the
    uncompacted frame (which takes the binned tier at this size); a
    budget below the visible faces counts its overflow."""
    _, ts, cam = city
    fp = tframe.FrameParams.from_camera(cam, 64, device="cpu")
    world = bake_world(ts)
    full = tframe._visibility_raster(ts, world, fp, 64, 128,
                                     cull_instances=False)
    comp = tframe._visibility_raster(ts, world, fp, 64, 128,
                                     cull_instances=True, compact_cap=1024)
    assert (full.tri >= 0).sum() > 1000
    for key in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(comp, key), getattr(full, key)), key
    assert int(comp.overflow) == 0 and int(full.overflow) == 0
    small = tframe._visibility_raster(ts, world, fp, 64, 128,
                                      cull_instances=True, compact_cap=128)
    assert int(small.overflow) == 1


# -- the renderer's overflow ladder --------------------------------------------

LADDER_SDF = SDFConfig(num_cascades=2, cascade_resolution=64, brick_size=8,
                       max_bricks=16384, base_voxel_size=0.075,
                       truncation_voxels=3.0, max_triangles_per_brick=16,
                       approx_occlusion=True)


def test_overflow_ladder_reaches_ranged(monkeypatch):
    """With the list tiers made to report overflow, frames escalate
    1x -> 2x -> 4x -> ranged and stay there; the ranged frame's AOVs equal
    an unforced frame's (same GI uniforms), and a brute-force frame finds
    the same instances."""
    from vri_tpu_torch import renderer as renderer_mod

    res = 64
    u = torch.as_tensor(np.random.default_rng(0).random(
        (1, res * res, 2), dtype=np.float32))
    sdf = vri_tpu_torch.SDFConfig(**{f.name: getattr(LADDER_SDF, f.name)
                                     for f in dataclasses.fields(LADDER_SDF)})
    r = renderer_mod.Renderer(vri_tpu_torch.RenderConfig(
        width=res, height=res, sdf=sdf), device="cpu")
    r.load_stage(vri_tpu_torch.scenes.cornell_box())
    clean = r.render(gi=True, uniforms=u)

    used = []
    real_frame = tframe.render_frame_gi

    def spy(*a, backend="raster", **kw):
        used.append(backend)
        return real_frame(*a, backend=backend, **kw)

    def overflowing(fn):
        def run(*a, **kw):
            hit, z = fn(*a, **kw)
            hit.overflow = hit.overflow + 1
            return hit, z
        return run

    monkeypatch.setattr(tframe, "render_frame_gi", spy)
    for name in ("rasterize_sorted", "rasterize_binned"):
        monkeypatch.setattr(traster, name,
                            overflowing(getattr(traster, name)))
    for _ in range(5):
        out = r.render(gi=True, uniforms=u)
    assert used == ["raster", "raster2x", "raster4x", "raster_ranged",
                    "raster_ranged"]
    assert "raster_overflow_tiles" not in out
    for key in ("instance_id", "depth", "normal", "albedo", "color"):
        np.testing.assert_array_equal(out[key], clean[key], err_msg=key)

    brute = r.render(gi=True, uniforms=u, backend="brute")
    same = (brute["instance_id"] == clean["instance_id"]).mean()
    print(f"brute vs raster: instance ids equal on {same:.4f} of pixels")
    assert same >= 0.99
