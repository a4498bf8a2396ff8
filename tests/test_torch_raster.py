"""The port's sorted raster against ``vri_tpu.ops.rasterize.rasterize_sorted``.

The JAX side runs its Pallas kernels (K1 and K2) in interpret mode on the
CPU, as the JAX package's own tests do; the port runs kernel R's plain
PyTorch version, which the CUDA kernel matches bit for bit on the card.
Both see the same packed scene (``scene_from_numpy``).

Tolerances, and why:

* Triangle ids equal on at least 99.9% of pixels, counting a pixel as
  agreeing when its two winners TIE: both triangles contain the pixel
  center (within 1e-5 in float64 barycentrics) at depths within 1e-5.
  The two implementations break such ties by different rules (the port by
  position in the tile list, K1 by global lane) and decide pixel centers
  that sit exactly on an edge by rounding; the number of tie pixels is
  printed and bounded by 0.5%.  Cornell at 64^2 is the worst case: its
  box corners project exactly through pixel centers.
* Coverage equal on at least 99.95% of pixels (the port is watertight on
  shared edges; the reference may drop an on-edge pixel center).
* u and v, where the ids agree, at every pixel within 1e-5 of the
  float64 perspective-correct interpolation over the winning slot's own
  float32 screen-space triangle (its corners, 1/w and source
  barycentrics from ``triangle_setup_clipped``): this holds kernel R's
  slot fields, their evaluation and the resolve to float32 accuracy.
* u and v, where the ids agree, at every pixel no further from the
  float64 ray-triangle barycentrics than the largest of 1e-4, 1.25x the
  reference's error at that pixel and 1.25x the float32 setup's own
  error there.  A plain 1e-4 bound against the reference is not
  reachable: near-plane-clipped slots (the kitchen camera stands inside
  the room) make the reference's float32-built attribute fields
  ill-conditioned, and it lands ~2e-3 from the exact value there while
  the port, whose slot frames stay on the screen, does not; on the
  strip's 0.4-pixel slivers the float32 corners alone put both ~3e-4
  from the exact value.  The pixels more than 1e-4 from the reference
  are counted and printed.
* The overflow flag exactly equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from vri_tpu.config import RenderConfig  # noqa: E402
from vri_tpu.hydra import RenderDelegate  # noqa: E402
from vri_tpu.hydra.camera import make_camera  # noqa: E402
from vri_tpu.ops import rasterize as jraster  # noqa: E402
from vri_tpu.passes import frame as jframe  # noqa: E402
from vri_tpu.registry import bake_world as jbake_world  # noqa: E402
from vri_tpu.usd import scenes  # noqa: E402
from vri_tpu_torch.ops import rasterize as traster  # noqa: E402
from vri_tpu_torch.passes import frame as tframe  # noqa: E402
from vri_tpu_torch.registry import bake_world, scene_from_numpy  # noqa: E402


def _stage_case(stage, h, w):
    d = RenderDelegate(RenderConfig(width=w, height=h))
    d.populate(stage)
    s = d.sync()
    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)
              if f.name != "mip_atlas" and getattr(s, f.name) is not None}
    ts = scene_from_numpy(arrays, "cpu")
    return dict(
        h=h, w=w, cam=d.camera, world=np.asarray(jbake_world(s)),
        tri=np.asarray(s.tri_vertices), nf=int(s.num_faces),
        jcull=jframe._cull_sign(s), tcull=tframe._cull_sign(ts),
        tworld=bake_world(ts))


def _strip_case(h=64, w=256, n=600, seed=3):
    """Thin-edge strip: n jittered quads of ~0.4 px width tiling a
    rectangle, sharing their vertices; every pixel center inside the
    rectangle must be covered (no cracks)."""
    rng = np.random.default_rng(seed)
    xs = np.sort(np.concatenate([[-1.6, 1.6], rng.uniform(-1.6, 1.6, n - 1)]))
    top = np.stack([xs, np.full(n + 1, 0.37), np.zeros(n + 1)], -1)
    bot = np.stack([xs, np.full(n + 1, -0.41), np.zeros(n + 1)], -1)
    verts = np.concatenate([top, bot]).astype(np.float32)
    i = np.arange(n)
    t0 = np.stack([i, n + 1 + i, i + 1], -1)
    t1 = np.stack([i + 1, n + 1 + i, n + 2 + i], -1)
    tris = np.concatenate([t0, t1]).astype(np.int32)
    pool = -(-len(tris) // 128) * 128
    tri = np.zeros((pool, 3), np.int32)
    tri[:len(tris)] = tris
    cam = make_camera((0.05, 0.02, 2.0), (0.05, 0.02, 0.0), 40.0, w / h)
    return dict(h=h, w=w, cam=cam, world=verts, tri=tri, nf=len(tris),
                jcull=None, tcull=None, tworld=torch.as_tensor(verts))


def _pixel_rays(case, pix):
    """Float64 pixel-center rays (origins, unit directions) for pixels."""
    h, w = case["h"], case["w"]
    inv = np.linalg.inv(case["cam"].view_proj.astype(np.float64))
    y, x = np.divmod(pix, w)
    ndc = np.stack([(x + 0.5) / w * 2 - 1, 1 - (y + 0.5) / h * 2], -1)

    def unproject(z):
        q = np.concatenate([ndc, np.full((len(pix), 1), z),
                            np.ones((len(pix), 1))], 1) @ inv.T
        return q[:, :3] / q[:, 3:]

    o = unproject(0.02)
    d = unproject(0.98) - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _barycentrics(case, pix, tri_ids):
    """Float64 Möller–Trumbore (t, u, v) of each pixel ray against its
    triangle."""
    o, d = _pixel_rays(case, pix)
    world = case["world"].astype(np.float64)
    corners = world[case["tri"][tri_ids]]
    v0, e1, e2 = corners[:, 0], corners[:, 1] - corners[:, 0], \
        corners[:, 2] - corners[:, 0]
    pv = np.cross(d, e2)
    det = (pv * e1).sum(-1)
    tv = o - v0
    qv = np.cross(tv, e1)
    return ((qv * e2).sum(-1) / det, (tv * pv).sum(-1) / det,
            (d * qv).sum(-1) / det)


def _classify(case, a, b):
    """Float64 analysis of the pixels where the winners differ: (ties,
    on-edge coverage differences, other differences)."""
    pix = np.nonzero(a != b)[0]
    both = (a[pix] >= 0) & (b[pix] >= 0)
    ta, ua, va = _barycentrics(case, pix, np.maximum(a[pix], 0))
    tb, ub, vb = _barycentrics(case, pix, np.maximum(b[pix], 0))
    ma = np.minimum(np.minimum(ua, va), 1 - ua - va)
    mb = np.minimum(np.minimum(ub, vb), 1 - ub - vb)
    tie = both & (ma > -1e-5) & (mb > -1e-5) & (np.abs(ta - tb)
                                                 <= 1e-5 * np.abs(ta))
    m_cov = np.where(a[pix] >= 0, ma, mb)
    edge = ~both & (np.abs(m_cov) < 1e-5)
    return int(tie.sum()), int(edge.sum()), int((~tie & ~edge).sum())


CASES = {
    "cornell": lambda: _stage_case(scenes.cornell_box(), 64, 64),
    # a wide frame that mixes K1 (dense) and K2 (grouped) tiles, as
    # tests/test_rasterize.py::TestFusedResolve::test_parity_kitchen_grouped_mix
    "kitchen": lambda: _stage_case(
        scenes.kitchen_stress(num_objects=48, tess=1), 96, 384),
    "strip": _strip_case,
}


def _setup_exact(case, pix):
    """Per pixel: the port's winning slot and the float64 perspective-
    correct (u, v) over that slot's float32 screen-space triangle."""
    args = (case["tworld"], torch.as_tensor(case["tri"]), case["nf"],
            torch.as_tensor(case["cam"].view_proj))
    h, w = case["h"], case["w"]
    prep = traster.prepare_sorted(*args, height=h, width=w,
                                  cull_sign=case["tcull"])
    _, slot, _, _ = traster.raster_tiles(
        prep["coef"], prep["lists"], prep["starts"], prep["counts"],
        num_tx=prep["num_tx"], cap=prep["cap"])
    gy, gx = prep["grid"]
    slot = slot.reshape(gy, gx, 8, 128).permute(0, 2, 1, 3).reshape(
        gy * 8, gx * 128)[:h, :w].reshape(-1).numpy()[pix]
    setup = traster.triangle_setup_clipped(
        *args, h, w, extra_cap=max(case["tri"].shape[0] // 16, 256),
        cull_sign=case["tcull"])
    tx, ty, tw, b1, b2 = (setup[k].numpy().astype(np.float64)[slot]
                          for k in (0, 1, 3, 4, 5))
    y, x = np.divmod(pix, w)
    px, py = x + 0.5, y + 0.5

    def edge(i, j):
        return ((tx[:, j] - tx[:, i]) * (py - ty[:, i])
                - (ty[:, j] - ty[:, i]) * (px - tx[:, i]))
    wl = np.stack([edge(1, 2), edge(2, 0), edge(0, 1)], 1) * tw
    den = wl.sum(1)
    return slot, prep["src"].numpy()[slot], \
        (wl * b1).sum(1) / den, (wl * b2).sum(1) / den


@pytest.fixture(scope="module")
def rasters():
    out = {}
    for name, make in CASES.items():
        c = make()
        vp = c["cam"].view_proj
        hj, _ = jraster.rasterize_sorted(
            jnp.asarray(c["world"]), jnp.asarray(c["tri"]),
            jnp.int32(c["nf"]), jnp.asarray(vp), height=c["h"],
            width=c["w"], cull_sign=c["jcull"], interpret=True)
        ht, _ = traster.rasterize_sorted(
            c["tworld"], torch.as_tensor(c["tri"]), c["nf"],
            torch.as_tensor(vp), height=c["h"], width=c["w"],
            cull_sign=c["tcull"])
        out[name] = (c, hj, ht)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sorted_raster_matches_reference(rasters, name):
    case, hj, ht = rasters[name]
    a, b = np.asarray(hj.tri), ht.tri.numpy()
    n = a.size
    ties, edges, other = _classify(case, a, b)
    print(f"{name}: {int((a != b).sum())} of {n} pixels differ "
          f"({ties} ties, {edges} on-edge coverage, {other} other)")
    assert (n - other - edges) / n >= 0.999 and other <= 0.001 * n
    assert ties <= 0.005 * n
    assert ((a >= 0) == (b >= 0)).mean() >= 0.9995
    pix = np.nonzero((a == b) & (a >= 0))[0]
    _, ue, ve = _barycentrics(case, pix, a[pix])
    _, src, us, vs = _setup_exact(case, pix)
    np.testing.assert_array_equal(src, b[pix])
    for name_, got, ref, exact, setup in (("u", ht.u, hj.u, ue, us),
                                          ("v", ht.v, hj.v, ve, vs)):
        got, ref = got.numpy()[pix], np.asarray(ref)[pix]
        err_t, err_r = np.abs(got - exact), np.abs(ref - exact)
        err_s = np.abs(setup - exact)
        print(f"  {name_}: port error {err_t.max():.2e}, reference "
              f"{err_r.max():.2e}, float32 setup {err_s.max():.2e}, port "
              f"from its setup {np.abs(got - setup).max():.2e}; "
              f"{int((np.abs(got - ref) > 1e-4).sum())} of {pix.size} "
              "pixels more than 1e-4 from the reference")
        np.testing.assert_allclose(got, setup, rtol=0, atol=1e-5)
        assert (err_t <= np.maximum(1e-4, 1.25 * np.maximum(err_r, err_s))
                ).all()
    assert int(ht.overflow) == int(hj.overflow)


def test_strip_is_watertight(rasters):
    """Every pixel whose center lies inside the strip's rectangle is
    covered by the port (shared edges evaluate bit-identically)."""
    case, _, ht = rasters["strip"]
    h, w = case["h"], case["w"]
    vp = case["cam"].view_proj.astype(np.float64)
    corners = np.array([[-1.6, 0.37, 0, 1], [1.6, -0.41, 0, 1]]) @ vp.T
    sx = (corners[:, 0] / corners[:, 3] * 0.5 + 0.5) * w
    sy = (0.5 - corners[:, 1] / corners[:, 3] * 0.5) * h
    ys, xs = np.mgrid[0:h, 0:w] + 0.5
    inside = ((xs > sx.min() + 1e-3) & (xs < sx.max() - 1e-3)
              & (ys > sy.min() + 1e-3) & (ys < sy.max() - 1e-3))
    tri = ht.tri.numpy().reshape(h, w)
    assert inside.sum() > 1000
    assert (tri[inside] >= 0).all()


def test_overflow_counted():
    """A pair budget below the emitted pairs sets the overflow flag, and
    the 4x caps ladder absorbs it (renderer escalation)."""
    c = CASES["cornell"]()
    args = (c["tworld"], torch.as_tensor(c["tri"]), c["nf"],
            torch.as_tensor(c["cam"].view_proj))
    h1, _ = traster.rasterize_sorted(*args, height=48, width=48, tile_h=1,
                                     pairs_cap=256)
    h4, _ = traster.rasterize_sorted(*args, height=48, width=48, tile_h=1,
                                     pairs_cap=256, caps_scale=4)
    assert int(h1.overflow) == 1 and int(h4.overflow) == 0


def test_rays_and_brute_oracle_match_reference():
    """Camera rays and the brute-force Möller–Trumbore oracle against
    ``vri_tpu.ops.{raygen,intersect}`` on the Cornell box at 32^2, with
    the cull sign: rays within 1e-6; hit triangles equal except at ties
    (both hits within rtol 1e-5 in t), t and (u, v) within 1e-5 where
    equal (float32, same operation order)."""
    from vri_tpu.ops import intersect as jint
    from vri_tpu.ops import raygen as jray
    from vri_tpu_torch.ops import intersect as tint
    from vri_tpu_torch.ops import raygen as tray

    c = _stage_case(scenes.cornell_box(), 32, 32)
    cam = c["cam"]
    jo, jd = jray.camera_rays(jnp.asarray(cam.inv_view_proj),
                              jnp.asarray(cam.eye), 32, 32)
    to, td = tray.camera_rays(torch.as_tensor(cam.inv_view_proj),
                              torch.as_tensor(cam.eye), 32, 32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jh = jint.trace_brute(jo.reshape(-1, 3), jd.reshape(-1, 3),
                          *jint.gather_triangles(jnp.asarray(c["world"]),
                                                 jnp.asarray(c["tri"])),
                          c["nf"], cull_sign=c["jcull"])
    th = tint.trace_brute(to.reshape(-1, 3), td.reshape(-1, 3),
                          *tint.gather_triangles(c["tworld"],
                                                 torch.as_tensor(c["tri"])),
                          c["nf"], cull_sign=c["tcull"])
    a, b = np.asarray(jh.tri), th.tri.numpy()
    same = a == b
    print(f"brute oracle: {int((~same).sum())} tie pixels")
    # a differing pixel is a tie: both hits at the same distance (a ray
    # through the shared edge of two walls)
    np.testing.assert_allclose(th.t.numpy()[~same], np.asarray(jh.t)[~same],
                               rtol=1e-5)
    assert same.mean() >= 0.995
    for got, want in ((th.t, jh.t), (th.u, jh.u), (th.v, jh.v)):
        np.testing.assert_allclose(got.numpy()[same],
                                   np.asarray(want)[same], atol=1e-5,
                                   rtol=1e-5)
