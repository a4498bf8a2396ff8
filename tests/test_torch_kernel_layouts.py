"""The arithmetic and bookkeeping that the redesigned kernels M and R rely
on, checked on the CPU (the kernels themselves run only on the card, in
``tests/test_torch_cuda.py``).

* ``march_kernel.warp_step_efficiency`` against a brute count over warps.
* ``rasterize.list_length_stats`` against numpy's percentiles and sums.
* Kernel R stages each slot's pixel-independent terms once: the edges'
  canonical endpoints, x1 - x0 and y1 - y0, and the area sign negated
  where the endpoints were swapped (``raster_common.cuh:make_slot``).
  Written in PyTorch, that form gives keys bit-equal to the plain
  version's ``_slot_keys`` on the Cornell box's slots and on slivers,
  coincident corners, vertical edges and pixel centers on edges.
* Kernel R's pixel layout (pixel p = thread + 256 k, 4 a thread): every
  pixel of a tile belongs to one (thread, k), and where the tile width
  divides 256 a thread's pixels share one column.
* The ranged walk's cull (``rasterize.ranged_pairs``, the predicate of
  ``csrc/raster_ranged.cu:in_span``): per tile, the (tile, slot) pairs it
  keeps are exactly the sorted prep's lists, on the Cornell box at 64^2,
  the 48-object kitchen at tess 1 (its camera near-clips slots) and
  synthetic triangles with slivers, degenerate slots and corners exactly
  on multiples of 128 and 8; the kernel's float form of the predicate
  (floor of the quotient compared as a float) keeps the same pairs as the
  integer form.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from vri_tpu_torch import RenderConfig, scenes  # noqa: E402
from vri_tpu_torch.ops import march_kernel, rasterize  # noqa: E402

THREADS, PX = 256, 4        # raster_tiles.cu: kThreads, kPx


@pytest.mark.parametrize("m", [1, 31, 32, 33, 257, 4096])
def test_warp_step_efficiency_matches_brute_count(m):
    rng = np.random.default_rng(m)
    it = rng.integers(0, 200, m) * (rng.random(m) < 0.8)
    it[-1] = 150
    used = slots = 0
    for w0 in range(0, m, 32):
        warp = it[w0:w0 + 32]
        used += int(warp.sum())
        slots += 32 * int(warp.max())
    eff, mean_it, max_it = march_kernel.warp_step_efficiency(
        torch.as_tensor(it, dtype=torch.int32))
    assert eff == pytest.approx(used / slots, rel=1e-12)
    assert mean_it == pytest.approx(it.mean(), rel=1e-12)
    assert max_it == int(it.max())


def test_warp_step_efficiency_without_steps():
    eff, mean_it, max_it = march_kernel.warp_step_efficiency(
        torch.zeros(40, dtype=torch.int32))
    assert (eff, mean_it, max_it) == (1.0, 0.0, 0)


@pytest.mark.parametrize("case", ["uniform", "tail", "capped", "tiny"])
def test_list_length_stats_matches_numpy(case):
    rng = np.random.default_rng(len(case))
    counts, cap = {
        "uniform": (rng.integers(0, 120, 2025), 2048),
        "tail": (np.concatenate([rng.integers(0, 60, 2000),
                                 rng.integers(500, 3000, 25)]), 2048),
        "capped": (rng.integers(0, 5000, 300), 1024),
        "tiny": (np.array([7, 0, 3]), 2048),
    }[case]
    got = rasterize.list_length_stats(
        torch.as_tensor(counts, dtype=torch.int32), cap)
    n = np.minimum(counts, cap)
    top = np.sort(n)[::-1][:max(1, -(-n.shape[0] // 100))]
    assert got["tiles"] == n.shape[0] and got["pairs"] == int(n.sum())
    assert got["mean"] == pytest.approx(n.mean(), rel=1e-12)
    assert got["p50"] == pytest.approx(np.percentile(n, 50), rel=1e-12)
    assert got["p99"] == pytest.approx(np.percentile(n, 99), rel=1e-12)
    assert got["max"] == int(n.max())
    assert got["top1_share"] == pytest.approx(top.sum() / n.sum(),
                                              rel=1e-12)


def _staged_keys(c, gx, gy):
    """Depth keys from the per-slot terms kernel R stages: canonical
    edges as (x0, y0, x1 - x0, y1 - y0) and the area sign negated where
    the endpoints were swapped, then per pixel the edge function times
    that sign (raster_common.cuh:make_slot, slot_key)."""
    sign = c[..., 6]
    ok = torch.ones(c.shape[:-1] + gx.shape[-1:], dtype=torch.bool)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        ax, ay, bx, by = (c[..., 2 * a], c[..., 2 * a + 1], c[..., 2 * b],
                          c[..., 2 * b + 1])
        swap = (bx < ax) | ((bx == ax) & (by < ay))
        x0, y0 = torch.where(swap, bx, ax), torch.where(swap, by, ay)
        dx = torch.where(swap, ax, bx) - x0
        dy = torch.where(swap, ay, by) - y0
        sg = torch.where(swap, -sign, sign)
        e = dx[..., None] * (gy - y0[..., None]) \
            - dy[..., None] * (gx - x0[..., None])
        ok &= e * sg[..., None] >= 0.0
    lx = gx - c[..., 20, None]
    ly = gy - c[..., 21, None]
    z = (c[..., 8, None] * lx + c[..., 9, None] * ly) + c[..., 10, None]
    ok &= (z >= 0.0) & (z <= 1.0)
    return (torch.where(ok, z, 2.0).view(torch.int32) & ~127).to(
        torch.int64)


def _cornell_slots():
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    d = RenderDelegate(RenderConfig(width=64, height=64), device="cpu")
    d.populate(scenes.cornell_box())
    scene = d.sync()
    fp = frame_mod.FrameParams.from_camera(d.camera, 64, device="cpu")
    prep = rasterize.prepare_sorted(
        bake_world(scene), scene.tri_vertices, scene.num_faces, fp.view_proj,
        height=64, width=64, cull_sign=frame_mod._cull_sign(scene))
    return prep["coef"], 64, 64


def _sliver_slots():
    """Slot records around one 16 x 16 patch of pixel centers: slivers,
    coincident corners, vertical and horizontal edges, corners on pixel
    centers, and every area sign (-1, 0, 1)."""
    rng = np.random.default_rng(5)
    n = 4000
    v = rng.integers(0, 32, (n, 6)).astype(np.float32) * 0.5
    v += rng.choice([0.0, 0.0, 1e-6, -1e-6], (n, 6)).astype(np.float32)
    v[::7, 2] = v[::7, 0]                     # vertical edge
    v[::11, 5] = v[::11, 3]                   # horizontal edge
    v[::13, 4:6] = v[::13, 0:2]               # coincident corners
    v[1::17, 4:6] = v[1::17, 2:4] + 1e-3 * (v[1::17, 2:4] - v[1::17, 0:2])
    c = np.zeros((n, 24), np.float32)
    c[:, :6] = v
    c[:, 6] = rng.choice([-1.0, 0.0, 1.0], n)
    c[:, 8:11] = rng.uniform(-0.05, 0.1, (n, 3))
    c[:, 20:22] = np.floor(v[:, [0, 1]].clip(min=0))
    return torch.as_tensor(c), 16, 16


@pytest.mark.parametrize("slots", ["cornell", "slivers"])
def test_staged_slot_terms_give_the_plain_keys(slots):
    coef, h, w = {"cornell": _cornell_slots,
                  "slivers": _sliver_slots}[slots]()
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    gx = (xs.reshape(1, -1).float() + 0.5)
    gy = (ys.reshape(1, -1).float() + 0.5)
    want = rasterize._slot_keys(coef, gx, gy)
    got = _staged_keys(coef, gx, gy)
    assert (want < rasterize._MISS_KEY).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(8, 128), (1, 128), (16, 64), (4, 256),
                                   (32, 32), (2, 512)])
def test_raster_tile_pixel_layout(shape):
    tile_h, tile_w = shape
    npix = tile_h * tile_w
    t = np.arange(THREADS)[:, None]
    p = t + THREADS * np.arange(PX)[None, :]
    live = p < npix
    assert np.array_equal(np.sort(p[live]), np.arange(npix))
    gx, gy = rasterize._tile_pixels(3, 2, tile_h, tile_w, "cpu")
    gx_k = gx[1].numpy()[np.minimum(p, npix - 1)]
    if THREADS % tile_w == 0:
        column = gx[1].numpy()[t % tile_w]
        assert np.array_equal(np.where(live, gx_k, column),
                              np.broadcast_to(column, p.shape))
    assert np.array_equal(gy[1].numpy()[p[live]],
                          (0.5 + (p[live] // tile_w)).astype(np.float32))


def _stage_args(stage, h, w):
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    d = RenderDelegate(RenderConfig(width=w, height=h), device="cpu")
    d.populate(stage)
    scene = d.sync()
    fp = frame_mod.FrameParams.from_camera(d.camera, h, device="cpu")
    return ((bake_world(scene), scene.tri_vertices, scene.num_faces,
             fp.view_proj),
            dict(height=h, width=w, cull_sign=frame_mod._cull_sign(scene)))


def _border_args(seed=3, n=3000):
    """Triangles seen through the identity view-projection at 512 x 64
    (4 x 8 tiles of 8 x 128), so screen x = 256 (wx + 1) and y = 32 (1 -
    wy) exactly: corners on a quarter-pixel grid, a third of them snapped
    to multiples of 128 in x or of 8 in y, slivers (a corner 1e-3 px off
    the opposite edge's line), zero-area triangles and corners off the
    screen."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-80, 2100, (n, 3, 2)).astype(np.float64) / 4.0
    c[..., 1] = c[..., 1] * 64.0 / 520.0
    c[..., 1] = np.round(c[..., 1] * 4.0) / 4.0
    snap = rng.random((n, 3)) < 0.35
    c[..., 0] = np.where(snap, np.round(c[..., 0] / 128.0) * 128.0,
                         c[..., 0])
    snap = rng.random((n, 3)) < 0.35
    c[..., 1] = np.where(snap, np.round(c[..., 1] / 8.0) * 8.0, c[..., 1])
    small = rng.random(n) < 0.5                 # most triangles small
    c[small] = c[small, :1] + (c[small] - c[small, :1]) * 0.05
    c[::9, 2] = c[::9, 0] + 0.5 * (c[::9, 1] - c[::9, 0]) + 1e-3   # slivers
    c[1::23, 2] = c[1::23, 1]                   # zero area
    xy = np.stack([c[..., 0] / 256.0 - 1.0, 1.0 - c[..., 1] / 32.0], -1)
    z = rng.uniform(0.1, 0.9, (n, 3, 1))
    world = torch.as_tensor(np.concatenate([xy, z], -1).reshape(-1, 3)
                            .astype(np.float32))
    tri = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    return ((world, tri, n, torch.eye(4)),
            dict(height=64, width=512, cull_sign=None))


_SPAN_CASES = {
    "cornell": lambda: _stage_args(scenes.cornell_box(), 64, 64),
    "kitchen": lambda: _stage_args(
        scenes.kitchen_stress(num_objects=48, tess=1), 64, 256),
    "borders": _border_args,
}


def _pair_keys(tile, slot, src, f):
    """(tile, slot) pairs as sorted int64 keys, each slot named by its
    face and whether it is the face's first or second (near-clipped)
    slot, which the sorted and ranged tables number differently."""
    name = torch.where(slot < f, slot, f + src[slot].long())
    return torch.sort(tile * (2 * f) + name).values


@pytest.mark.parametrize("case", list(_SPAN_CASES))
def test_ranged_cull_keeps_the_sorted_lists(case):
    args, kw = _SPAN_CASES[case]()
    f = int(args[1].shape[0])
    sp = rasterize.prepare_sorted(*args, **kw)
    rp = rasterize.prepare_ranged(*args, **kw)
    assert int(sp["overflow"]) == 0
    tile, slot = rasterize.ranged_pairs(
        rp["coef"], rp["order"], rp["ranges"], rp["words"],
        n_global=rp["n_global"], num_tx=rp["num_tx"])
    want = _pair_keys(
        torch.repeat_interleave(torch.arange(sp["counts"].shape[0]),
                                sp["counts"].long()),
        sp["lists"].long(), sp["src"], f)
    got = _pair_keys(tile, slot, rp["src"], f)
    assert want.shape[0] > 0 and torch.equal(got, want)
    assert torch.equal(torch.bincount(tile, minlength=sp["counts"].shape[0])
                       .to(torch.int32), sp["counts"])
    coef = rp["coef"]
    if case == "kitchen":           # near-plane-clipped second slots
        assert int(coef[f:, 7].sum()) > 0
    if case == "borders":
        xs, ys = coef[:, 0:6:2], coef[:, 1:6:2]
        assert int((xs % 128 == 0).sum()) > 100
        assert int((ys % 8 == 0).sum()) > 100
        assert int((coef[:f, 7] == 0).sum()) > 100      # zero-area slots
    # and so the two tiers' hits are bit-equal
    hs, _ = rasterize.rasterize_sorted(*args, **kw)
    hr, _ = rasterize.rasterize(*args, **kw)
    assert (hs.tri >= 0).any()
    for key in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(hr, key), getattr(hs, key)), key
    print(f"{case}: {want.shape[0]} pairs, as the sorted lists")


@pytest.mark.parametrize("case", list(_SPAN_CASES))
def test_ranged_cull_float_form(case):
    """``in_span`` compares floor(min x / tile_w) etc. as floats with the
    tile's column and row; :func:`rasterize._tile_span` converts them to
    int32 (held within +-2^30) first.  Both keep the same (tile, slot)
    pairs, also for near-plane-clipped corners far off the screen."""
    args, kw = _SPAN_CASES[case]()
    coef = rasterize.prepare_ranged(*args, **kw)["coef"]
    xs, ys = coef[:, 0:6:2], coef[:, 1:6:2]
    gy, gx = -(-kw["height"] // 8), -(-kw["width"] // 128)
    col = torch.arange(gx)[None, :, None].float()
    row = torch.arange(gy)[:, None, None].float()

    def mn(v):
        return torch.minimum(torch.minimum(v[:, 0], v[:, 1]), v[:, 2])

    def mx(v):
        return torch.maximum(torch.maximum(v[:, 0], v[:, 1]), v[:, 2])

    flt = ((torch.floor(mn(xs) / 128.0) <= col)
           & (col <= torch.floor(mx(xs) / 128.0))
           & (torch.floor(mn(ys) / 8.0) <= row)
           & (row <= torch.floor(mx(ys) / 8.0)))
    tx0, tx1, ty0, ty1 = rasterize._tile_span(xs, ys, 8, 128)
    col, row = col.long(), row.long()
    ints = (tx0 <= col) & (col <= tx1) & (ty0 <= row) & (row <= ty1)
    assert flt.any() and torch.equal(flt, ints)
