"""The arithmetic and bookkeeping that the redesigned kernels M, R, K6 and
the work-list walks rely on, checked on the CPU (the kernels themselves
run only on the card, in ``tests/test_torch_cuda.py``).

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
* The work-list walks (``csrc/worklist.cu``): a mirror of their thread ->
  pixel map (``walk_shape``, ``pixel_of``; its constants read from the
  source) covers each pixel once for every P the wrappers admit, with a
  thread's pixels in one column or one row; every product of a pixel
  coordinate and a staged bf16 factor (the tools' draws, covering
  triangle templates, ``k6_operand``) equals its float64 value, which is
  why the kernel may fuse it into its add, while FP32 factors' products
  round; the walks' per-step-then-merge rule writes the per-lane rule's
  winner on depths with forced ties.
* The grouped step (``csrc/worklist_grouped.cu``): its block of P / 4
  threads (``block_shape``, the walks' map) covers each pixel of P = 128
  to 1024 once with coalesced stores, and every pixel coordinate times
  every bf16 factor of its inputs (the tool's draws, the forced-tie
  templates) is exact.
"""

import os

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
        sp["lists"][:int(sp["starts"][-1])].long(), sp["src"], f)
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


# -- the work-list walks (csrc/worklist.cu) -----------------------------------

def _walk_constants():
    """kPx, kMaxThreads and kColumnFirst as csrc/worklist.cu writes them."""
    import re

    from vri_tpu_torch import _cuda

    with open(os.path.join(_cuda.CSRC, "worklist.cu")) as f:
        text = f.read()
    px = int(re.search(r"constexpr int kPx = (\d+);", text).group(1))
    cap = int(re.search(r"constexpr int kMaxThreads = (\d+);",
                        text).group(1))
    first = re.search(r"constexpr bool kColumnFirst = (\w+);", text).group(1)
    return px, cap, first == "true"


def _walk_pixels(p, width, px, cap=1024, column_first=True):
    """Mirror of worklist.cu:walk_shape and pixel_of: (layout, pixel index
    (threads, ppt) of thread t's k-th pixel), or None for no layout."""
    threads = min(p // px, cap)
    ppt = p // threads
    column, row = threads % width == 0, width % ppt == 0
    t = np.arange(threads)[:, None]
    k = np.arange(ppt)[None, :]
    if column and (column_first or not row):
        return "column", t + k * threads
    if row:
        return "row", t * ppt + k
    return None


WALK_P = [128 * m for m in range(1, 9)] + [2048, 4096]


def test_walk_constants_are_the_mirrors():
    assert _walk_constants() == (4, 1024, True)


def _grouped_constants():
    """kGroupPx, kGroupColumnFirst and kGroupThreads (as its expression)
    as csrc/worklist_grouped.cu writes them."""
    import re

    from vri_tpu_torch import _cuda

    with open(os.path.join(_cuda.CSRC, "worklist_grouped.cu")) as f:
        text = f.read()
    px = int(re.search(r"constexpr int kGroupPx = (\d+);", text).group(1))
    first = re.search(r"constexpr bool kGroupColumnFirst = (\w+);",
                      text).group(1)
    threads = re.search(r"constexpr int kGroupThreads = ([^;]+);",
                        text).group(1)
    return px, first == "true", threads


GROUPED_P = [128 * m for m in range(1, 9)]


@pytest.mark.parametrize("p", GROUPED_P)
def test_grouped_pixel_map(p):
    """The grouped step's block (block_shape with kGroupPx, at most
    kGroupThreads = 1024 / kGroupPx threads): P / 4 threads, 4 pixels a
    thread covering each pixel once, in one column where the block is a
    whole number of tile rows (P = 512, 1024) and in one row elsewhere;
    for each k, consecutive threads hold consecutive
    pixels (column) or pixels 4 apart in one 512-byte span (row), so a
    warp's stores to a group row stay within 128 or 512 bytes."""
    px, column_first, threads = _grouped_constants()
    assert (px, column_first, threads) == (4, True, "1024 / kGroupPx")
    layout, pix = _walk_pixels(p, 128, px, cap=1024 // px,
                               column_first=column_first)
    assert pix.shape == (p // 4, 4)
    assert np.array_equal(np.sort(pix.ravel()), np.arange(p))
    assert layout == ("column" if p % 512 == 0 else "row")
    shared = pix % 128 if layout == "column" else pix // 128
    assert (shared == shared[:, :1]).all()
    step = np.diff(pix, axis=0)
    assert (step == (1 if layout == "column" else 4)).all()


@pytest.mark.parametrize("p", WALK_P)
@pytest.mark.parametrize("px", [2, 4, 8])
@pytest.mark.parametrize("column_first", [True, False])
def test_walk_pixel_map_covers_each_pixel_once(p, px, column_first):
    """Every pixel of a tile belongs to one (thread, k) in the template
    walk's layout (128 wide) and the setup walk's (TC wide, TC of 128 and
    256 dividing P), and a thread's pixels share one column (one px) or
    one row (one py)."""
    for width in (128, 256):
        if p % width:
            continue
        got = _walk_pixels(p, width, px, column_first=column_first)
        assert got is not None
        layout, pix = got
        assert np.array_equal(np.sort(pix.ravel()), np.arange(p))
        shared = pix % width if layout == "column" else pix // width
        assert (shared == shared[:, :1]).all()
        if width == 128 and px == 4:
            # the kernel's own constants: P / 4 threads, 4 pixels each
            assert pix.shape == (p // 4, 4)


def _exact(x, f):
    """x * f in float32 equals the float64 product, elementwise."""
    x32 = torch.as_tensor(x, dtype=torch.float32)
    return torch.equal((x32 * f).double(), x32.double() * f.double())


def _staged_factors(kind, evaluation, p):
    """Every factor the walk multiplies a pixel coordinate by, flattened:
    the bf16 (or FP32) pairs of ``_template_terms`` for the tools' draws,
    covering triangle templates, or (K=6) ``k6_operand``."""
    from vri_tpu_torch.ops import worklist
    from vri_tpu_torch.tools import covering_chunks

    if kind == "draws":
        *_, chunks = worklist.steps_inputs(8, num_tiles=30, num_chunks=8)
    else:
        chunks = covering_chunks(range(0, 2025, 253), p=p, tc=128)
    rows = torch.as_tensor(chunks)
    k6 = worklist.k6_operand(rows) if evaluation == "k6" else None
    tiles = torch.arange(rows.shape[0]) * 253
    pairs, _ = worklist._template_terms(rows, k6, tiles, p=p,
                                        evaluation=evaluation,
                                        translate=True)
    return torch.cat([f.flatten() for pair in pairs for f in pair])


@pytest.mark.parametrize("p", WALK_P)
@pytest.mark.parametrize("evaluation", ["bf16x2", "bf16x3", "k6"])
@pytest.mark.parametrize("kind", ["draws", "triangles"])
def test_bf16_products_are_exact(p, evaluation, kind):
    """The ground of the walks' fused products: every pixel coordinate
    (k + 0.5: 9 significant bits) times every staged bf16 factor (8 bits)
    is exact in FP32, so __fmaf_rn(x, f, acc) rounds as acc + x * f."""
    f = _staged_factors(kind, evaluation, p)[None, :]
    assert f.numel() > 0
    px = 0.5 + np.arange(128)[:, None]
    py = 0.5 + np.arange(p // 128)[:, None]
    assert _exact(px, f) and _exact(py, f)


def _grouped_factors(kind):
    """Every bf16 hi and lo factor the grouped step multiplies a pixel
    coordinate by, flattened: of ``grouped_inputs`` (the tool's draws) or
    of the forced-tie templates at W 1, 8 and 128."""
    from vri_tpu_torch.ops import worklist

    if kind == "draws":
        chunks = [worklist.grouped_inputs(8, num_chunks=8)[1]]
    else:
        chunks = [worklist.grouped_tie_inputs(8, w=w, seed=w)[1]
                  for w in (1, 8, 128)]
    rows = torch.as_tensor(np.concatenate(chunks))
    pairs, _ = worklist._template_terms(rows, None, None, p=1024,
                                        evaluation="bf16x2",
                                        translate=False)
    return torch.cat([f.flatten() for pair in pairs for f in pair])


@pytest.mark.parametrize("p", GROUPED_P)
@pytest.mark.parametrize("kind", ["draws", "ties"])
def test_grouped_bf16_products_are_exact(p, kind):
    """The ground of the grouped step's fused products (``record_field``,
    as the walks): every pixel coordinate of a P-pixel tile times every
    bf16 hi and lo factor of its inputs equals its float64 value."""
    f = _grouped_factors(kind)[None, :]
    assert f.numel() > 0 and bool((f != 0).any())
    px = 0.5 + np.arange(128)[:, None]
    py = 0.5 + np.arange(p // 128)[:, None]
    assert _exact(px, f) and _exact(py, f)


@pytest.mark.parametrize("kind", ["draws", "triangles"])
def test_fp32_products_are_not_exact(kind):
    """The FP32 mode's factors carry 24 bits: their products with pixel
    coordinates round, so a fused add would change the bits there."""
    f = _staged_factors(kind, "f32", 1024)[None, :]
    assert not _exact(0.5 + np.arange(128)[:, None], f)


def _per_lane(z, sid):
    """The per-lane rule over (steps, lanes, pixels): keep (z, lane) when
    z < best or equal z at a lower lane (worklist_common.cuh:
    lane_update, applied to every lane)."""
    n_px = z.shape[2]
    bz, bl, bs = np.full(n_px, 2.0), np.full(n_px, z.shape[1]), \
        np.zeros(n_px)
    for s in range(z.shape[0]):
        for lane in range(z.shape[1]):
            up = (z[s, lane] < bz) | ((z[s, lane] == bz) & (lane < bl))
            bz, bl = np.where(up, z[s, lane], bz), np.where(up, lane, bl)
            bs = np.where(up, sid[s, lane], bs)
    return bz, bs


def _step_then_merge(z, sid):
    """The walks' rule (worklist.cu:take_covered, lane_update): per step
    the first covering lane of least z (a strict "<" from the least float
    above 1, so z = 2, a miss, is never taken), merged into the run's
    best once a step by lane_update."""
    n_px = z.shape[2]
    bz, bl, bs = np.full(n_px, 2.0), np.full(n_px, z.shape[1]), \
        np.zeros(n_px)
    above_one = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    for s in range(z.shape[0]):
        sz, sl = np.full(n_px, above_one), np.zeros(n_px, np.int64)
        for lane in range(z.shape[1]):
            up = z[s, lane] < sz
            sz, sl = np.where(up, z[s, lane], sz), np.where(up, lane, sl)
        up = (sz < bz) | ((sz == bz) & (sl < bl))
        bz, bl = np.where(up, sz, bz), np.where(up, sl, bl)
        bs = np.where(up, sid[s][sl], bs)
    return bz, bs


def _finalized(bz, bs):
    """What a walk writes: z and the slot where z <= 1, misses elsewhere."""
    hit = bz <= 1.0
    return np.where(hit, bz, 3e38), np.where(hit, bs, -1)


@pytest.mark.parametrize("seed", range(4))
def test_step_merge_equals_the_per_lane_rule(seed):
    """On depths from a few values (ties across lanes and steps, misses
    at 2.0 and +-0), the walks' step-then-merge rule writes the per-lane
    rule's winner, and both the plain version's (``worklist._combine``
    over per-step minima); packed keys merged per step equal a strict
    "<" per lane."""
    from vri_tpu_torch.ops import worklist

    rng = np.random.default_rng(seed)
    steps, lanes, n_px = 5, 16, 256
    z = rng.choice(np.array([0.0, -0.0, 0.25, 0.5, 0.75, 1.0, 2.0]),
                   (steps, lanes, n_px), p=[.05, .05, .2, .2, .1, .1, .3])
    sid = rng.permutation(steps * lanes).reshape(steps, lanes).astype(
        np.float64)
    want = _per_lane(z, sid)
    got = _finalized(*_step_then_merge(z, sid))
    assert np.array_equal(got[0], _finalized(*want)[0])
    assert np.array_equal(got[1], _finalized(*want)[1])
    # the plain version: per-step minimum, its lowest lane, then _combine
    zt = torch.as_tensor(z, dtype=torch.float32).permute(0, 2, 1)
    zmin = zt.min(-1).values
    lane = torch.arange(lanes)
    win = torch.where(zt == zmin[..., None], lane, lanes).min(-1).values
    fl = torch.full((steps,), worklist.LIVE, dtype=torch.int32)
    fl[0] |= worklist.FIRST
    fl[-1] |= worklist.LAST
    best, bsid = worklist._combine(
        torch.tensor([0]), torch.tensor([steps - 1]), fl,
        [zmin, win, torch.gather(torch.as_tensor(sid, dtype=torch.float32)
                                 [:, None, :].expand(-1, n_px, -1), 2,
                                 win[..., None])[..., 0]], False, lanes)
    hit = want[0] <= 1.0
    assert np.array_equal(best[0].numpy()[hit], want[0][hit])
    assert np.array_equal(bsid[0].numpy()[hit], want[1][hit])
    # packed: keys with the lane in the low bits, strict "<" per lane
    # against the step's least key merged with a strict "<"
    mask = ~((1 << worklist.lane_bits(lanes)) - 1)
    key = (torch.as_tensor(z, dtype=torch.float32).view(torch.int32).numpy()
           & mask) | np.arange(lanes)[None, :, None]
    bk, bs = np.full(n_px, worklist.MISS_KEY), np.zeros(n_px)
    mk, ms = bk.copy(), bs.copy()
    for s in range(steps):
        for lane in range(lanes):
            up = key[s, lane] < bk
            bk, bs = np.where(up, key[s, lane], bk), \
                np.where(up, sid[s, lane], bs)
        sk = key[s].min(0)
        up = sk < mk
        mk = np.where(up, sk, mk)
        ms = np.where(up, sid[s][sk & ~mask], ms)
    assert np.array_equal(mk, bk) and np.array_equal(ms, bs)


def test_compiler_log_sits_beside_its_library(tmp_path, monkeypatch):
    """``_cuda.compiler_log`` reads the ptxas output kept beside a
    source's current library (``kernel_turns`` prints the registers from
    it, ``test_torch_cuda.py`` checks every source's), and is empty before
    that library is built."""
    from vri_tpu_torch import _cuda

    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path))
    assert _cuda.compiler_log("worklist_grouped.cu") == ""
    lib = _cuda.library_paths()["worklist_grouped.cu"]
    assert os.path.dirname(lib) == str(tmp_path)
    with open(lib[:-3] + ".log", "w") as f:
        f.write("ptxas info    : Used 58 registers\n")
    assert "58 registers" in _cuda.compiler_log("worklist_grouped.cu")
