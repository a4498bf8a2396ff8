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
