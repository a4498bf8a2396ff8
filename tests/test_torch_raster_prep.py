"""The sorted tier's prep (``rasterize.prepare_sorted``) on the CPU: its
plain version's fixed-length pair stream and its on-device overflow flag.

``lists`` is ``pairs_cap`` long whatever the frame; its live part,
``lists[:starts[-1]]``, is checked against a direct enumeration of the
(tile, slot) pairs: every visible slot, in slot order, emits one pair
per tile of its on-screen window, row-major, until the stream holds
``pairs_cap`` pairs; each tile lists its slots in ascending order.  The
overflow flag (0-d int32, computed with no size read back to the host)
is set by exactly one of its three causes in the cases built for each:
the emission past ``pairs_cap``, more near-plane crossers than the
second-slot capacity, a tile holding more than ``cap`` slots.

The case builders (``PREP_CASES``) are shared with
``tests/test_torch_cuda.py``, which holds the prep's CUDA kernels
(``rasterize.raster_prep``) bit-equal to this plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vri_tpu_torch import RenderConfig, scenes  # noqa: E402
from vri_tpu_torch.hydra.camera import make_camera  # noqa: E402
from vri_tpu_torch.ops import rasterize  # noqa: E402


def kitchen_args(h=192, w=256, num_objects=24, tess=2, device="cpu"):
    """The kitchen stage through its authored camera: (args, kw) of
    ``prepare_sorted`` with the scene's cull signs."""
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    d = RenderDelegate(RenderConfig(width=w, height=h), device=device)
    d.populate(scenes.kitchen_stress(num_objects=num_objects, tess=tess))
    scene = d.sync()
    fp = frame_mod.FrameParams.from_camera(d.camera, h, device=device)
    return ((bake_world(scene), scene.tri_vertices, scene.num_faces,
             fp.view_proj),
            dict(height=h, width=w, cull_sign=frame_mod._cull_sign(scene)))


def _triangles(centers, size, rng):
    """(world verts, tri ids) of one triangle around each center, corners
    up to ``size`` off it."""
    n = centers.shape[0]
    v = centers[:, None, :] + rng.uniform(-size, size, (n, 3, 3))
    return (torch.as_tensor(v.reshape(-1, 3).astype(np.float32)),
            torch.arange(3 * n, dtype=torch.int32).reshape(n, 3))


def crossers_args(n=600, spread_z=2.0, seed=4, h=96, w=256):
    """A perspective camera at the origin looking down -z inside a cloud of
    ``n`` triangles (centers within ``spread_z`` of the camera's plane):
    many cross the near plane, and those with two corners in front take a
    second clipped slot.  Random cull signs (0, 1, -1)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2.0, 2.0, (n, 3))
    c[:, 2] = rng.uniform(-spread_z, spread_z, n)
    world, tri = _triangles(c, 0.6, rng)
    cam = make_camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 70.0, w / h)
    cull = torch.as_tensor(rng.choice([0.0, 1.0, -1.0], n)
                           .astype(np.float32))
    return ((world, tri, n, torch.as_tensor(cam.view_proj,
                                            dtype=torch.float32)),
            dict(height=h, width=w, cull_sign=cull))


def crowded_tile_args(n=400, seed=6):
    """``n`` small triangles inside the first 8 x 128 tile of a 64 x 512
    frame (the identity view-projection puts world x, y on the screen):
    that tile lists every one, more than the smallest cap (128)."""
    rng = np.random.default_rng(seed)
    px = np.stack([rng.uniform(4, 124, n), rng.uniform(1.5, 6.5, n),
                   rng.uniform(0.2, 0.8, n)], 1)
    world, tri = _triangles(px, 1.0, rng)
    w = world.numpy().copy()
    w[:, 0] = w[:, 0] / 256.0 - 1.0           # screen x = 256 (wx + 1)
    w[:, 1] = 1.0 - w[:, 1] / 32.0            # screen y = 32 (1 - wy)
    return ((torch.as_tensor(w), tri, n, torch.eye(4)),
            dict(height=64, width=512, cap=1))


def _compacted(args, kw, keep=0.6, seed=8):
    """The frustum-compacted form: a sorted subset of the faces with its
    face ids as ``src_map`` and a live count short of the subset."""
    world, tri, nf, vp = args
    f = tri.shape[0]
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(np.sort(rng.choice(f, int(f * keep),
                                             replace=False))
                          .astype(np.int32)).to(tri.device)
    kw = dict(kw, src_map=ids,
              cull_sign=kw["cull_sign"][ids.long()])
    live = torch.tensor(ids.shape[0] - 7, dtype=torch.int32,
                        device=tri.device)
    return (world, tri[ids.long()], live, vp), kw


def _masked(args, kw, seed=9):
    f = args[1].shape[0]
    mask = torch.as_tensor(np.random.default_rng(seed).random(f) < 0.5)
    return args, dict(kw, face_mask=mask.to(args[1].device))


#: case -> (args, kw) of prepare_sorted on the CPU, and the overflow it
#: must report
PREP_CASES = {
    "kitchen": (lambda: kitchen_args(), 0),
    "kitchen_nocull": (lambda: (lambda a, k: (a, dict(k, cull_sign=None)))(
        *kitchen_args()), 0),
    "crossers": (lambda: crossers_args(), 0),
    "band": (lambda: (lambda a, k: (a, dict(
        k, height=64, proj_height=192, y_offset=48.0)))(*kitchen_args()), 0),
    "src_map": (lambda: _compacted(*kitchen_args()), 0),
    "face_mask": (lambda: _masked(*kitchen_args()), 0),
    "caps_scale_2": (lambda: (lambda a, k: (a, dict(k, caps_scale=2)))(
        *kitchen_args()), 0),
    "pairs_cap_exceeded": (lambda: (lambda a, k: (a, dict(
        k, pairs_cap=1000)))(*kitchen_args()), 1),
    "extra_cap_exceeded": (lambda: crossers_args(n=3000, spread_z=0.4), 1),
    "tile_over_cap": (lambda: crowded_tile_args(), 1),
    "no_faces": (lambda: (lambda a, k: ((a[0], a[1], 0, a[3]), k))(
        *kitchen_args()), 0),
}


def _enumerate(prep, pairs_cap, tile_h=8, tile_w=128):
    """(per-tile slot lists, emitted pair total): every live slot of the
    table, in slot order, over its on-screen tile window row-major."""
    coef = prep["coef"]
    gy, gx = prep["grid"]
    tx0, tx1, ty0, ty1 = (x.tolist() for x in rasterize._tile_span(
        coef[:, 0:6:2], coef[:, 1:6:2], tile_h, tile_w))
    live = (coef[:, 7] > 0.5).tolist()
    lists = [[] for _ in range(gy * gx)]
    total = 0
    for s in range(coef.shape[0]):
        if not live[s] or tx1[s] < 0 or tx0[s] >= gx or ty1[s] < 0 \
                or ty0[s] >= gy:
            continue
        for r in range(max(ty0[s], 0), min(ty1[s], gy - 1) + 1):
            for c in range(max(tx0[s], 0), min(tx1[s], gx - 1) + 1):
                if total < pairs_cap:
                    lists[r * gx + c].append(s)
                total += 1
    return lists, total


def _clip_overflow(args, kw, extra):
    """Near-plane crossers past the second-slot capacity, as the setup
    counts them."""
    return int(rasterize.triangle_setup_clipped(
        *args, kw.get("proj_height") or kw["height"], kw["width"],
        extra_cap=extra, cull_sign=kw.get("cull_sign"),
        src_map=kw.get("src_map"), face_mask=kw.get("face_mask"))[8])


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_plain_prep_fixed_stream_and_overflow(case):
    build, want_overflow = PREP_CASES[case]
    args, kw = build()
    prep = rasterize.prepare_sorted(*args, **kw)
    f = args[1].shape[0]
    scale = kw.get("caps_scale", 1)
    extra = max(f // 16, 256) * scale
    slots = prep["coef"].shape[0]
    assert slots == rasterize._round_up(f + extra + 1, 128)
    pairs_cap = rasterize._round_up(
        kw["pairs_cap"] * scale if "pairs_cap" in kw else max(min(
            (4 if kw.get("cull_sign") is not None else 6) * slots,
            2 * 1024 * 1024), 128 * 1024) * scale, 128)
    lists, starts, counts = prep["lists"], prep["starts"], prep["counts"]
    assert lists.shape == (pairs_cap,) and lists.dtype == torch.int32
    assert prep["overflow"].shape == () \
        and prep["overflow"].dtype == torch.int32
    want, total = _enumerate(prep, pairs_cap)
    n = int(starts[-1])
    assert n == min(total, pairs_cap)
    assert counts.tolist() == [len(x) for x in want]
    assert torch.equal(starts[:-1] + counts, starts[1:])
    got = lists[:n].tolist()
    assert [got[s:s + c] for s, c in zip(starts[:-1].tolist(),
                                         counts.tolist())] == want
    causes = dict(emission=total > pairs_cap,
                  clip=_clip_overflow(args, kw, extra) > 0,
                  cap=int(counts.max()) > prep["cap"])
    assert int(prep["overflow"]) == int(any(causes.values())) \
        == want_overflow, causes
    if want_overflow:
        # each overflow case trips exactly its own cause
        assert sum(causes.values()) == 1, causes
        assert causes[{"pairs_cap_exceeded": "emission",
                       "extra_cap_exceeded": "clip",
                       "tile_over_cap": "cap"}[case]]
    if case == "no_faces":
        assert n == 0 and int(counts.sum()) == 0
    else:
        assert n > 0


def test_plain_prep_matches_the_setup_it_is_built_on():
    """The slot table and ``src`` are the padded setup's (first slots,
    then the compacted second slots), with near-plane crossers present."""
    args, kw = crossers_args()
    prep = rasterize.prepare_sorted(*args, **kw)
    f = args[1].shape[0]
    tx, ty, tz, tw, b1, b2, src, valid, clip_over = rasterize._padded_setup(
        *args, height=kw["height"], width=kw["width"],
        extra_cap=max(f // 16, 256), cull_sign=kw["cull_sign"])
    assert int(clip_over) == 0 and int(valid[f:].sum()) > 20
    assert torch.equal(prep["src"], src)
    assert torch.equal(prep["coef"], rasterize.slot_coefficients(
        tx, ty, tz, tw, b1, b2, valid))


def test_plain_prep_counts_the_kernel_r_walk():
    """Kernel R's plain version walks the fixed-length lists as it walked
    the stream cut to its pairs, and reads nothing past it: the same hit
    at every pixel with the lists' tail holding slot ids far out of
    range (the kernels leave the tail undefined)."""
    args, kw = kitchen_args()
    prep = rasterize.prepare_sorted(*args, **kw)
    n = int(prep["starts"][-1])
    kw_r = dict(num_tx=prep["num_tx"], cap=prep["cap"])
    poisoned = prep["lists"].clone()
    poisoned[n:] = 2 ** 31 - 1
    walks = [rasterize.raster_tiles(prep["coef"], lists, prep["starts"],
                                    prep["counts"], **kw_r)
             for lists in (prep["lists"], prep["lists"][:n].clone(),
                           poisoned)]
    assert n < poisoned.shape[0] and (walks[0][1] >= 0).float().mean() > 0.3
    for other in walks[1:]:
        for a, b in zip(walks[0], other):
            assert torch.equal(a, b)
