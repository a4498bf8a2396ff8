"""Port of tools/prof_worklist.py: stage isolation of the sorted raster
tier at a given tess: prep vs kernel vs resolve.

    python -m vri_tpu_torch.tools.prof_worklist [TESS] [--nocull]
        [--device cpu] [--width 1920 --height 1080] [--objects 256]

Renders nothing: it syncs ``kitchen_stress(num_objects, tess)`` (default
256 objects, tess 4) at 1920x1080, then times ``rasterize_sorted`` whole
and each of its stages on the stage's real intermediates:
``prepare_sorted`` (setup, emission, sort, slot table), kernel R
(``raster_tiles``) alone, and the resolve to a ``HitRecord``.  The TPU
tool's grouped kernel (K2) has no counterpart: its short lists are short
loops of kernel R, so its row reads "folded into raster_tiles".  Where
the tool printed work-list steps, this prints tiles and (tile, slot)
pairs.
"""

from __future__ import annotations

from vri_tpu_torch.tools import card_line, device_of, parser, time_ms

TILE_H, TILE_W = 8, 128


def stages(scene, world, view_proj, *, height: int, width: int,
           cull_sign):
    """The sorted tier's stages as callables: ``full()``, ``prepare()``,
    ``kernel(prep)`` and ``resolve(prep, out)``; ``resolve(prep,
    kernel(prep))`` is ``full()``."""
    from vri_tpu_torch.ops import rasterize

    args = (world, scene.tri_vertices, scene.num_faces, view_proj)
    kw = dict(height=height, width=width, cull_sign=cull_sign)
    return dict(
        full=lambda: rasterize.rasterize_sorted(*args, **kw),
        prepare=lambda: rasterize.prepare_sorted(*args, **kw),
        kernel=lambda prep: rasterize.raster_tiles(
            prep["coef"], prep["lists"], prep["starts"], prep["counts"],
            num_tx=prep["num_tx"], cap=prep["cap"]),
        resolve=lambda prep, out: rasterize._frame_hit(
            prep, out, height=height, width=width, tile_h=TILE_H,
            tile_w=TILE_W, overflow=prep["overflow"]))


def load(device, *, tess: int, objects: int, width: int, height: int,
         cull: bool):
    """(scene, world, view_proj, cull_sign) of the kitchen stage."""
    from vri_tpu_torch import RenderConfig, scenes
    from vri_tpu_torch.hydra.delegate import RenderDelegate
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world

    d = RenderDelegate(RenderConfig(width=width, height=height),
                       device=device)
    d.populate(scenes.kitchen_stress(num_objects=objects, tess=tess))
    scene = d.sync()
    fp = frame_mod.FrameParams.from_camera(d.camera, height, device=device)
    cs = frame_mod._cull_sign(scene) if cull else None
    return scene, bake_world(scene), fp.view_proj, cs


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("tess", nargs="?", type=int, default=4)
    ap.add_argument("--nocull", action="store_true")
    ap.add_argument("--objects", type=int, default=256)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    dev = device_of(a.device)
    print(card_line(dev), flush=True)
    scene, world, vp, cs = load(dev, tess=a.tess, objects=a.objects,
                                width=a.width, height=a.height,
                                cull=not a.nocull)
    print("faces:", int(scene.num_faces))
    st = stages(scene, world, vp, height=a.height, width=a.width,
                cull_sign=cs)
    prep = st["prepare"]()
    out = st["kernel"](prep)
    assert int(prep["overflow"]) == 0, "the sorted tier overflowed"
    counts = prep["counts"]
    tiles = int(counts.shape[0])
    pairs = int(counts.sum())
    print(f"tiles {tiles}, (tile, slot) pairs {pairs}, longest list "
          f"{int(counts.max())}, slots {int(prep['coef'].shape[0])}")

    def bench(label, fn):
        ms = time_ms(fn, a.iters, dev)
        print(f"{label:34s} {ms:8.3f} ms", flush=True)
        return ms

    t_full = bench("full rasterize_sorted", st["full"])
    t_prep = bench("prepare_sorted", st["prepare"])
    t_k = bench("dense pass1 kernel (kernel R)", lambda: st["kernel"](prep))
    print(f"{'grouped kernel':34s} folded into raster_tiles")
    t_res = bench("resolve (HitRecord)", lambda: st["resolve"](prep, out))
    print("---- derived ----")
    print(f"prep (emission+sort+template)      {t_prep:8.3f} ms")
    print(f"merge+resolve                      {t_res:8.3f} ms")
    print(f"rest of the whole raster           "
          f"{t_full - t_prep - t_k - t_res:8.3f} ms")
    print(f"per tile                           "
          f"{t_k / max(tiles, 1) * 1e3:8.3f} us  ({tiles} tiles)")
    print(f"per (tile, slot) pair              "
          f"{t_k / max(pairs, 1) * 1e6:8.3f} ns  ({pairs} pairs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
