"""Multi-device dry run on the CPU (counterpart of
``__graft_entry__.dryrun_multichip``):

    python -m vri_tpu_torch.parallel.dryrun N

starts N CPU ranks over ``gloo`` (``python -m torch.distributed.run
--standalone``) that run the sharded paths on the Cornell box, 8N rows by
16 columns, against the port's own single-device functions:

* the tiled GI frame: finite colour of the frame's shape, every ray
  counted; at ``samples`` 0 its ``instance_id`` exactly equal to
  ``render_frame_gi``'s and its colour within 1e-4;
* the tiled temporal frame: after two frames the history count reaches 2
  on more than half the pixels;
* the tiled dynamic frame (sharded update and re-bake): ``atlas`` and
  ``voxel_shade`` bit-equal to ``render_frame_gi_dynamic``'s, ``needs_full``
  0 on both, colour within 1e-4;
* the sharded empty-space distance on cascade 0's real brick occupancy
  equal to ``sdf_build.esd_map``, and the sharded scroll equal to
  ``torch.roll``;
* for N >= 4 and even, the 2 x N/2 (hosts, tiles) mesh: ``instance_id``
  exactly equal to the single-device frame's, every ray counted.

Rank 0 builds the scene and cascades and broadcasts them
(``mesh.replicate``).  Every rank checks at its end that neither ``jax``
nor ``vri_tpu`` was imported.  The command exits non-zero when any rank
fails.
"""

from __future__ import annotations

import sys

import numpy as np


def _body(n: int) -> None:
    import torch

    torch.set_num_threads(1)
    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.ops import sdf as sdf_mod
    from vri_tpu_torch.ops import sdf_build
    from vri_tpu_torch.parallel import halo, multihost, tiling
    from vri_tpu_torch.parallel.mesh import (close, gather_rows, make_mesh,
                                             replicate, shard_rows)
    from vri_tpu_torch.passes import frame as frame_mod
    from vri_tpu_torch.registry import bake_world
    from vri_tpu_torch.renderer import Renderer

    mesh = make_mesh(n, backend="gloo", device="cpu")
    ax = mesh.axis()
    cpu = torch.device("cpu")
    cfg = SDFConfig(num_cascades=2, cascade_resolution=16, brick_size=8,
                    max_bricks=2048, base_voxel_size=0.15,
                    truncation_voxels=3.0, max_triangles_per_brick=8,
                    march_max_steps=32)
    h, w = 8 * n, 16
    # cornell at r=32 occupies ~6.9k bricks; the moved box's dirty region
    # covers much of it, so the bake cap spans the atlas
    bcfg = SDFConfig(num_cascades=2, cascade_resolution=32,
                     base_voxel_size=0.1, max_bricks=8192,
                     truncation_voxels=2.0, max_triangles_per_brick=8,
                     march_max_steps=32, update_cell_cap=2048,
                     update_brick_cap=256 * n, update_tri_cap=256,
                     bake_brick_cap=8192)
    inputs = None
    if mesh.rank == 0:
        r = Renderer(RenderConfig(width=w, height=h, sdf=cfg), device=cpu)
        r.load_stage(scenes.cornell_box())
        cas = r.ensure_cascades()
        scene = r.scene
        world = bake_world(scene)
        cas_d, st_d = sdf_build.build_for_scene(
            scene, world, sdf_mod.default_centers(bcfg, np.zeros(3),
                                                  device=cpu), bcfg)
        cas_d = sdf_mod.bake_brick_lighting(cas_d, scene, config=bcfg,
                                            alive=st_d.alive)
        inputs = (scene, cas, cas_d, st_d,
                  frame_mod.FrameParams.from_camera(r.camera, device=cpu))
    scene, cas, cas_d, st_d, fp = replicate(inputs, mesh)

    # -- the tiled GI frame -------------------------------------------------
    out = tiling.render_frame_tiled(scene, fp, cas, mesh=mesh, height=h,
                                    width=w, config=cfg, samples=1)
    color = out["color"]
    assert color.shape == (h, w, 3) and bool(torch.isfinite(color).all())
    assert float(out["stats"][0]) == h * w
    tiled = tiling.render_frame_tiled(scene, fp, cas, mesh=mesh, height=h,
                                      width=w, config=cfg, samples=0)
    single = frame_mod.render_frame_gi(scene, fp, cas, height=h, width=w,
                                       config=cfg, samples=0,
                                       use_cache=True)
    assert torch.equal(tiled["instance_id"], single["instance_id"])
    torch.testing.assert_close(tiled["color"], single["color"], rtol=1e-4,
                               atol=1e-4)

    # -- the temporal frame: the history carries across band borders ----------
    st = frame_mod.init_temporal(h // n, w, 1, device=cpu)
    for _ in range(2):
        aovs, st = tiling.render_frame_tiled_temporal(
            scene, fp, cas, st, mesh=mesh, height=h, width=w, config=cfg,
            samples=0, gi_scale=1, halo_rows=1)
    assert float((aovs["gi_history"] >= 2.0).float().mean()) > 0.5, \
        "temporal history did not carry"
    assert st.data.shape[0] == (h // n) * w

    # -- the sharded dynamic frame against the single-device one --------------
    ni = int(scene.num_instances)
    ext = (scene.instance_aabb_hi - scene.instance_aabb_lo)[:ni].amax(-1)
    k = int(torch.argmin(ext))
    off = torch.tensor([0.1, 0.0, 0.06])
    xf = scene.instance_transform.clone()
    xf[k, :3, 3] += off
    scene_d = scene.replace(instance_transform=xf)
    dirty = scene.tri_instance == k
    dlo = torch.full((4, 3), 3.0e38)
    dhi = torch.full((4, 3), -3.0e38)
    dlo[0], dhi[0] = scene.instance_aabb_lo[k], scene.instance_aabb_hi[k]
    dlo[1], dhi[1] = dlo[0] + off, dhi[0] + off
    kw = dict(height=h, width=w, config=bcfg, backend="brute", samples=0,
              use_cache=True, gi_scale=1)
    aov_s, _, cas_s, _, nf_s = frame_mod.render_frame_gi_dynamic(
        scene_d, fp, cas_d, st_d, frame_mod.init_temporal(h, w, 1,
                                                          device=cpu),
        dirty, dlo, dhi, **kw)
    aov_t, _, cas_t, _, nf_t = tiling.render_frame_tiled_dynamic(
        scene_d, fp, cas_d, st_d, frame_mod.init_temporal(h // n, w, 1,
                                                          device=cpu),
        dirty, dlo, dhi, mesh=mesh, halo_rows=1, **kw)
    assert int(nf_s) == 0 and int(nf_t) == 0
    assert torch.equal(cas_t.atlas, cas_s.atlas)
    assert torch.equal(cas_t.voxel_shade, cas_s.voxel_shade)
    torch.testing.assert_close(aov_t["color"], aov_s["color"], rtol=1e-4,
                               atol=1e-4)

    # -- the SDF build tier over z-slabs: ESD and scroll ----------------------
    occ = cas.brick_map[0] >= 0
    dense = sdf_build.esd_map(occ[None], max_esd=6).reshape(occ.shape)
    sharded = gather_rows(halo.esd_sharded(shard_rows(occ, mesh), ax, 6),
                          mesh)
    assert torch.equal(sharded, dense)
    vol = occ.to(torch.float32)
    rolled = gather_rows(halo.scroll_slab(shard_rows(vol, mesh), 2, 0, ax),
                         mesh)
    assert torch.equal(rolled, torch.roll(vol, -2, 0))

    # -- the 2-D (hosts, tiles) mesh -------------------------------------------
    done = "2-D mesh skipped"
    if n >= 4 and n % 2 == 0:
        mesh2 = multihost.make_mesh_2d(2, n // 2, backend="gloo",
                                       device="cpu")
        out2 = multihost.render_frame_tiled_2d(
            scene, fp, cas, mesh=mesh2, height=h, width=w, config=cfg,
            samples=0)
        assert torch.equal(out2["instance_id"], single["instance_id"])
        assert float(out2["stats"][0]) == h * w
        done = "2-D hosts x tiles mesh ok"
    for name in ("jax", "vri_tpu"):
        assert sys.modules.get(name) is None, f"{name} was imported"
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): frame {tuple(color.shape)} ok, "
              "sharded dynamic update bit-exact, sharded-build ESD parity + "
              f"scroll ok, {done}", flush=True)
    close(mesh)


def dryrun_multichip(n: int, timeout: float = 1800) -> int:
    """Run the dry run over ``n`` CPU ranks; returns the launch's exit
    code (non-zero when any rank failed)."""
    from vri_tpu_torch.parallel.mesh import launch

    return launch(n, ["-m", "vri_tpu_torch.parallel.dryrun", "--rank",
                      str(int(n))], timeout=timeout).returncode


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        _body(int(argv[1]))
        return 0
    return dryrun_multichip(int(argv[0]) if argv else 4)


if __name__ == "__main__":
    sys.exit(main())
