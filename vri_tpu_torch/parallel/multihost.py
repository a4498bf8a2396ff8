"""A 2-D (hosts, tiles) mesh (counterpart of
``vri_tpu/parallel/multihost.py``).

The layout of the JAX package: framebuffer rows shard over both axes (a
rank's band is ``host * tiles + chip``), per-frame stats sum over both,
and a scene synced in partitions (each host owning a disjoint set of
instances) becomes the replicated scene through one sum over the
``hosts`` axis only.  Ranks are host-major: rank = host * chips + chip,
as ``torch.distributed.run`` numbers the ranks of several nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from vri_tpu_torch.parallel import mesh as mesh_mod
from vri_tpu_torch.parallel.mesh import Mesh
from vri_tpu_torch.parallel.tiling import render_band_static
from vri_tpu_torch.passes.frame import FrameParams
from vri_tpu_torch.registry import SceneBuffers


def make_mesh_2d(n_hosts: int, chips_per_host: Optional[int] = None,
                 axes=("hosts", "tiles"), backend: Optional[str] = None,
                 device=None) -> Mesh:
    """The (hosts, tiles) mesh of the launch's ranks, host-major; the
    world size must be ``n_hosts * chips_per_host``.  Every rank creates
    every subgroup, in the same order."""
    rank, world, local_rank, local_world, launched = mesh_mod._env_ranks()
    chips = chips_per_host or world // n_hosts
    if chips < 1 or n_hosts * chips != world:
        raise ValueError(f"a {n_hosts} x {chips} mesh needs "
                         f"{n_hosts * chips} ranks, the launch has {world}")
    device, backend = mesh_mod._device_and_backend(device, backend,
                                                   local_rank, local_world)
    if not launched:
        return Mesh(tuple(axes), (1, 1), (0, 0), device, None, (None, None))
    mesh_mod._join(backend, rank, world)
    tiles = [dist.new_group([h * chips + c for c in range(chips)])
             for h in range(n_hosts)]
    hosts = [dist.new_group([h * chips + c for h in range(n_hosts)])
             for c in range(chips)]
    coords = (rank // chips, rank % chips)
    return Mesh(tuple(axes), (n_hosts, chips), coords, device, backend,
                (hosts[coords[1]], tiles[coords[0]]))


def merge_scene_partitions(scene: SceneBuffers, host_instance: torch.Tensor,
                           mesh: Mesh) -> SceneBuffers:
    """One sum over the ``hosts`` axis turns the hosts' partial scenes into
    the replicated scene.  Every host holds the same layout (slots,
    counts, materials, lights); ``host_instance`` (I,) maps each instance
    slot to its owning host, and only an owner's rows of the per-vertex,
    per-face and per-instance pools need be right.  Each host masks those
    pools to the rows it owns before the sum, so whatever the others held
    there drops out, and a replicated scene merges to itself.  Bool pools
    sum as int32; shared fields and empty pools pass through."""
    hosts = mesh.axis(mesh.axis_names[0])
    own_inst = host_instance.to(scene.device) == hosts.index
    own_vert = own_inst[scene.vertex_instance.long()]
    own_face = own_inst[scene.tri_instance.long()]
    by_mask = {
        "vertex_instance": own_vert,
        "tri_vertices": own_face, "tri_instance": own_face,
        "instance_transform": own_inst, "instance_material": own_inst,
        "instance_face_offset": own_inst, "instance_face_count": own_inst,
        "instance_double_sided": own_inst,
        "instance_aabb_lo": own_inst, "instance_aabb_hi": own_inst,
    }
    # under shared-prototype instancing the prototype pools are stage
    # layout, the same on every host
    if scene.tri_proto is not None:
        by_mask.update(vertex_proto=own_vert, tri_proto=own_face)
    else:
        by_mask.update(positions=own_vert, tri_uv=own_face,
                       tri_face=own_face)

    def one(name, a):
        own = by_mask.get(name)
        if own is None or a is None or a.numel() == 0:
            return a
        m = own.reshape(own.shape + (1,) * (a.dim() - own.dim()))
        if a.dtype == torch.bool:
            s = mesh_mod.psum(torch.where(m, a, False).to(torch.int32),
                              hosts)
            return s > 0
        return mesh_mod.psum(torch.where(m, a, torch.zeros((), dtype=a.dtype,
                                                           device=a.device)),
                             hosts)

    return dataclasses.replace(scene, **{
        f.name: one(f.name, getattr(scene, f.name))
        for f in dataclasses.fields(scene) if f.name in by_mask})


def render_frame_tiled_2d(scene: SceneBuffers, frame: FrameParams, cascades,
                          *, mesh: Mesh, height: int, width: int, config,
                          gi: bool = True, samples: int = 1,
                          backend: str = "raster", use_cache: bool = True,
                          seed: int = 0, uniforms: torch.Tensor | None = None
                          ) -> Dict[str, torch.Tensor]:
    """The production frame with rows sharded over hosts x chips: the body
    of ``tiling.render_frame_tiled`` with the band index ``host * tiles +
    chip`` and the stats summed over both axes.  As the JAX function
    (``vri_tpu/parallel/multihost.py:187``), raster depth becomes the world
    ray distance for ``backend == "raster"`` only; ``raster2x`` and the
    other raster backends keep the raster's NDC depth."""
    return render_band_static(
        scene, frame, cascades, mesh.axis(), height=height, width=width,
        config=config, gi=gi, samples=samples, backend=backend,
        use_cache=use_cache, seed=seed, uniforms=uniforms,
        world_depth=backend == "raster")
