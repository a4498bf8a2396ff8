"""Halo exchange for z-slab-sharded volumes (counterpart of
``vri_tpu/parallel/halo.py``).

Each rank holds a z-slab of a volume, (slab_z + 2*halo, ...) with the
interior at [halo : halo + slab_z], and refreshes its ghost planes from
its ring neighbours with :func:`mesh.ppermute`.  The functions take the
JAX functions' arguments in the same order, the mesh axis in place of
``axis_name``.  Users: the SDF build tier's empty-space distance
(:func:`esd_sharded`), the clipmap scroll of a sharded volume
(:func:`scroll_slab`) and the sharded temporal frames' history ghost rows
(:func:`exchange_halo_fill`, ``parallel/tiling.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vri_tpu_torch.parallel.mesh import MeshAxis, ppermute


def _rings(n: int):
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    return right, left


def exchange_halo(slab: torch.Tensor, halo: int, axis: MeshAxis
                  ) -> torch.Tensor:
    """Refresh the ghost planes of a z-slab from its ring neighbours; the
    boundary ranks wrap (the cascade volume is toroidal under a clipmap
    scroll)."""
    interior = slab[halo:-halo] if halo else slab
    right, left = _rings(axis.size)
    # my top interior planes go to the right neighbour's low ghost, my
    # bottom ones to the left neighbour's high ghost
    from_left = ppermute(interior[-halo:], right, axis)
    from_right = ppermute(interior[:halo], left, axis)
    return torch.cat([from_left, interior, from_right])


def scroll_slab(slab: torch.Tensor, shift: int, halo: int, axis: MeshAxis
                ) -> torch.Tensor:
    """A clipmap scroll of ``shift`` planes along z of the sharded volume:
    ``torch.roll(volume, -shift, 0)`` re-sharded, moving only the planes
    that cross a slab border and whole slabs around the ring; then the
    halos are refreshed."""
    n = axis.size
    interior = slab[halo:-halo] if halo else slab
    slab_z = interior.shape[0]
    dev_shift, local = divmod(shift % (slab_z * n), slab_z)
    if local:
        incoming = ppermute(interior[:local], _rings(n)[1], axis)
        interior = torch.cat([interior[local:], incoming])
    if dev_shift:
        interior = ppermute(interior,
                            [(i, (i - dev_shift) % n) for i in range(n)],
                            axis)
    if halo:
        pad = torch.zeros((halo,) + tuple(interior.shape[1:]),
                          dtype=interior.dtype, device=interior.device)
        return exchange_halo(torch.cat([pad, interior, pad]), halo, axis)
    return interior


def exchange_halo_fill(interior: torch.Tensor, halo: int, axis: MeshAxis,
                       fill) -> torch.Tensor:
    """Attach ``halo`` ghost planes from the ring neighbours without
    wrapping: beyond the volume's outer boundary the planes hold ``fill``
    (the SAME padding of a dense computation)."""
    right, left = _rings(axis.size)
    from_left = ppermute(interior[-halo:], right, axis)
    from_right = ppermute(interior[:halo], left, axis)
    if axis.index == 0:
        from_left = torch.full_like(from_left, fill)
    if axis.index == axis.size - 1:
        from_right = torch.full_like(from_right, fill)
    return torch.cat([from_left, interior, from_right])


def esd_sharded(occ_slab: torch.Tensor, axis: MeshAxis, max_esd: int
                ) -> torch.Tensor:
    """Chebyshev empty-space distance of a z-slab-sharded occupancy volume
    (slab_z, R, R) bool: ``max_esd - 1`` sweeps of a 3x3x3 min-pool, each
    over the slab and one ghost plane a side (fill ``max_esd + 1``, as the
    dense build's SAME padding).  Returns (slab_z, R, R) int32 clipped to
    [1, max_esd], equal to ``sdf_build.esd_map`` of the whole volume."""
    d = torch.where(occ_slab, 0.0, float(max_esd))
    for _ in range(max_esd - 1):
        ext = exchange_halo_fill(d, 1, axis, float(max_esd) + 1.0)
        # max-pool pads with -inf: the min-pool of reduce_window's SAME
        pooled = -F.max_pool3d(-ext[None, None], 3, 1, 1)[0, 0]
        d = torch.minimum(d, pooled[1:-1] + 1.0)
    return torch.clamp(d.to(torch.int32), 1, max_esd)
