"""Rendering over several devices on ``torch.distributed`` (counterpart of
``vri_tpu/parallel``): the mesh and its collectives (``mesh``), the halo
exchange (``halo``), the row-sharded frames (``tiling``) and the
(hosts, tiles) mesh (``multihost``); ``python -m
vri_tpu_torch.parallel.dryrun N`` runs them over N CPU ranks."""

from vri_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
