"""Packet-traversal entry points of the LBVH (counterpart of
``vri_tpu/ops/bvh_kernel.py``).

The JAX package walks 1024-ray blocks in lock-step through one shared
stack (K8, ``_traverse_kernel``).  On the GPU the same contract -- the
nearest triangle slot of every ray -- comes from the per-ray kernel
``bvh_traverse`` (``ops/bvh.py``, ``csrc/bvh_traverse.cu``); the two
functions here keep the reference's names over it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vri_tpu_torch.ops import bvh as bvh_mod
from vri_tpu_torch.ops.intersect import HitRecord


def trace_packet(bvh: bvh_mod.BVH, origins: torch.Tensor,
                 dirs: torch.Tensor, *, max_nodes: int = 16384
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace rays through the BVH: (t (N,), slot_id (N,)), slot ids index
    the BVH's Morton-sorted triangle order (map through ``bvh.order`` for
    source ids); a miss has slot -1 and t = 3e38.

    ``max_nodes`` is accepted for the reference's signature and unused:
    K8 cut its shared-stack walk after that many pops, but a per-ray walk
    pops each node at most once (2L - 1 pops), so nothing needs cutting."""
    del max_nodes
    t, slot, _, _ = bvh_mod.trace_slots(bvh, origins, dirs)
    return t, slot


def trace_packet_hits(bvh: bvh_mod.BVH, origins, dirs, *,
                      max_nodes: int = 16384) -> HitRecord:
    """HitRecord adapter: :func:`bvh.traverse`.  Unlike the reference's,
    which reports u = v = 0, it carries the hit's barycentrics;
    ``max_nodes`` is unused, as in :func:`trace_packet`."""
    del max_nodes
    return bvh_mod.traverse(bvh, origins, dirs)
