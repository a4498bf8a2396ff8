"""SDF ray marching entry points (counterpart of
``vri_tpu/ops/sdf_trace.py``).

The approximate tier -- occlusion, shadow and GI-gather rays at voxel
precision -- dispatches to the march kernel exactly as the JAX package's
TPU branch does (``sdf_trace.py:218-229`` and ``:311-321``), with the same
step budget ``ks = max_steps * 2 + 16``: kernel steps are voxel-granular,
so the budget is scaled.  The XLA trilinear sphere march (``_sample``,
``_march_loop``), the quality tier behind the SDF debug views, is not
ported yet: a call that would need it raises ``NotImplementedError``
(ROADMAP.md, "What comes next", item 1).
"""

from __future__ import annotations

import dataclasses

import torch

from vri_tpu.config import SDFConfig
from vri_tpu_torch.ops.sdf import SDFCascades

BIG = 3.0e38

_TRILINEAR_TODO = (
    "the trilinear SDF march (sdf_trace._sample/_march_loop) is not ported "
    "yet; see ROADMAP.md 'What comes next', item 1")


@dataclasses.dataclass
class SDFHit:
    t: torch.Tensor           # (M,) f32 — BIG on miss
    hit: torch.Tensor         # (M,) bool
    iterations: torch.Tensor  # (M,) i32
    cascade: torch.Tensor     # (M,) i32 — cascade of the hit voxel
    brick: torch.Tensor       # (M,) i32 — atlas brick at the hit
    uvw: torch.Tensor         # (M, 3) f32 — position within the voxel
    #: flat hit-voxel id (cas * R^3 + voxel), -1 on miss
    voxel: torch.Tensor | None = None


def _kernel_steps(max_steps: int | None, config: SDFConfig) -> int:
    return (max_steps or config.march_max_steps) * 2 + 16


def march(sdf: SDFCascades, origins: torch.Tensor, dirs: torch.Tensor,
          t_max, *, config: SDFConfig, max_steps: int | None = None,
          approx: bool = False, compact: bool = False) -> SDFHit:
    """March rays (M, 3) through the cascades.  Only the approximate tier
    (``approx=True`` with ``config.kernel_march`` on a supported
    resolution) is ported; it runs the voxel-precision march kernel."""
    from vri_tpu_torch.ops import march_kernel

    if not (approx and config.kernel_march
            and march_kernel.supports(config)):
        raise NotImplementedError(_TRILINEAR_TODO)
    if compact:
        raise NotImplementedError(
            "march_compact (config.compact_march) is not ported; see "
            "ROADMAP.md 'What comes next', item 1")
    return march_kernel.march(sdf, origins, dirs, t_max, config=config,
                              max_steps=_kernel_steps(max_steps, config))


def occlusion(sdf: SDFCascades, origins: torch.Tensor, dirs: torch.Tensor,
              t_max, *, config: SDFConfig, max_steps: int | None = None
              ) -> torch.Tensor:
    """Shadow factor in [0,1]: 0 = blocked, from the voxel-precision
    march kernel (hit / t only)."""
    from vri_tpu_torch.ops import march_kernel

    if not (config.kernel_march and march_kernel.supports(config)):
        raise NotImplementedError(_TRILINEAR_TODO)
    if config.compact_march:
        raise NotImplementedError(
            "march_compact (config.compact_march) is not ported; see "
            "ROADMAP.md 'What comes next', item 1")
    rec = march_kernel.march(sdf, origins, dirs, t_max, config=config,
                             max_steps=_kernel_steps(max_steps, config),
                             payload=False)
    return 1.0 - rec.hit.float()
