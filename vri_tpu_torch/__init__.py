"""vri_tpu_torch — the PyTorch / CUDA port of ``vri_tpu`` for one NVIDIA
H100.

It renders the static-stage GI frame of ``vri_tpu`` with torch tensors on
an explicit device: USD stage -> packed scene tensors
(``registry``) -> sorted-list raster (CUDA kernel ``raster_tiles``) ->
G-buffer -> cell-binned SDF cascades -> SDF-shadowed direct light and one
GI bounce marched through the cascades (CUDA kernel ``march_rays``).  The
kernels live in ``csrc/`` and are built with ``nvcc`` at first use; on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.

The package imports ``torch`` and never ``jax``: it reuses only the
jax-free host modules of ``vri_tpu`` (``config``, ``usd``,
``hydra.{camera,material,meshutil}``, ``utils``, ``runtime.native``).
The configuration classes and the procedural stages a caller needs are
re-exported here::

    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.renderer import Renderer
"""

__version__ = "0.1.0"

from vri_tpu.config import (DebugMode, RenderConfig, SceneLimits,  # noqa: F401
                             SDFConfig)
from vri_tpu.usd import Stage, scenes  # noqa: F401
