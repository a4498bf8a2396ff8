"""vri_tpu_torch — the PyTorch / CUDA port of ``vri_tpu`` for one NVIDIA
H100.

It renders the static-stage frames of ``vri_tpu`` with torch tensors on
an explicit device: USD stage -> packed scene tensors (``registry``) ->
visibility through the raster tiers (CUDA kernels ``raster_tiles`` and
``raster_ranged``), the LBVH (CUDA kernel ``bvh_traverse``) or the
brute-force tracer -> G-buffer -> direct light, and for the GI frame
SDF cascades (cell-binned, or dense where the cell binning cannot hold
the configuration) with SDF-shadowed direct light and one GI bounce
marched through them (CUDA kernel ``march_rays``), on whole frames or on
bands of rows.  ``runtime`` holds the scene cache, scene validation and
the profiler.  The kernels live in
``csrc/`` and are built with ``nvcc`` at first use; on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

The package imports ``torch`` and never ``jax``, and nothing of
``vri_tpu``: the host modules it needs (``config``, ``usd``,
``hydra.{camera,material,meshutil}``, ``utils``, the native library's
bindings in ``_native``) are its own copies.  The configuration classes
and the procedural stages a caller needs are re-exported here::

    from vri_tpu_torch import RenderConfig, SDFConfig, scenes
    from vri_tpu_torch.renderer import Renderer
"""

__version__ = "0.1.0"

from vri_tpu_torch.config import (DebugMode, RenderConfig,  # noqa: F401
                                  SceneLimits, SDFConfig)
from vri_tpu_torch.usd import Stage, scenes  # noqa: F401
