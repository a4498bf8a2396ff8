"""The yardstick of the kernels' roofline shares: the published peaks of
one NVIDIA H100 SXM (FP32 outside the tensor cores, HBM3 bandwidth) and
the least work each kernel must do in one frame, counted from the frame's
own inputs and shapes, never from the program's intermediate lists.

* ``raster_tiles`` (visibility): every fragment, a (pixel, triangle) pair
  whose front-facing triangle covers the pixel center between the near
  and far planes, costs ``RASTER_FLOP_PER_FRAGMENT`` operations (three
  edge functions, the interpolated depth and the depth test); every
  pixel writes its triangle, depth and two barycentrics (16 bytes).  The
  fragments are counted by the reference's ray casting of the frame.
  Triangle reads are left out: with LOD the triangles a frame needs are
  fewer than the stage's, so counting the stage's would overstate the
  least time.
* ``march_rays`` (lightloop): no defensible operation count exists (the
  steps a ray takes depend on the field), so bytes alone: each ray reads
  its 10-float record and writes t, the hit voxel, its step count and
  its activity (56 bytes); the rays of a frame are the shadow rays (one
  a light at every ``shadow_scale``-th pixel and row) and the GI rays
  (``samples`` at every ``gi_scale``-th pixel and row).
"""

from __future__ import annotations

PEAK_FLOPS = 67e12          # FP32, H100 SXM data sheet
PEAK_BYTES_S = 3.35e12      # HBM3, H100 SXM data sheet

RASTER_FLOP_PER_FRAGMENT = 20
RASTER_BYTES_PER_PIXEL = 16
MARCH_BYTES_PER_RAY = 56


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def raster_least_s(fragments: int, pixels: int) -> float:
    return least_s(RASTER_FLOP_PER_FRAGMENT * fragments,
                   RASTER_BYTES_PER_PIXEL * pixels)


def march_rays_per_frame(width: int, height: int, lights: int,
                         shadow_scale: int, gi_scale: int,
                         samples: int) -> int:
    shadow = (height // shadow_scale) * (width // shadow_scale) * lights
    gi = (height // gi_scale) * (width // gi_scale) * samples
    return shadow + gi


def march_least_s(rays: int) -> float:
    return least_s(0.0, MARCH_BYTES_PER_RAY * rays)
