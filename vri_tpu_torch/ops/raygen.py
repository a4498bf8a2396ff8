"""Primary ray generation from the camera matrices (counterpart of
``vri_tpu/ops/raygen.py``): unproject each pixel center through
``inv(view_proj)``.  Pixel (0,0) is top-left; NDC y points up."""

from __future__ import annotations

import torch


def pixel_ndc(height: int, width: int, y0: int = 0,
              proj_height: int | None = None, *, device) -> torch.Tensor:
    """NDC xy coordinates of pixel centers, shape (H, W, 2).  ``y0`` /
    ``proj_height`` select a row band of a taller framebuffer."""
    ph = proj_height or height
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    y = 1.0 - (y0 + torch.arange(height, dtype=torch.float32, device=device)
               + 0.5) / ph * 2.0
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def camera_rays(inv_view_proj: torch.Tensor, eye: torch.Tensor,
                height: int, width: int, y0: int = 0,
                proj_height: int | None = None):
    """Per-pixel world-space rays: (origins (H,W,3), unit directions
    (H,W,3)).  Unprojects NDC depths 0.02 and 0.98 and takes the
    difference, so it is exact for any projection matrix."""
    ndc = pixel_ndc(height, width, y0, proj_height,
                    device=inv_view_proj.device)
    m = inv_view_proj

    def unproject(z):
        # explicit products in the order of the (H,W,4) x (4,4) contraction
        q = (ndc[..., 0:1] * m[:, 0] + ndc[..., 1:2] * m[:, 1]
             + z * m[:, 2] + m[:, 3])
        return q[..., :3] / q[..., 3:4]

    p_near = unproject(0.02)
    p_far = unproject(0.98)
    d = p_far - p_near
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    # perspective rays share the eye; orthographic rays start on the near
    # plane (rays parallel <=> unprojected directions identical everywhere)
    dd = d[0, 0] - d[-1, -1]
    is_persp = torch.sqrt((dd * dd).sum()) > 1e-6
    origins = torch.where(is_persp, eye.expand(d.shape), p_near)
    return origins, d
