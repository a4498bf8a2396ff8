# Copy of vri_tpu/utils/image.py for the port; only the imports differ.
"""Image output helpers (headless framebuffer — the reference presents to a
GLFW swapchain, RenderContext.cpp:273-377; we write PNGs / arrays)."""

from __future__ import annotations

import numpy as np


def tonemap(color: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """Simple Reinhard + gamma for display."""
    c = np.maximum(np.asarray(color, np.float32) * exposure, 0.0)
    c = c / (1.0 + c)
    return np.clip(c ** (1.0 / 2.2), 0.0, 1.0)


def to_u8(img01: np.ndarray) -> np.ndarray:
    return (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray, tonemapped: bool = False) -> None:
    """Write (H, W, 3) float [0,1] or uint8 image to PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        if not tonemapped:
            arr = tonemap(arr)
        arr = to_u8(arr)
    from PIL import Image

    Image.fromarray(arr).save(path)
