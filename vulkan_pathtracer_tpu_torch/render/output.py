"""Present path: the divider upsample.

``upsample_nearest`` reproduces the reference's nearest-filter blit
from the divided-resolution storage image to the full-size swapchain
image (RaytracingPass.zig:591-667, used when
--render-resolution-divider > 1).  Copied from
``vulkan_pathtracer_tpu/render/output.py``; its ``Accumulator`` comes
with the convergence path.
"""

from __future__ import annotations

import numpy as np


def upsample_nearest(image: np.ndarray, out_width: int, out_height: int) -> np.ndarray:
    """Nearest-neighbor blit (H, W, C) -> (out_height, out_width, C)."""
    h, w = image.shape[:2]
    if (h, w) == (out_height, out_width):
        return image
    ys = (np.arange(out_height) * h) // out_height
    xs = (np.arange(out_width) * w) // out_width
    return image[ys][:, xs]
