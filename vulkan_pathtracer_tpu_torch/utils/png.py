"""PNG IO + the reference's unorm8 present semantics.

The reference stores linear radiance straight into a
``b8g8r8a8_unorm`` storage image (RaytracingPass.zig:154-166, format
from Swapchain.zig:114-141) with **no tonemap**: values clamp at 1.0
and quantize to 8 bits with round-to-nearest-even (Vulkan unorm
conversion).  ``quantize_unorm8`` reproduces that so golden-image
comparisons see the same numbers the reference would present.
"""

from __future__ import annotations

import numpy as np


def quantize_unorm8(linear_rgb: np.ndarray) -> np.ndarray:
    """float linear [H,W,3] -> uint8 [H,W,3], Vulkan unorm semantics."""
    clamped = np.clip(np.asarray(linear_rgb, dtype=np.float32), 0.0, 1.0)
    # Vulkan spec: round(f * 255) to nearest even on ties.
    scaled = clamped * 255.0
    return np.rint(scaled).astype(np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """Write an image to PNG. Accepts float linear [H,W,3] (quantized
    per the present semantics) or uint8 arrays."""
    if image.dtype != np.uint8:
        image = quantize_unorm8(image)
    from PIL import Image

    Image.fromarray(image, mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
