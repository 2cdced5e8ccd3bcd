"""Host utilities the port shares with the JAX package.

These modules of ``vulkan_pathtracer_tpu`` are NumPy/stdlib only (no
JAX), so the port imports them instead of copying them: the render
configuration and leaf-size policy, the CLI parser, PNG output and
the divider blit.
"""

from vulkan_pathtracer_tpu.render.output import upsample_nearest
from vulkan_pathtracer_tpu.utils.cli import build_parser
from vulkan_pathtracer_tpu.utils.config import RenderConfig, default_max_leaf
from vulkan_pathtracer_tpu.utils.png import read_png, write_png

__all__ = ["RenderConfig", "build_parser", "default_max_leaf", "read_png",
           "upsample_nearest", "write_png"]
