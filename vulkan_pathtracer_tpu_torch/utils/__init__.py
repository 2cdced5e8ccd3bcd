"""Host utilities: the render configuration and leaf-size policy, the
CLI parser, PNG output and the divider blit.

The port's own copies of ``vulkan_pathtracer_tpu/utils/config.py``,
``utils/cli.py``, ``utils/png.py`` and ``render/output.
upsample_nearest`` (NumPy/stdlib only), so the port imports nothing of
the JAX package.
"""

from vulkan_pathtracer_tpu_torch.render.output import upsample_nearest
from vulkan_pathtracer_tpu_torch.utils.cli import build_parser
from vulkan_pathtracer_tpu_torch.utils.config import (
    RenderConfig,
    default_max_leaf,
)
from vulkan_pathtracer_tpu_torch.utils.png import read_png, write_png

__all__ = ["RenderConfig", "build_parser", "default_max_leaf", "read_png",
           "upsample_nearest", "write_png"]
