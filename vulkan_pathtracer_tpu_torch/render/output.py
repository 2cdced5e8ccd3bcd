"""Present path: divider upsample + accumulation + checkpoint/resume.

Copied from ``vulkan_pathtracer_tpu/render/output.py`` (NumPy only):

- ``upsample_nearest`` reproduces the reference's nearest-filter blit
  from the divided-resolution storage image to the full-size swapchain
  image (RaytracingPass.zig:591-667, used when
  --render-resolution-divider > 1).
- ``Accumulator`` is the progressive-rendering extension: a float64
  host sum of per-frame radiance.  ``save``/``load`` snapshot the sum
  and the spp count as an ``.npz`` (``sum`` plus a JSON ``meta``) in
  the JAX package's layout, so a preempted progressive render resumes
  exactly, and either package reads the other's checkpoint.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vulkan_pathtracer_tpu_torch.utils.profiling import span


def upsample_nearest(image: np.ndarray, out_width: int, out_height: int) -> np.ndarray:
    """Nearest-neighbor blit (H, W, C) -> (out_height, out_width, C)."""
    h, w = image.shape[:2]
    if (h, w) == (out_height, out_width):
        return image
    ys = (np.arange(out_height) * h) // out_height
    xs = (np.arange(out_width) * w) // out_width
    return image[ys][:, xs]


class Accumulator:
    """Running mean of per-frame radiance (equal-weight over spp)."""

    def __init__(self, width: int, height: int, spp_per_frame: int):
        self.width = width
        self.height = height
        self.spp_per_frame = spp_per_frame
        self.sum = np.zeros((height, width, 3), dtype=np.float64)
        self.spp = 0
        self.frame = 0

    def add_frame(self, image: np.ndarray) -> None:
        """Add one frame: ``image`` is its mean over spp_per_frame.
        Traced as the root span ``accumulate``."""
        with span("accumulate"):
            self.sum += (np.asarray(image, dtype=np.float64)
                         * self.spp_per_frame)
        self.spp += self.spp_per_frame
        self.frame += 1

    def add_frames_sum(self, sum_image: np.ndarray, n_frames: int) -> None:
        """Add a device-side batch: the SUM of n_frames per-frame means
        (``RenderPipeline.render_batch_sum``).  Traced as the root span
        ``accumulate``."""
        with span("accumulate"):
            self.sum += (np.asarray(sum_image, dtype=np.float64)
                         * self.spp_per_frame)
        self.spp += self.spp_per_frame * n_frames
        self.frame += n_frames

    @property
    def mean(self) -> np.ndarray:
        if self.spp == 0:
            return self.sum.astype(np.float32)
        return (self.sum / self.spp).astype(np.float32)

    # -- checkpoint / resume --------------------------------------------------
    def save(self, path: str) -> None:
        """Write the checkpoint through a temporary file, then move it
        into place."""
        tmp = path + ".tmp"
        src = tmp if tmp.endswith(".npz") else tmp + ".npz"
        np.savez_compressed(
            src, sum=self.sum,
            meta=json.dumps({"width": self.width, "height": self.height,
                             "spp_per_frame": self.spp_per_frame,
                             "spp": self.spp, "frame": self.frame}))
        os.replace(src, path)

    @classmethod
    def load(cls, path: str) -> "Accumulator":
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        acc = cls(meta["width"], meta["height"], meta["spp_per_frame"])
        acc.sum = data["sum"]
        acc.spp = meta["spp"]
        acc.frame = meta["frame"]
        return acc
