"""The traversal kernels' share of their roofline, in percent: the
least time of the work their calls were given (``ptbench/work.py``:
the reference walk's tests on a seeded sample of each call's rays,
scaled to its live rays) over the device time of the traversal kernels
(``traverse_ms.KERNELS``).  Absent where the kernels, the calls or the
card's peaks are missing."""

from ptbench.metrics.traverse_ms import KERNELS

SAMPLE = ("vulkan_pathtracer_tpu_torch.render.wavefront",
          {"_closest_hit": "closest", "_any_hit": "any"})


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    least = ctx.least_traversal_seconds()
    if seconds is None or least is None:
        return None
    return 100.0 * least / seconds
