"""The scene update's share of its roofline, in percent: the least time
of the updates in the spans' window (``ptbench/update_work.py``: the
least bytes of one update, whatever the layout, over the card's
bandwidth, times the updates timed) over their device time (CUDA-event
pairs around ``render.pipeline.pose_scene``, as ``update_ms``).  Absent
where the function, the scene's animation or the card's peaks are
missing."""

from ptbench import update_work
from ptbench.metrics.update_ms import WRAP  # noqa: F401  (the spans read)


def read(ctx):
    ms = ctx.span_ms("update_roofline")
    path = getattr(ctx, "_scene_path", None)
    if ms is None or path is None:
        return None
    least = update_work.least_seconds(path, ctx.card)
    if least is None or ms <= 0:
        return None
    updates = len(ctx.recorder.spans["update_roofline"])
    return 100.0 * least * updates / (ms / 1e3)
