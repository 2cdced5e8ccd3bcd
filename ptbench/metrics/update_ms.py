"""Device time of the program's per-frame pose, per output frame:
CUDA-event pairs around ``render.pipeline.pose_scene`` (the glTF's
channels evaluated, then the scene moved: on the two-level bake the
instance tables, the instance subtrees' boxes, the TLAS, the skip
records and the pair rows).  Absent where the program has no such
function or posed nothing."""

WRAP = ("vulkan_pathtracer_tpu_torch.render.pipeline", ("pose_scene",))


def read(ctx):
    ms = ctx.span_ms("update_ms")
    return None if ms is None else ms / ctx.span_units
