"""Device time of the wavefront's bounce sort, per output frame or per
1080p sample per pixel: CUDA-event pairs around the sort (the outermost
call only): the 6d key, the argsort, the inverse and, in the joint and
pooled wavefronts, the state's gathers."""

WRAP = ("vulkan_pathtracer_tpu_torch.render.wavefront",
        ("_sorted_order", "_bounce_sort_key", "state_sort_order",
         "_permute_prefix"))


def read(ctx):
    ms = ctx.span_ms("sort_ms")
    return None if ms is None else ms / ctx.span_units
