"""Device time of the wavefront's shading steps, per output frame or
per 1080p sample per pixel: CUDA-event pairs around the shading
functions (the outermost call only), as ``app/profile_frame.py`` wraps
them: the per-lane shading and its fetches, and the joint batch's copy
of the per-pixel shading to each frame's lanes and its draws."""

WRAP = ("vulkan_pathtracer_tpu_torch.render.wavefront",
        ("_shade_and_extend", "extend_paths", "get_material_data",
         "get_triangle_data", "_frame_lanes", "_next_segment"))


def read(ctx):
    ms = ctx.span_ms("shade_ms")
    return None if ms is None else ms / ctx.span_units
