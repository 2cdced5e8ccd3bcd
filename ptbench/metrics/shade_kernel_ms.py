"""Device time of the shading kernels, per output frame: the profiler's
kernels whose names are those of the program's shading entry points
(``csrc/``: the per-lane shading and extension, the emissive-free last
bounce's any hit and sky, the joint batch's per-pixel shading and
draws), as ``traverse_ms`` reads the walks.  Unlike ``shade_ms`` it
needs no span around the shading functions, so it reads a frame that
replays a CUDA graph too.  Absent where none ran."""

KERNELS = ("shade_extend_kernel", "anyhit_sky_kernel", "pixel_shade_kernel",
           "joint_draw_kernel")


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    return None if seconds is None else 1e3 * seconds / ctx.trace_units
