"""Device time of the traversal kernels, per output frame or per
1080p sample per pixel: the profiler's kernels whose names are those of
the program's walks (``csrc/*.cu``).  Absent where none ran."""

KERNELS = ("stack_kernel", "stack_chan_kernel", "skip_closest_hit_kernel",
           "skip_chan_kernel", "wide_closest_hit_kernel", "wide_chan_kernel")


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    return None if seconds is None else 1e3 * seconds / ctx.trace_units
