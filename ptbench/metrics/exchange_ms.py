"""Device time of rank 0's NCCL kernels, per output frame: the
profiler's kernels whose names hold ``nccl`` (the tiles' all-gather and
the rays' all-reduce of ``parallel.mesh.RenderGroup``).  A collective's
kernel runs from when it is launched on this card until every rank has
sent its part, so this counts the wait on the slowest rank with the
exchange itself.  Absent where none ran (one card, or gloo on the CPU)."""

KERNELS = ("nccl",)


def read(ctx):
    seconds = ctx.kernel_seconds(KERNELS)
    return None if seconds is None else 1e3 * seconds / ctx.trace_units
