"""The imbalance of a split frame, per output frame: the slowest rank's
total of ``parallel.sharding.render_tile`` (its share of each frame,
before the exchange) less the ranks' mean, in ms of the device's clock.
Each rank times its calls by CUDA-event pairs in the spans' window; the
totals go to rank 0 after the window.  Absent on one rank, and where a
rank has no CUDA events (the CPU)."""

WRAP = ("vulkan_pathtracer_tpu_torch.parallel.sharding", ("render_tile",))


def read(ctx):
    totals = ctx.rank_span_ms("tile_wait_ms")
    if not totals or len(totals) < 2:
        return None
    return (max(totals) - sum(totals) / len(totals)) / ctx.span_units
