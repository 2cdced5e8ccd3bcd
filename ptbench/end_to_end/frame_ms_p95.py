"""The 95th percentile of the window's frame times: each frame from its
dispatch to the completion of its last operation, one frame in flight,
read from a pair of CUDA events around it (the device's clock: a
frame of 18-50 ms is too short for the host's)."""

import statistics


def read(window, setup_s):
    if len(window.frame_ms) < 20:
        return None
    return statistics.quantiles(window.frame_ms, n=20,
                                method="inclusive")[-1]
