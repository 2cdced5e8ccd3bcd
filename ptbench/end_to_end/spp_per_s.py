"""1080p samples per pixel completed in the window (whole joint batches
added to the host accumulator) over the window's seconds."""


def read(window, setup_s):
    return window.spp / window.seconds if window.spp else None
