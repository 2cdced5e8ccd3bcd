"""Seconds from the process's start to the first timed unit: imports,
the card's start, the scene's generation (first run only), load and
bake, the kernels' build or load, and the warm-up."""


def read(window, setup_s):
    return setup_s
