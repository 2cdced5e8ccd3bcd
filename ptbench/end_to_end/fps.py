"""Frames delivered in the window over the window's seconds (host
clock, from the first dispatch to the last frame's completion)."""


def read(window, setup_s):
    return window.frames / window.seconds if window.frames else None
