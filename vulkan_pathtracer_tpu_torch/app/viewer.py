"""Interactive terminal viewer — the zig-window + Input.zig analog (the
port's copy of ``vulkan_pathtracer_tpu/app/viewer.py``; the frame is
fetched from the device with ``.cpu()``).

The reference is an interactive app: WASD + space/ctrl movement and
mouse-drag look over a live swapchain (main.zig:232-373, Input.zig,
Camera.zig:48-79).  This viewer renders frames and presents them as
24-bit-color ANSI half-blocks (one ``▀`` glyph = two vertically
stacked pixels), with keyboard input mapped onto the same
Camera.look/move semantics:

    w/a/s/d   move forward/left/back/right (Input WASD)
    space / c move up / down (space / ctrl in the reference)
    i/k j/l   look up/down, left/right (mouse-drag analog: each press
              = a 40 px drag at the reference's 0.25 deg/px)
    f         toggle fast movement (shift analog, 5 -> 10 u/s)
    q / Esc   quit

Input handling degrades gracefully without a TTY (piped/scripted
input reads characters from stdin until EOF), which is also how the
tests drive it.  Rendering per keyframe is synchronous: frame ->
present -> poll, like the reference's single-queue loop.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np


def _ansi_frame(img: np.ndarray) -> str:
    """(H, W, 3) linear radiance -> ANSI truecolor half-block text.

    Same present transform as the PNG path: clamp + unorm8 quantize
    (the b8g8r8a8_unorm storage-image semantics)."""
    q = np.clip(img, 0.0, 1.0)
    q = (q * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = q.shape
    if h % 2:
        q = np.concatenate([q, np.zeros((1, w, 3), np.uint8)])
        h += 1
    lines = []
    for y in range(0, h, 2):
        top = q[y]
        bot = q[y + 1]
        row = []
        for x in range(w):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg, bb = (int(v) for v in bot[x])
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


class _KeySource:
    """Raw-mode TTY keys when available, plain stdin bytes otherwise
    (scripted/piped input; EOF quits)."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stdin
        self._tty = False
        self._old = None
        try:
            self._fd = self.stream.fileno()
            self._tty = os.isatty(self._fd)
        except (OSError, ValueError):
            self._fd = None

    def __enter__(self):
        if self._tty:
            import termios
            import tty

            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._tty and self._old is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)

    def poll(self, timeout: float = 0.0):
        """Return one pending key (str) or None; '' means EOF/quit."""
        if self._fd is None:
            ch = self.stream.read(1)
            return ch if ch else ""
        r, _, _ = select.select([self.stream], [], [], timeout)
        if not r:
            return None
        ch = os.read(self._fd, 1).decode(errors="ignore") \
            if self._tty else self.stream.read(1)
        return ch if ch else ""


LOOK_STEP_PX = 40.0  # one keypress = a 40 px mouse drag (0.25 deg/px)


def run_viewer(pipeline, camera, *, out=None, keys=None,
               max_frames: int = 0) -> int:
    """Interactive loop: render -> ANSI present -> handle input.

    pipeline: RenderPipeline-compatible (render(camera, frame));
    out: text stream (default stdout); keys: input stream override;
    max_frames: stop after N frames (0 = until quit/EOF).
    Returns the number of frames presented.
    """
    out = out or sys.stdout
    frame = 0
    fast = False
    last = time.perf_counter()
    with _KeySource(keys) as ks:
        while True:
            image, _ = pipeline.render(camera, frame)
            img = image.cpu().numpy()
            out.write("\x1b[H\x1b[2J" if frame == 0 else "\x1b[H")
            out.write(_ansi_frame(img))
            out.write(
                f"\n\x1b[0mframe {frame}  pos "
                f"({camera.position[0]:.1f} {camera.position[1]:.1f} "
                f"{camera.position[2]:.1f})  yaw {camera.yaw:.0f} "
                f"pitch {camera.pitch:.0f}  [wasd/space/c move, "
                f"ijkl look, f fast, q quit]\n"
            )
            out.flush()
            frame += 1
            if max_frames and frame >= max_frames:
                return frame

            now = time.perf_counter()
            dt = max(now - last, 1e-3)
            last = now

            key = ks.poll(timeout=0.0)
            if key is None:
                key = ks.poll(timeout=10.0)
            if key is None:
                continue
            if key in ("", "q", "\x1b"):
                return frame
            if key == "w":
                camera.move(camera.forward, dt, fast=fast)
            elif key == "s":
                camera.move(-camera.forward, dt, fast=fast)
            elif key == "a":
                camera.move(camera.left, dt, fast=fast)
            elif key == "d":
                camera.move(-camera.left, dt, fast=fast)
            elif key == " ":
                camera.move_vertical(dt, fast=fast)
            elif key == "c":
                camera.move_vertical(dt, down=True, fast=fast)
            elif key == "j":
                camera.look(-LOOK_STEP_PX, 0.0)
            elif key == "l":
                camera.look(LOOK_STEP_PX, 0.0)
            elif key == "i":
                camera.look(0.0, -LOOK_STEP_PX)
            elif key == "k":
                camera.look(0.0, LOOK_STEP_PX)
            elif key == "f":
                fast = not fast
