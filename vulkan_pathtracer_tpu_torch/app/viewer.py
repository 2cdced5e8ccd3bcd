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

On several ranks (``--devices N``, a ``ShardedRenderPipeline``) every
rank runs ``run_viewer`` and renders every frame collectively: rank 0
reads the keys (its own stdin) and presents, and before each frame
broadcasts the camera's exact state (position, yaw, pitch) with a
go/stop flag (``CameraSync``); the other ranks follow, set their camera
to it and write nothing.  A movement key depends on rank 0's clock, so
only rank 0 applies keys.  Quit, EOF and ``max_frames`` stop every rank
after the same frame count.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np
import torch


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


class CameraSync:
    """Rank 0's camera, broadcast to the ranks of ``group`` (a
    mesh.RenderGroup) before each frame: float64 [go, x, y, z, yaw,
    pitch], exact for the f32 position and the float angles, so every
    rank derives the same push constants."""

    def __init__(self, group):
        self.group = group

    def _broadcast(self, state) -> torch.Tensor:
        return self.group.broadcast(torch.tensor(
            state, dtype=torch.float64, device=self.group.device)).cpu()

    def send(self, camera, go: bool) -> None:
        """Rank 0: the next frame's camera, or (``go`` False) stop."""
        self._broadcast([float(go), *(float(x) for x in camera.position),
                         camera.yaw, camera.pitch])

    def receive(self, camera) -> bool:
        """Another rank: set ``camera`` to rank 0's; False on stop."""
        state = self._broadcast([0.0] * 6).tolist()
        if state[0] == 0.0:
            return False
        camera.position = np.asarray(state[1:4], dtype=np.float32)
        camera.set_orientation(state[4], state[5])
        return True


def follow_viewer(pipeline, camera, group) -> int:
    """A rank other than 0 of a multi-rank viewer: render every frame of
    rank 0's with its camera, present nothing.  Returns the number of
    frames rendered."""
    sync = CameraSync(group)
    frame = 0
    while sync.receive(camera):
        pipeline.render(camera, frame)
        frame += 1
    return frame


def run_viewer(pipeline, camera, *, out=None, keys=None,
               max_frames: int = 0, group=None) -> int:
    """Interactive loop: render -> ANSI present -> handle input.

    pipeline: RenderPipeline-compatible (render(camera, frame));
    out: text stream (default stdout); keys: input stream override;
    max_frames: stop after N frames (0 = until quit/EOF); group: the
    mesh.RenderGroup of a multi-rank pipeline (every rank calls this;
    rank 0 leads, the others run ``follow_viewer``).
    Returns the number of frames presented (rendered, on a follower).
    """
    if group is not None and group.world > 1 and not group.primary:
        return follow_viewer(pipeline, camera, group)
    sync = CameraSync(group) if group is not None and group.world > 1 \
        else None
    try:
        return _lead_viewer(pipeline, camera, out or sys.stdout, keys,
                            max_frames, sync)
    finally:
        if sync is not None:
            sync.send(camera, go=False)


def _lead_viewer(pipeline, camera, out, keys, max_frames: int, sync) -> int:
    """run_viewer's loop on the presenting rank; ``sync`` (a CameraSync
    or None) broadcasts each frame's camera before it is rendered."""
    frame = 0
    fast = False
    last = time.perf_counter()
    with _KeySource(keys) as ks:
        while True:
            if sync is not None:
                sync.send(camera, go=True)
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
