"""Pinhole camera with the reference's exact conventions.

Mirrors ``src/Camera.zig`` (zalgebra conventions: forward = (0,0,1),
left = (-1,0,0), up = left x forward; Quat.fromAxis takes degrees):

- orientation = Quat(yaw about +Y) * Quat(pitch about +X)  (Camera.zig:86-94)
- viewport_height = 2*tan(fov/2); viewport_width = vh * aspect
- horizontal = left * viewport_width; vertical = up * viewport_height
  (Camera.zig:96-102)
- per-pixel ray dir = normalize(forward + horizontal*d.x - vertical*d.y)
  with d = (pixel+0.5)/size*2-1  (ray_gen.rgen:34-48)
- movement speed 5 (10 with shift), look speed 0.25 deg/px, pitch
  clamped to [-90, 90], yaw wrapped to [0, 360) (Camera.zig:48-79)

The camera is a host-side object; ``push_constants()`` yields the four
f32 vec3s the compiled render function takes as traced arguments — the
analog of the reference's push-constant block
(ray_gen.rgen:23-29 / RayTracingPipeline.zig:15-22).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

FORWARD = np.array([0.0, 0.0, 1.0], dtype=np.float32)
LEFT = np.array([-1.0, 0.0, 0.0], dtype=np.float32)
RIGHT = np.array([1.0, 0.0, 0.0], dtype=np.float32)
UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)

MOVE_SPEED = 5.0
MOVE_SPEED_FAST = 10.0
ROTATE_SPEED_DEG_PER_PX = 0.25


def quat_from_axis(angle_deg: float, axis: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) from axis + angle in degrees."""
    half = math.radians(angle_deg) * 0.5
    s = math.sin(half)
    return np.array(
        [math.cos(half), axis[0] * s, axis[1] * s, axis[2] * s],
        dtype=np.float64,
    )


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    u = np.array([x, y, z])
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    )


@dataclass
class Camera:
    """State + derived basis vectors, all float32 on the host."""

    fov: float = math.pi / 4.0  # main.zig:221 — pi/4 radians
    aspect_ratio: float = 16.0 / 9.0
    position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    pitch: float = 0.0  # degrees
    yaw: float = 0.0    # degrees

    forward: np.ndarray = field(init=False)
    left: np.ndarray = field(init=False)
    up: np.ndarray = field(init=False)
    horizontal: np.ndarray = field(init=False)
    vertical: np.ndarray = field(init=False)

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float32)
        self._update_orientation()
        self._update_vectors()

    # -- Camera.zig:86-94 ---------------------------------------------------
    def _update_orientation(self) -> None:
        rotation = quat_mul(
            quat_from_axis(self.yaw, UP), quat_from_axis(self.pitch, RIGHT)
        )
        self.forward = quat_rotate(rotation, FORWARD).astype(np.float32)
        self.left = quat_rotate(rotation, LEFT).astype(np.float32)
        self.up = np.cross(self.left, self.forward).astype(np.float32)

    # -- Camera.zig:96-102 --------------------------------------------------
    def _update_vectors(self) -> None:
        viewport_height = 2.0 * math.tan(self.fov * 0.5)
        viewport_width = viewport_height * self.aspect_ratio
        self.horizontal = (self.left * viewport_width).astype(np.float32)
        self.vertical = (self.up * viewport_height).astype(np.float32)

    # -- public API ----------------------------------------------------------
    def update_aspect_ratio(self, aspect_ratio: float) -> None:
        self.aspect_ratio = aspect_ratio
        self._update_vectors()

    def look(self, cursor_delta_x: float, cursor_delta_y: float) -> None:
        """Mouse-drag look — Camera.zig:49-65 (0.25 deg per pixel)."""
        self.yaw -= cursor_delta_x * ROTATE_SPEED_DEG_PER_PX
        self.pitch += cursor_delta_y * ROTATE_SPEED_DEG_PER_PX
        if self.yaw < 0.0:
            self.yaw += 360.0
        if self.yaw >= 360.0:
            self.yaw -= 360.0
        self.pitch = min(max(self.pitch, -90.0), 90.0)
        self._update_orientation()
        self._update_vectors()

    def set_orientation(self, yaw: float, pitch: float) -> None:
        self.yaw = yaw % 360.0
        self.pitch = min(max(pitch, -90.0), 90.0)
        self._update_orientation()
        self._update_vectors()

    def move(self, direction: np.ndarray, dt: float, fast: bool = False) -> None:
        """Normalized-direction move — Camera.zig:67-76."""
        speed = MOVE_SPEED_FAST if fast else MOVE_SPEED
        norm = float(np.linalg.norm(direction))
        if norm > 0.0:
            self.position = (
                self.position + np.asarray(direction) / norm * (speed * dt)
            ).astype(np.float32)

    def move_vertical(self, dt: float, down: bool = False, fast: bool = False) -> None:
        """Space / left-ctrl vertical move — Camera.zig:78-79."""
        speed = MOVE_SPEED_FAST if fast else MOVE_SPEED
        self.position = self.position.copy()
        self.position[1] += (-speed if down else speed) * dt

    def push_constants(self):
        """(position, horizontal, vertical, forward) f32 arrays — the
        traced camera arguments of the render step."""
        return (
            self.position.astype(np.float32),
            self.horizontal.astype(np.float32),
            self.vertical.astype(np.float32),
            self.forward.astype(np.float32),
        )
