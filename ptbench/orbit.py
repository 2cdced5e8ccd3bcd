"""The benchmark's camera path and camera vectors, frozen copies.

``Orbit`` is the repository's ``orbit_path`` (the program's
``app/camera_path.py``): 17 keyframes on a circle around ``center``,
each looking at it from ``height`` above, sampled by linear
interpolation (yaw along the shortest arc).  The benchmark's atrium
orbit is the port's ``app/bench.scene_orbit``: radius 4.5, height 2.2,
duration 4.0, centre (0, 1.2, 0), inside the courtyard.

``camera_vectors`` is the reference renderer's pinhole camera
(``Camera.zig``): (position, horizontal, vertical, forward) as f32
arrays from a position, a yaw and a pitch in degrees.  The harness
hands the program the position, yaw and pitch; the reference works the
vectors out again here.
"""

from __future__ import annotations

import math

import numpy as np

FORWARD = np.array([0.0, 0.0, 1.0], dtype=np.float32)
LEFT = np.array([-1.0, 0.0, 0.0], dtype=np.float32)
RIGHT = np.array([1.0, 0.0, 0.0], dtype=np.float32)
UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)
FOV = math.pi / 4.0


class Orbit:
    """The camera orbit of ``orbit_path(radius, height, duration, steps,
    center)``; ``pose(t)`` is (position, yaw, pitch) at time ``t``."""

    def __init__(self, radius: float, height: float, duration: float,
                 center, steps: int = 16):
        self.duration = duration
        self.keys = []
        for i in range(steps + 1):
            ang = 2.0 * math.pi * i / steps
            x = center[0] + radius * math.sin(ang)
            z = center[2] + radius * math.cos(ang)
            yaw = math.degrees(math.atan2(center[0] - x, center[2] - z)) % 360.0
            pitch = math.degrees(math.atan2(height, radius))
            self.keys.append((duration * i / steps,
                              [x, center[1] + height, z], yaw, pitch))

    def pose(self, t: float):
        keys = self.keys
        if t <= keys[0][0]:
            k = keys[0]
            return k[1], k[2], k[3]
        for a, b in zip(keys, keys[1:]):
            if a[0] <= t <= b[0]:
                f = (t - a[0]) / max(b[0] - a[0], 1e-9)
                dyaw = ((b[2] - a[2] + 180.0) % 360.0) - 180.0
                return ([a[1][i] * (1 - f) + b[1][i] * f for i in range(3)],
                        (a[2] + dyaw * f) % 360.0,
                        a[3] * (1 - f) + b[3] * f)
        k = keys[-1]
        return k[1], k[2], k[3]


def _quat(angle_deg: float, axis) -> np.ndarray:
    half = math.radians(angle_deg) * 0.5
    s = math.sin(half)
    return np.array([math.cos(half), axis[0] * s, axis[1] * s, axis[2] * s],
                    dtype=np.float64)


def _quat_mul(a, b) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _rotate(q, v) -> np.ndarray:
    w, x, y, z = q
    u = np.array([x, y, z])
    return (2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v))


def camera_vectors(position, yaw: float, pitch: float,
                   aspect: float = 16.0 / 9.0, fov: float = FOV):
    """(position, horizontal, vertical, forward), f32 (3,) arrays."""
    yaw = yaw % 360.0
    pitch = min(max(pitch, -90.0), 90.0)
    rotation = _quat_mul(_quat(yaw, UP), _quat(pitch, RIGHT))
    forward = _rotate(rotation, FORWARD).astype(np.float32)
    left = _rotate(rotation, LEFT).astype(np.float32)
    up = np.cross(left, forward).astype(np.float32)
    viewport_height = 2.0 * math.tan(fov * 0.5)
    viewport_width = viewport_height * aspect
    return (np.asarray(position, dtype=np.float32),
            (left * viewport_width).astype(np.float32),
            (up * viewport_height).astype(np.float32), forward)
