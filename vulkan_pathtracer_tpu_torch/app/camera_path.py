"""Scripted camera paths — the headless replacement for WASD/mouse.

The reference's interactivity (Input.zig + Camera.update) has no TPU
analog; instead a JSON camera path drives the animated fly-through
(BASELINE config[4]).  Path format: a list of keyframes

    [{"time": 0.0, "position": [x,y,z], "yaw": deg, "pitch": deg}, ...]

sampled with linear interpolation (yaw interpolated along the shortest
arc).  ``orbit_path`` generates a default orbit for benchmarks.
"""

from __future__ import annotations

import json
import math
from typing import List

import numpy as np

from vulkan_pathtracer_tpu_torch.models.camera import Camera


class CameraPath:
    def __init__(self, keyframes: List[dict]):
        if not keyframes:
            raise ValueError("empty camera path")
        self.keyframes = sorted(keyframes, key=lambda k: k["time"])

    @classmethod
    def load(cls, path: str) -> "CameraPath":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def duration(self) -> float:
        return self.keyframes[-1]["time"]

    def sample(self, t: float) -> dict:
        ks = self.keyframes
        if t <= ks[0]["time"]:
            return ks[0]
        if t >= ks[-1]["time"]:
            return ks[-1]
        for a, b in zip(ks, ks[1:]):
            if a["time"] <= t <= b["time"]:
                span = max(b["time"] - a["time"], 1e-9)
                f = (t - a["time"]) / span
                yaw_a, yaw_b = a["yaw"], b["yaw"]
                dyaw = ((yaw_b - yaw_a + 180.0) % 360.0) - 180.0
                return {
                    "time": t,
                    "position": [
                        a["position"][i] * (1 - f) + b["position"][i] * f
                        for i in range(3)
                    ],
                    "yaw": (yaw_a + dyaw * f) % 360.0,
                    "pitch": a["pitch"] * (1 - f) + b["pitch"] * f,
                }
        return ks[-1]

    def apply(self, camera: Camera, t: float) -> Camera:
        k = self.sample(t)
        camera.position = np.asarray(k["position"], dtype=np.float32)
        camera.set_orientation(yaw=k["yaw"], pitch=k["pitch"])
        return camera


def orbit_path(radius: float = 3.0, height: float = 1.0,
               duration: float = 4.0, steps: int = 16,
               center=(0.0, 0.0, 0.0)) -> CameraPath:
    """Camera orbits the center, always looking inward."""
    keys = []
    for i in range(steps + 1):
        t = duration * i / steps
        ang = 2.0 * math.pi * i / steps
        x = center[0] + radius * math.sin(ang)
        z = center[2] + radius * math.cos(ang)
        # camera at angle ang looks toward the center: forward is
        # (center - pos); with forward=(0,0,1) at yaw 0, yaw rotates
        # about +Y: forward = (sin(yaw), 0, cos(yaw)).
        yaw = math.degrees(math.atan2(center[0] - x, center[2] - z)) % 360.0
        # pitch p: forward = (0, -sin p, cos p) at yaw 0, so looking
        # *down* from above needs positive pitch.
        pitch = math.degrees(math.atan2(height, radius))
        keys.append({
            "time": t,
            "position": [x, center[1] + height, z],
            "yaw": yaw,
            "pitch": pitch,
        })
    return CameraPath(keys)
