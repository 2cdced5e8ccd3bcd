"""Metrics — the ``Stats.zig`` equivalent, headless (a copy of
``vulkan_pathtracer_tpu/utils/stats.py`` with the device memory read
from PyTorch's CUDA allocator).

The reference shows FPS + mean frame time per 1-second window, a
100-sample frame-time history, and per-heap VRAM usage/budget in a
Nuklear window (Stats.zig:68-176).  Here the same data goes to
``STATS {json}`` log lines instead of a UI.  Additional path-tracer
metrics: Mrays/s and spp/s, derived from the ray counts the render
pipeline reports.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from typing import Optional

import torch

FRAME_HISTORY = 100  # Stats.zig:14 — 100-entry ring buffer


def device_memory_stats(device=None) -> dict:
    """Device memory in use, its peak and the card's budget in MiB,
    mirroring the VK_EXT_memory_budget query (Stats.zig:27-58), from
    PyTorch's CUDA allocator; {} when the device is not CUDA.  A rank of
    ``--devices N`` passes its own card (parallel/mesh.RenderGroup's
    device)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"usage_mb": stats.get("allocated_bytes.all.current", 0) / 2**20,
            "peak_mb": stats.get("allocated_bytes.all.peak", 0) / 2**20,
            "budget_mb": total / 2**20}


class Stats:
    """Per-second FPS / frame-time aggregation (Stats.zig:68-87) plus
    rays/samples throughput."""

    def __init__(self, rays_per_frame: int = 0, spp_per_frame: int = 0,
                 stream=None, device=None) -> None:
        self.rays_per_frame = rays_per_frame
        self.spp_per_frame = spp_per_frame
        self.frame_times = collections.deque(maxlen=FRAME_HISTORY)
        self._window_frames = 0
        self._window_time = 0.0
        self._window_rays = 0
        self.fps = 0.0
        self.avg_frame_time_ms = 0.0
        self.mrays_per_sec = 0.0
        self.spp_per_sec = 0.0
        self.total_frames = 0
        self._stream = stream if stream is not None else sys.stderr
        self._device = device
        self._t0 = time.perf_counter()

    def lap(self, delta_time: float, one_second_elapsed: bool,
            rays_this_frame: Optional[int] = None) -> None:
        rays = self.rays_per_frame if rays_this_frame is None else rays_this_frame
        self.frame_times.append(delta_time)
        self._window_frames += 1
        self._window_time += delta_time
        self._window_rays += rays
        self.total_frames += 1
        if one_second_elapsed and self._window_frames > 0:
            self.fps = self._window_frames / max(self._window_time, 1e-9)
            self.avg_frame_time_ms = (
                self._window_time / self._window_frames * 1000.0
            )
            self.mrays_per_sec = (
                self._window_rays / max(self._window_time, 1e-9) / 1e6
            )
            self.spp_per_sec = self.fps * self.spp_per_frame
            self._window_frames = 0
            self._window_time = 0.0
            self._window_rays = 0

    def snapshot(self) -> dict:
        snap = {
            "elapsed_s": time.perf_counter() - self._t0,
            "frames": self.total_frames,
            "fps": round(self.fps, 2),
            "frame_time_ms": round(self.avg_frame_time_ms, 3),
            "mrays_per_sec": round(self.mrays_per_sec, 2),
            "spp_per_sec": round(self.spp_per_sec, 2),
            "frame_time_history_ms": [
                round(t * 1000.0, 3) for t in self.frame_times
            ],
        }
        snap.update(device_memory_stats(self._device))
        return snap

    def log(self) -> None:
        snap = self.snapshot()
        snap.pop("frame_time_history_ms", None)
        self._stream.write("STATS " + json.dumps(snap) + "\n")
        self._stream.flush()
