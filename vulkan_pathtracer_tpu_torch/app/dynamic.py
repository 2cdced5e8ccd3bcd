"""Dynamic-geometry frames: the motions and the per-step timing shared
by ``app/bench.py --mode animated``, ``app/profile_frame.py --animate``
and ``chip_smoke.py``.

- ``bob_transforms``: the motion of ``experiments/animated_bench.py``
  (:56-62): instance i moves up by 0.15 * ext * sin(2 t + 0.7 i), ext
  the root box's largest extent;
- ``twist``: the deformation of ``tests/test_device_build.py``
  (:166-176): every vertex turned about y by 0.3 * sin(phase) * y;
- ``StepTimer``: named steps between CUDA events, marked by
  AnimatedScene.with_transforms' ``on_step`` (``REFIT_STEPS``) and by
  ``rebuild_frame`` (twist, then device_rebuild_scene's steps).
"""

from __future__ import annotations

import math

import torch

from vulkan_pathtracer_tpu_torch.ops.device_build import device_rebuild_scene

REFIT_STEPS = ("rebake", "refit", "regenerate")


class StepTimer:
    """Named steps between CUDA events (no timing off CUDA): ``start()``,
    then ``mark(name)`` after each step; ``ms()`` waits for the device
    and returns {name: milliseconds}."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.events = []

    def _record(self, name):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((name, ev))

    def start(self) -> None:
        self.events = []
        self._record(None)

    def mark(self, name: str) -> None:
        self._record(name)

    def ms(self) -> dict:
        if not self.on:
            return {}
        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def bob_transforms(base: torch.Tensor, ext: float, t: float) -> torch.Tensor:
    """(I, 4, 4) transforms of ``base`` with instance i lifted by
    0.15 * ext * sin(2 t + 0.7 i) (f32, on base's device)."""
    phase = torch.arange(base.shape[0], dtype=torch.float32,
                         device=base.device) * 0.7
    tf = base.clone()
    tf[:, 1, 3] += 0.15 * ext * torch.sin(t * 2.0 + phase)
    return tf


def largest_extent(scene) -> float:
    """The scene's root box's largest extent."""
    return float((scene.root_hi - scene.root_lo).max())


def twist(tri_v0, tri_e1, tri_e2, phase: float):
    """(v0, e1, e2, gn) of triangles whose vertices are turned about y
    by 0.3 * sin(phase) * y; gn the unnormalized edge cross."""
    def warp(p):
        ang = 0.3 * math.sin(phase) * p[:, 1:2]
        ca, sa = torch.cos(ang), torch.sin(ang)
        x = ca[:, 0] * p[:, 0] - sa[:, 0] * p[:, 2]
        z = sa[:, 0] * p[:, 0] + ca[:, 0] * p[:, 2]
        return torch.stack([x, p[:, 1], z], dim=1)

    w0 = warp(tri_v0)
    w1 = warp(tri_v0 + tri_e1) - w0
    w2 = warp(tri_v0 + tri_e2) - w0
    return w0, w1, w2, torch.linalg.cross(w1, w2)


def rebuild_frame(template, phase: float, timer: StepTimer,
                  coefs: bool = None, mxu_precision: str = None):
    """The template's canonical triangles twisted at ``phase`` and
    rebuilt on the device (device_rebuild_scene, with its ``coefs`` and
    ``mxu_precision``), the twist and each build step marked on
    ``timer``."""
    timer.start()
    v0, e1, e2, gn = twist(template.tri_v0, template.tri_e1,
                           template.tri_e2, phase)
    timer.mark("twist")
    return device_rebuild_scene(template, v0, e1, e2, gn, template.tri_attr,
                                on_step=timer.mark, coefs=coefs,
                                mxu_precision=mxu_precision)
