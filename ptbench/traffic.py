"""The one general traffic generator: it reads a traffic mix's data file
(``ptbench/traffic/<mix>.json``) and drives the program with it.

A mix is a closed loop of one client, of one of three kinds:

- ``frames``: one frame in flight.  Frame ``i`` is
  ``RenderPipeline.render(camera, base + i)`` with the camera on the
  orbit at ``t0 + i * time_step``, dispatched, then synchronised; its
  latency is read from a pair of CUDA events around it.
- ``joint``: a converging still.  The camera stands at an orbit point;
  each batch is ``render_batch_sum(camera, frame, batch)`` (the joint
  wavefront of ``batch`` frames at 1 spp) added to the program's host
  accumulator (``render.output.Accumulator.add_frames_sum``) as the
  CLI's frame loop adds it; after ``target_spp`` the still restarts at
  the next orbit point with a new accumulator.  The check takes the
  longest still of the window.
- ``pooled``: a camera path exported to video.  Groups of ``group``
  consecutive cameras on the orbit, ``time_step`` apart, run as one
  pooled wavefront (``render_pooled``), each group synchronised.

The seed picks the orbit phase ``t0``, the frame counters' base (which
seeds the program's RNG), the pixels that the check compares and which
outputs it keeps; every seed sends the same amount of work of the same
shapes.  A run warms up with the mix's own shapes, then measures until
``seconds`` have passed and the unit in flight has finished.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ptbench.orbit import Orbit
from ptbench.spans import HostSteps

KINDS = ("frames", "joint", "pooled")




@dataclass
class Window:
    """What a measured window did."""

    seconds: float = 0.0     # host clock, first dispatch to last completion
    frames: int = 0          # 1080p frames delivered
    spp: int = 0             # samples per pixel of the still(s) delivered
    units: int = 0           # frames, batches or groups dispatched
    frame_ms: list = field(default_factory=list)   # per frame, device clock
    kept: list = field(default_factory=list)       # outputs for the check


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` where there is no card (the
    CPU tests): the host clock at ``record``."""

    def __init__(self):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class Traffic:
    """One mix's parameters and the seed's choices."""

    def __init__(self, mix: dict, seed: int, width: int, height: int,
                 device):
        if mix["kind"] not in KINDS:
            raise ValueError(f"traffic kind {mix['kind']!r}: {KINDS}")
        self.mix = mix
        self.kind = mix["kind"]
        self.device = device
        self.width, self.height = width, height
        self.orbit = Orbit(**mix["orbit"])
        rng = np.random.default_rng(seed)
        self.t0 = float(rng.uniform(0.0, self.orbit.duration))
        self.base = int(rng.integers(0, 1 << 30))
        check = mix["check"]
        pixels = min(int(check["pixels"]), width * height)
        pix = np.sort(rng.choice(width * height, size=pixels, replace=False))
        self.px = torch.as_tensor(pix % width, device=device)
        self.py = torch.as_tensor(pix // width, device=device)
        self.pix = torch.as_tensor(pix, device=device)
        self.keep = int(check.get("outputs", 1))
        self.pick = np.random.default_rng(rng.integers(0, 1 << 62))
        self.step = float(mix.get("time_step", 0.0))

    def pose(self, index: int):
        """(position, yaw, pitch) of orbit point ``index``."""
        t = (self.t0 + index * self.step) % self.orbit.duration
        return self.orbit.pose(t)

    def camera(self, index: int, cam_type, aspect: float):
        position, yaw, pitch = self.pose(index)
        cam = cam_type(aspect_ratio=aspect)
        cam.position = np.asarray(position, dtype=np.float32)
        cam.set_orientation(yaw=yaw, pitch=pitch)
        return cam

    def _reservoir(self, kept: list, seen: int, item) -> None:
        """Keep a uniform sample of ``self.keep`` of the outputs seen."""
        if len(kept) < self.keep:
            kept.append(item())
            return
        j = int(self.pick.integers(0, seen + 1))
        if j < self.keep:
            kept[j] = item()


class Client:
    """Runs a mix against a pipeline (``RenderPipeline``) with the
    program's ``Camera`` and ``Accumulator`` types."""

    def __init__(self, traffic: Traffic, pipe, cam_type, acc_type,
                 steps: HostSteps = None):
        self.tr = traffic
        self.steps = steps or HostSteps()
        self.pipe = pipe
        self.cam_type = cam_type
        self.acc_type = acc_type
        self.aspect = pipe.config.aspect_ratio
        self.cuda = traffic.device.type == "cuda"

    def _sync(self):
        if self.cuda:
            with self.steps("synchronize"):
                torch.cuda.synchronize()

    def _event(self):
        return (torch.cuda.Event(enable_timing=True) if self.cuda
                else HostEvent())

    def warm_up(self) -> None:
        """The mix's own shapes, once each, before the window."""
        tr, mix = self.tr, self.tr.mix
        cam = tr.camera(0, self.cam_type, self.aspect)
        for k in range(int(mix.get("warmup", 1))):
            if tr.kind == "frames":
                self.pipe.render(cam, tr.base + k)
            elif tr.kind == "joint":
                acc = self.acc_type(tr.width, tr.height, 1)
                s, _ = self.pipe.render_batch_sum(cam, tr.base + k,
                                                  mix["batch"])
                acc.add_frames_sum(s.cpu().numpy(), mix["batch"])
            else:
                cams = [tr.camera(j, self.cam_type, self.aspect)
                        for j in range(mix["group"])]
                self.pipe.render_pooled(cams, [tr.base + j for j in
                                               range(mix["group"])])
        self._sync()

    def run(self, seconds: float) -> Window:
        """The measured window."""
        run = {"frames": self._frames, "joint": self._joint,
               "pooled": self._pooled}[self.tr.kind]
        win = Window()
        self._sync()
        start = time.perf_counter()
        run(win, start + seconds)
        self._sync()
        win.seconds = time.perf_counter() - start
        return win

    def _frames(self, win: Window, deadline: float) -> None:
        tr = self.tr
        events = []
        while time.perf_counter() < deadline:
            i = win.units
            with self.steps("camera"):
                cam = tr.camera(i, self.cam_type, self.aspect)
            begin, end = self._event(), self._event()
            begin.record()
            with self.steps("render"):
                image, _ = self.pipe.render(cam, tr.base + i)
            end.record()
            self._sync()
            events.append((begin, end))
            win.units += 1
            win.frames += 1
            with self.steps("keep"):
                tr._reservoir(win.kept, i, lambda: {
                    "index": i, "frame": tr.base + i,
                    "values": image.reshape(-1, 3)[tr.pix]})
        win.frame_ms = [b.elapsed_time(e) for b, e in events]

    def _joint(self, win: Window, deadline: float) -> None:
        tr, mix = self.tr, self.tr.mix
        batch, target = int(mix["batch"]), int(mix["target_spp"])
        still, frame = 0, tr.base
        cam = tr.camera(still, self.cam_type, self.aspect)
        acc = self.acc_type(tr.width, tr.height, 1)
        stills = [{"index": still, "frame0": frame, "acc": acc}]
        while time.perf_counter() < deadline:
            if acc.spp >= target:
                still += 1
                cam = tr.camera(still, self.cam_type, self.aspect)
                acc = self.acc_type(tr.width, tr.height, 1)
                stills.append({"index": still, "frame0": frame, "acc": acc})
            with self.steps("render_batch_sum"):
                total, _ = self.pipe.render_batch_sum(cam, frame, batch)
            with self.steps("accumulate"):
                acc.add_frames_sum(total.cpu().numpy(), batch)
            frame += batch
            win.units += 1
            win.spp += batch
        # The check takes the longest still: the first that converged.
        still = max(stills, key=lambda s: s["acc"].spp)
        acc = still.pop("acc")
        if acc.spp:
            py, px = tr.py.cpu().numpy(), tr.px.cpu().numpy()
            still["spp"] = acc.spp
            still["values"] = torch.as_tensor(acc.mean[py, px])
            win.kept.append(still)

    def _pooled(self, win: Window, deadline: float) -> None:
        tr, mix = self.tr, self.tr.mix
        group = int(mix["group"])
        while time.perf_counter() < deadline:
            first = win.frames
            with self.steps("camera"):
                cams = [tr.camera(first + k, self.cam_type, self.aspect)
                        for k in range(group)]
            with self.steps("render_pooled"):
                images, _ = self.pipe.render_pooled(
                    cams, [tr.base + first + k for k in range(group)])
            self._sync()
            win.units += 1
            win.frames += group
            with self.steps("keep"):
                for k in range(group):
                    tr._reservoir(win.kept, first + k, lambda k=k: {
                        "index": first + k, "frame": tr.base + first + k,
                        "values": images[k].reshape(-1, 3)[tr.pix]})
