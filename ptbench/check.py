"""The comparison that decides ``correct``.

After the window, the outputs the run kept (``traffic.Window.kept``: a
seeded sample of the frames it delivered, or its longest still, each
at a seeded sample of pixels) are worked out again by
the plain reference (``ptbench/reference``) from the scene's glTF, the
camera's pose and the frame counters, and compared pixel by pixel.

One number is compared, ``pixels_off``: the share, in percent, of the
compared pixels whose radiance differs from the reference's in some
channel by more than ``atol + rtol * |reference|`` (``rtol`` 2^-10,
``atol`` 2^-16, from the traffic file).  A pixel of a sound run differs
only where a traversal breaks a tie of equal ``t`` otherwise, or where
float rounding at a box face or a shared edge sends a ray elsewhere;
a frame in lower precision, a wrong hit, a wrong draw, a batch with
frames left out or an altered output moves most pixels.  Its limit is
in the traffic file, set from the readings that ``PERF.md`` gives.

``control`` renders the same pixels with the reference in bfloat16, the
precision below the configuration's float32, in the program's place.
"""

from __future__ import annotations

import torch

from ptbench.orbit import camera_vectors
from ptbench.reference import render as reference


def _reference_values(scene, traffic, kept: list, config: dict):
    """The reference's values of every kept output, (K, P, 3) f32."""
    width, height, bounces = (config["width"], config["height"],
                              config["bounces"])
    aspect = width / height

    def vectors(item):
        return camera_vectors(*traffic.pose(item["index"]), aspect=aspect)

    if traffic.kind == "joint":
        return torch.stack([
            (reference.accumulate_pixels(
                scene, vectors(item), item["frame0"], item["spp"],
                traffic.px, traffic.py, width, height, bounces)
             / item["spp"]).float() for item in kept])
    return reference.render_views(
        scene, [(vectors(item), item["frame"]) for item in kept],
        traffic.px, traffic.py, width, height, bounces)


def off_mask(values: torch.Tensor, ref: torch.Tensor, check: dict):
    """(P,) bool: pixels off by more than the tolerance in a channel."""
    values = values.to(ref.device).float()
    gap = (values - ref).abs()
    off = gap > check["atol"] + check["rtol"] * ref.abs()
    return (off | ~torch.isfinite(values)).any(dim=1)


def compare(kept: list, traffic, config: dict, scene_path: str, device,
            control: bool = False) -> dict:
    """The numbers compared, each with its limit, and how many kept
    outputs failed: ``{"numbers": {name: {"value", "limit"}},
    "failed": n, "compared": pixels, "control": value or None}``."""
    check = traffic.mix["check"]
    if not kept:
        return {"numbers": {"pixels_off": {"value": 100.0,
                                           "limit": check["limit"]}},
                "failed": 0, "compared": 0, "control": None}
    scene = reference.load_scene(scene_path, device, torch.float32)
    ref = _reference_values(scene, traffic, kept, config)
    masks = [off_mask(item["values"], r, check) for item, r in zip(kept, ref)]
    off = sum(int(m.sum()) for m in masks)
    total = sum(m.numel() for m in masks)
    failed = sum(100.0 * float(m.float().mean()) > check["limit"]
                 for m in masks)
    low = None
    if control:
        low_scene = reference.load_scene(scene_path, device, torch.bfloat16)
        low_ref = _reference_values(low_scene, traffic, kept, config)
        low = 100.0 * sum(int(off_mask(v, r, check).sum())
                          for v, r in zip(low_ref, ref)) / total
    return {"numbers": {"pixels_off": {"value": 100.0 * off / total,
                                       "limit": check["limit"]}},
            "failed": failed, "compared": total, "control": low}
