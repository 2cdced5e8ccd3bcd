"""The plain reference path tracer of an animated scene: pixels of
frames, from the scene's glTF, the camera's pose and the frame counter
alone.

A frame's time is its counter's, by the clock that the scene's file
carries (``gltf.Document.seconds``: the configuration's rule, written by
the scene's generator).  For each time, the world triangles are
flattened by this package's own evaluation of the glTF's channels
(``gltf.triangles_at``, float64), then ``ptbench.reference``'s tree is
built over them and its path tracer traces the frames of that time
(``ptbench.reference.render``): the same formulas, lane by lane, in
``dtype`` (float32, or bfloat16 for the control).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ptbench.reference import render as plain
from ptbench.reference import tree as walk_tree
from ptbench.reference_animated import gltf


@dataclass
class Scene:
    """An animated scene: the file as read, and the posed scenes built
    so far, by time."""

    doc: gltf.Document
    device: object
    dtype: torch.dtype
    posed: dict = field(default_factory=dict)


def load_scene(path: str, device="cpu", dtype=torch.float32) -> Scene:
    return Scene(gltf.load(path), device, dtype)


def scene_at(scene: Scene, t: float) -> plain.Scene:
    """The reference's scene (tree, per-triangle shading data) posed at
    ``t`` seconds; the last one built is kept."""
    if t not in scene.posed:
        tri = gltf.triangles_at(scene.doc, t)
        m = tri.material

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=scene.device).to(scene.dtype)

        scene.posed = {t: plain.Scene(
            tree=walk_tree.build_tree(tri.v0, tri.e1, tri.e2, scene.device,
                                      scene.dtype),
            normals=dev(tri.normals), gn=dev(tri.gn),
            albedo=dev(tri.albedo[m]), roughness=dev(tri.roughness[m]),
            metallic=dev(tri.metallic[m]), emissive=dev(tri.emissive[m]),
            dtype=scene.dtype, emissive_free=not tri.emissive[m].any())}
    return scene.posed[t]


def render_views(scene: Scene, views, px, py, width: int, height: int,
                 bounces: int) -> torch.Tensor:
    """Radiance (V, P, 3) f32 of the pixels (px, py) of each view
    ``(vectors, frame)``, each frame at its counter's time."""
    out = torch.empty((len(views), px.shape[0], 3), dtype=torch.float32,
                      device=px.device)
    times = [scene.doc.seconds(frame) for _, frame in views]
    for t in sorted(set(times)):
        ks = [k for k, tk in enumerate(times) if tk == t]
        out[ks] = plain.render_views(scene_at(scene, t),
                                     [views[k] for k in ks], px, py, width,
                                     height, bounces)
    return out


def accumulate_pixels(scene: Scene, vectors, frame0: int, frames: int, px,
                      py, width: int, height: int,
                      bounces: int) -> torch.Tensor:
    """The float64 SUM (P, 3) of ``frames`` frames from ``frame0`` of a
    static camera at the pixels (px, py), each frame at its counter's
    time."""
    total = torch.zeros((px.shape[0], 3), dtype=torch.float64,
                        device=px.device)
    by_time = {}
    for f in range(frame0, frame0 + frames):
        by_time.setdefault(scene.doc.seconds(f), []).append(f)
    for t, fs in sorted(by_time.items()):
        posed = scene_at(scene, t)
        for f in fs:
            total += plain.accumulate_pixels(posed, vectors, f, 1, px, py,
                                             width, height, bounces)
    return total
