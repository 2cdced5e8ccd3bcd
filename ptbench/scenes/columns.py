"""The benchmark's animated scene: a frozen copy of the procedural
columns, with glTF animation channels.

``make_columns`` writes the repository's ``make_columns``
(``assets/procedural.py``) as a binary glTF: a 40 x 40 floor with a
12 x 12 emissive panel at y = 10 (one mesh, one static node) and a
``grid`` x ``grid`` field of columns, 2 apart, each of ``segments`` boxes
of 0.5 height, one mesh per material shared by every ``n_materials``-th
column, one node per column.  At ``grid=20, segments=24, n_materials=32``
it has 401 nodes, 33 meshes and 115,204 world triangles from 9,220
shared ones.  ``groups`` nests that many parent nodes above the columns.

``make`` adds the benchmark's motion (``column_channels``) and its
clock, which the animation's ``extras`` carry: frame counter ``f`` is
shown at ``(f mod period_frames) / frames_per_second`` seconds.  Column
``i`` at rest position (x, 0, z) has a ``LINEAR`` translation channel
(x, 1.5 sin(pi t + 0.7 i), z) and a ``LINEAR`` rotation channel, a turn
about +y by (pi / 2) t + 0.3 i, both keyed at k / 8 s for k = 0 .. 32:
both loop exactly over 4 s.  Any other channels can be written with
``make_columns(..., channels=...)`` (the CPU tests' seeded keyframes).

The building blocks and the GLB writer are the frozen atrium's
(``scenes/atrium.py``); the animations are appended to the file it
writes.  NumPy only: the same parameters always write the same bytes.
"""

from __future__ import annotations

import json
import math
import struct
from typing import List, Optional

import numpy as np

from ptbench.scenes.atrium import (
    MaterialDesc,
    NodeDesc,
    PrimData,
    _quad,
    box_prim,
    merge_prims,
    write_glb,
)

KEYS = 33             # key times k / 8 s, k = 0 .. 32
KEY_STEP = 0.125
BOB = 1.5             # translation amplitude (y)


def column_channels(grid: int) -> list:
    """The benchmark's motion of the ``grid`` x ``grid`` columns: dicts
    of ``node``, ``path``, ``times`` (K,), ``values`` (K, 3 or 4),
    ``interpolation``."""
    times = np.arange(KEYS, dtype=np.float64) * KEY_STEP
    out = []
    for i, (x, z) in enumerate(column_positions(grid)):
        y = BOB * np.sin(math.pi * times + 0.7 * i)
        out.append({"node": i, "path": "translation", "times": times,
                    "values": np.stack([np.full_like(times, x), y,
                                        np.full_like(times, z)], axis=1),
                    "interpolation": "LINEAR"})
        half = 0.5 * (0.5 * math.pi * times + 0.3 * i)
        out.append({"node": i, "path": "rotation", "times": times,
                    "values": np.stack([np.zeros_like(times), np.sin(half),
                                        np.zeros_like(times), np.cos(half)],
                                       axis=1),
                    "interpolation": "LINEAR"})
    return out


def column_positions(grid: int) -> list:
    """(x, z) of each column node, in node order."""
    return [((gx - grid / 2 + 0.5) * 2.0, (gz - grid / 2 + 0.5) * 2.0)
            for gx in range(grid) for gz in range(grid)]


def make_columns(path: str, grid: int = 8, segments: int = 6,
                 n_materials: int = 16, channels: Optional[list] = None,
                 groups: int = 0, extras: Optional[dict] = None) -> None:
    """The columns (module docstring) with ``channels`` (dicts as
    ``column_channels`` returns) as one glTF animation with ``extras``;
    ``groups`` parent nodes nested above the columns (nodes grid^2 + 1 ..
    grid^2 + groups, the outermost first)."""
    rng = np.random.default_rng(1234)
    meshes: List[List[PrimData]] = []
    nodes: List[NodeDesc] = []
    materials = [
        MaterialDesc(
            base_color=tuple(rng.uniform(0.2, 0.9, size=3)) + (1.0,),
            metallic=float(rng.uniform(0.0, 1.0)),
            roughness=float(rng.uniform(0.1, 0.9)),
        )
        for _ in range(n_materials)
    ]
    for mi in range(n_materials):
        parts = []
        for s in range(segments):
            size = 0.3 + 0.1 * math.sin(s * 1.7)
            parts.append(
                box_prim((0.0, 0.25 + s * 0.5, 0.0), (size, 0.5, size), mi)
            )
        meshes.append([merge_prims(parts, mi)])
    floor = _quad((-20, 0, 20), (20, 0, 20), (20, 0, -20), (-20, 0, -20), 0)
    roof_lights = _quad((-6, 10.0, 6), (6, 10.0, 6), (6, 10.0, -6),
                        (-6, 10.0, -6), n_materials)
    materials.append(
        MaterialDesc(base_color=(0, 0, 0, 1), emissive=(1.0, 0.95, 0.8))
    )
    meshes.append([floor, roof_lights])
    for k, (x, z) in enumerate(column_positions(grid)):
        nodes.append(NodeDesc(mesh=k % n_materials,
                              translation=(x, 0.0, z)))
    columns = list(range(len(nodes)))
    nodes.append(NodeDesc(mesh=n_materials))  # floor + light
    for g in range(groups):
        inner = (columns if g == groups - 1
                 else [len(nodes) + 1])
        nodes.append(NodeDesc(children=inner))
    write_glb(path, meshes=meshes, materials=materials, nodes=nodes)
    if channels:
        add_animation(path, channels, extras)


def add_animation(path: str, channels: list, extras: dict = None) -> None:
    """Append ``channels`` to the GLB at ``path`` as one animation: per
    channel an f32 input accessor (key times) and an f32 output accessor
    (values), a sampler and a channel; ``extras`` as the animation's."""
    with open(path, "rb") as f:
        data = f.read()
    json_len = struct.unpack_from("<I", data, 12)[0]
    doc = json.loads(data[20:20 + json_len])
    bin_len = struct.unpack_from("<I", data, 20 + json_len)[0]
    binary = bytearray(data[28 + json_len:28 + json_len + bin_len])
    accessors, views = doc["accessors"], doc["bufferViews"]

    def accessor(arr: np.ndarray, type_: str) -> int:
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        binary.extend(b"\x00" * ((-len(binary)) % 4))
        views.append({"buffer": 0, "byteOffset": len(binary),
                      "byteLength": arr.nbytes})
        binary.extend(arr.tobytes())
        acc = {"bufferView": len(views) - 1, "componentType": 5126,
               "count": int(arr.shape[0]), "type": type_}
        if type_ == "SCALAR":
            acc["min"] = [float(arr.min())]
            acc["max"] = [float(arr.max())]
        accessors.append(acc)
        return len(accessors) - 1

    samplers, out = [], []
    for ch in channels:
        values = np.asarray(ch["values"])
        samplers.append({
            "input": accessor(np.asarray(ch["times"]).reshape(-1), "SCALAR"),
            "output": accessor(values, "SCALAR" if values.shape[1] == 1
                               else f"VEC{values.shape[1]}"),
            "interpolation": ch.get("interpolation", "LINEAR")})
        out.append({"sampler": len(samplers) - 1,
                    "target": {"node": int(ch["node"]), "path": ch["path"]}})
    doc["animations"] = [{"channels": out, "samplers": samplers}]
    if extras:
        doc["animations"][0]["extras"] = extras
    binary.extend(b"\x00" * ((-len(binary)) % 4))
    doc["buffers"][0]["byteLength"] = len(binary)
    json_bytes = json.dumps(doc, separators=(",", ":")).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(binary), 0x004E4942))
        f.write(bytes(binary))


def make(path: str, grid: int, segments: int, n_materials: int,
         period_frames: int, frames_per_second: float) -> None:
    """The benchmark's entry point: the columns with their motion and
    its clock (module docstring)."""
    make_columns(path, grid=grid, segments=segments,
                 n_materials=n_materials, channels=column_channels(grid),
                 extras={"clock": {
                     "period_frames": int(period_frames),
                     "frames_per_second": float(frames_per_second)}})
