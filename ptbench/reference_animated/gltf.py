"""The reference's own reading of an animated binary glTF, NumPy only.

``load(path)`` reads the node graph, the meshes, every animation's
channels (glTF 2.0, section "Animations") and the benchmark's clock,
which the first animation's ``extras`` carry (``scenes/columns.py``); ``world_matrices(doc, t)``
poses every node at ``t`` seconds in float64; ``triangles_at(doc, t)``
flattens the world triangles there with ``ptbench.reference.gltf``'s
conventions (world positions ``A p + t`` in float64 rounded to f32,
normals by ``inverse(A)``, factors quantized as RGBA8).

The evaluation follows the specification as written:

- a channel's keys bracket ``t``: before the first key its first value,
  after the last its last value;
- ``STEP`` holds the earlier key's value; ``LINEAR`` blends translation
  and scale linearly and rotation by spherical linear interpolation of
  the normalised keys along the shorter arc (a linear blend, then
  normalised, where the keys' angle is below 1e-9 in its cosine); a
  rotation is normalised wherever it comes from;
- a node's local matrix is T R S of its animated or rest values, or its
  ``matrix``; a world matrix is its parent's times its local matrix.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ptbench.reference.gltf import Triangles, _accessor, _parse, _quantize

PATHS = {"translation": 3, "rotation": 4, "scale": 3}


@dataclass
class Document:
    """An animated glTF as the reference reads it."""

    doc: dict
    binary: bytes
    channels: list         # (node, path, times (K,), values (K, w), interp)
    meshes: dict           # mesh -> [(p0, p1, p2, normals (T,3,3), mat)]
    clock: tuple           # (period in frames, frames per second) or None

    def seconds(self, frame: int) -> float:
        """The time of frame counter ``frame``: (frame mod P) / R."""
        if self.clock is None:
            raise ValueError("the scene's animation carries no clock "
                             "(extras.clock)")
        period, rate = self.clock
        return (int(frame) % period) / rate


def _channels(doc, binary) -> list:
    out = []
    for anim in doc.get("animations", []):
        for ch in anim["channels"]:
            target = ch["target"]
            if "node" not in target:
                continue
            sampler = anim["samplers"][ch["sampler"]]
            interp = sampler.get("interpolation", "LINEAR")
            if interp not in ("LINEAR", "STEP") or \
                    target["path"] not in PATHS:
                raise ValueError(f"the reference does not evaluate "
                                 f"{interp} {target['path']}")
            times = _accessor(doc, binary, sampler["input"])
            values = _accessor(doc, binary, sampler["output"])
            out.append((target["node"], target["path"],
                        times.reshape(-1).astype(np.float64),
                        values.astype(np.float64), interp))
    return out


def _mesh_parts(doc, binary, mesh: int) -> list:
    parts = []
    for prim in doc["meshes"][mesh]["primitives"]:
        attrs = prim["attributes"]
        pos = _accessor(doc, binary, attrs["POSITION"]).astype(np.float64)
        nrm = _accessor(doc, binary, attrs["NORMAL"]).astype(np.float64)
        idx = _accessor(doc, binary, prim["indices"]).reshape(-1, 3)
        idx = idx.astype(np.int64)
        parts.append(([pos[idx[:, k]] for k in range(3)],
                      np.stack([nrm[idx[:, k]] for k in range(3)], axis=1),
                      prim.get("material", 0)))
    return parts


def load(path: str) -> Document:
    with open(path, "rb") as f:
        doc, binary = _parse(f.read())
    meshes = {n["mesh"]: None for n in doc["nodes"] if "mesh" in n}
    for mesh in meshes:
        meshes[mesh] = _mesh_parts(doc, binary, mesh)
    clock = None
    for anim in doc.get("animations", [])[:1]:
        entry = anim.get("extras", {}).get("clock")
        if entry is not None:
            clock = (int(entry["period_frames"]),
                     float(entry["frames_per_second"]))
    return Document(doc, binary, _channels(doc, binary), meshes, clock)


def _slerp(a, b, s: float) -> np.ndarray:
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    d = float(np.dot(a, b))
    if d < 0.0:
        b, d = -b, -d
    if d > 1.0 - 1e-9:
        q = (1.0 - s) * a + s * b
    else:
        angle = math.acos(min(d, 1.0))
        q = (math.sin((1.0 - s) * angle) * a
             + math.sin(s * angle) * b) / math.sin(angle)
    return q / np.linalg.norm(q)


def sample(times, values, interp: str, path: str, t: float) -> np.ndarray:
    """One channel's value at ``t`` (a rotation normalised)."""
    k = int(np.clip(np.searchsorted(times, t, side="right") - 1, 0,
                    len(times) - 1))
    if t <= times[0] or t >= times[-1] or interp == "STEP":
        v = values[k]
        return v / np.linalg.norm(v) if path == "rotation" else v
    s = (t - times[k]) / (times[k + 1] - times[k])
    if path == "rotation":
        return _slerp(values[k], values[k + 1], s)
    return values[k] * (1.0 - s) + values[k + 1] * s


def _local(node: dict, trs: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], dtype=np.float64).reshape(4, 4).T
    x, y, z, w = trs.get("rotation", node.get("rotation", (0, 0, 0, 1)))
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)]], dtype=np.float64)
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(trs.get("scale", node.get("scale", (1, 1, 1))))
    m[:3, 3] = trs.get("translation", node.get("translation", (0, 0, 0)))
    return m


def world_matrices(doc: Document, t: float) -> dict:
    """{node: (4, 4) float64 world matrix} of every node of the scene at
    ``t`` seconds."""
    trs = {}
    for node, path, times, values, interp in doc.channels:
        trs.setdefault(node, {})[path] = sample(times, values, interp, path,
                                                float(t))
    nodes = doc.doc["nodes"]
    out = {}
    stack = [(r, np.eye(4)) for r in
             doc.doc["scenes"][doc.doc.get("scene", 0)]["nodes"]]
    while stack:
        index, parent = stack.pop()
        world = parent @ _local(nodes[index], trs.get(index, {}))
        out[index] = world
        stack.extend((c, world) for c in nodes[index].get("children", []))
    return out


def instances_at(doc: Document, t: float) -> list:
    """(mesh, world matrix) of every mesh node at ``t``, in the order
    of ``ptbench.reference.gltf``'s flattening."""
    worlds = world_matrices(doc, t)
    out = []
    nodes = doc.doc["nodes"]
    stack = list(doc.doc["scenes"][doc.doc.get("scene", 0)]["nodes"])
    while stack:
        index = stack.pop()
        if "mesh" in nodes[index]:
            out.append((nodes[index]["mesh"], worlds[index]))
        stack.extend(nodes[index].get("children", []))
    return out


def triangles_at(doc: Document, t: float) -> Triangles:
    """Every triangle of the scene in world space at ``t`` seconds."""
    mats = doc.doc.get("materials", [])
    pbr = [m.get("pbrMetallicRoughness", {}) for m in mats]
    parts = {k: [] for k in ("v0", "e1", "e2", "gn", "normals", "material")}
    for mesh, world in instances_at(doc, t):
        a, tr = world[:3, :3], world[:3, 3]
        inv = np.linalg.inv(a)
        for p, nrm, material in doc.meshes[mesh]:
            w = [(q @ a.T + tr).astype(np.float32) for q in p]
            cross = np.cross(p[1] - p[0], p[2] - p[0]) @ inv.T
            length = np.maximum(np.linalg.norm(cross, axis=1), 1e-30)
            parts["v0"].append(w[0])
            parts["e1"].append(w[1] - w[0])
            parts["e2"].append(w[2] - w[0])
            parts["gn"].append((cross / length[:, None]).astype(np.float32))
            parts["normals"].append((nrm @ inv.T).astype(np.float32))
            parts["material"].append(np.full(p[0].shape[0], material,
                                             np.int64))
    cat = {k: np.concatenate(v) for k, v in parts.items()}
    return Triangles(
        albedo=_quantize([p.get("baseColorFactor", [1, 1, 1, 1])[:3]
                          for p in pbr]).reshape(-1, 3),
        roughness=_quantize([p.get("roughnessFactor", 1.0) for p in pbr]),
        metallic=_quantize([p.get("metallicFactor", 1.0) for p in pbr]),
        emissive=_quantize([m.get("emissiveFactor", [0, 0, 0])
                            for m in mats]).reshape(-1, 3), **cat)
