"""The reference's own reading of a binary glTF scene, NumPy only.

``load_triangles(path)`` returns every triangle of the scene in world
space, with what a path tracer needs to shade it: the glTF 2.0 meaning
of the file, read independently of the program.  The conventions are
the reference renderer's (antlilja/vulkan-pathtracer ``Scene.zig``,
``triangle.glsl``, ``material.glsl``):

- world positions ``A p + t`` computed in float64 and rounded to f32,
  edges subtracted in f32;
- the geometric normal: the object-space edge cross product times
  ``inverse(A)`` (the reference's row-vector normal transform),
  normalized in float64;
- vertex normals times ``inverse(A)``, rounded to f32;
- material factors quantized as the reference packs them into RGBA8:
  ``trunc(clamp(f, 0, 1) * 255)``.

Textures are not read: the benchmark's scenes have none.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

_COMPONENTS = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class Triangles:
    """A scene as triangles in world space (T rows each)."""

    v0: np.ndarray         # (T, 3) f32
    e1: np.ndarray         # (T, 3) f32
    e2: np.ndarray         # (T, 3) f32
    gn: np.ndarray         # (T, 3) f32 geometric normal
    normals: np.ndarray    # (T, 3, 3) f32 vertex normals
    material: np.ndarray   # (T,) int64
    albedo: np.ndarray     # (M, 3) f32, quantized
    roughness: np.ndarray  # (M,) f32, quantized
    metallic: np.ndarray   # (M,) f32, quantized
    emissive: np.ndarray   # (M, 3) f32, quantized

    @property
    def count(self) -> int:
        return int(self.v0.shape[0])


def _parse(data: bytes):
    magic, version, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67 or version != 2:
        raise ValueError("not a glTF 2.0 binary file")
    offset, doc, binary = 12, None, b""
    while offset < len(data):
        length, kind = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8:offset + 8 + length]
        if kind == 0x4E4F534A:
            doc = json.loads(chunk)
        elif kind == 0x004E4942:
            binary = chunk
        offset += 8 + length
    return doc, binary


def _accessor(doc, binary, index) -> np.ndarray:
    acc = doc["accessors"][index]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_COMPONENTS[acc["componentType"]])
    width = _WIDTH[acc["type"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", dtype.itemsize * width)
    count = acc["count"]
    raw = np.frombuffer(binary, dtype=np.uint8,
                        count=stride * (count - 1) + dtype.itemsize * width,
                        offset=start)
    rows = np.lib.stride_tricks.as_strided(
        raw, shape=(count, dtype.itemsize * width), strides=(stride, 1))
    return np.ascontiguousarray(rows).view(dtype).reshape(count, width)


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = np.diag([*node["scale"], 1.0]) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.eye(4)
        r[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                      2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                      2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w),
                      1 - 2 * (x * x + y * y)]]
        m = r @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _instances(doc):
    """(mesh index, world matrix) of every mesh node of the scene."""
    out = []
    stack = [(root, np.eye(4)) for root in doc["scenes"][doc.get("scene", 0)]
             ["nodes"]]
    while stack:
        index, parent = stack.pop()
        node = doc["nodes"][index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            out.append((node["mesh"], world))
        stack.extend((c, world) for c in node.get("children", []))
    return out


def _quantize(values) -> np.ndarray:
    """The reference's RGBA8 factor: trunc(clamp(f) * 255) / 255."""
    q = np.floor(np.clip(np.asarray(values, np.float64), 0.0, 1.0) * 255.0)
    return (q.astype(np.float32) / np.float32(255.0)).astype(np.float32)


def load_triangles(path: str) -> Triangles:
    with open(path, "rb") as f:
        doc, binary = _parse(f.read())
    mats = doc.get("materials", [])
    pbr = [m.get("pbrMetallicRoughness", {}) for m in mats]
    albedo = _quantize([p.get("baseColorFactor", [1, 1, 1, 1])[:3]
                        for p in pbr]).reshape(-1, 3)
    roughness = _quantize([p.get("roughnessFactor", 1.0) for p in pbr])
    metallic = _quantize([p.get("metallicFactor", 1.0) for p in pbr])
    emissive = _quantize([m.get("emissiveFactor", [0, 0, 0])
                          for m in mats]).reshape(-1, 3)
    parts = {k: [] for k in ("v0", "e1", "e2", "gn", "normals", "material")}
    for mesh, world in _instances(doc):
        a, t = world[:3, :3], world[:3, 3]
        inv = np.linalg.inv(a)
        for prim in doc["meshes"][mesh]["primitives"]:
            attrs = prim["attributes"]
            pos = _accessor(doc, binary, attrs["POSITION"]).astype(np.float64)
            nrm = _accessor(doc, binary, attrs["NORMAL"]).astype(np.float64)
            idx = _accessor(doc, binary, prim["indices"]).reshape(-1, 3)
            idx = idx.astype(np.int64)
            p = [pos[idx[:, k]] for k in range(3)]
            w = [(q @ a.T + t).astype(np.float32) for q in p]
            cross = np.cross(p[1] - p[0], p[2] - p[0]) @ inv.T
            length = np.maximum(np.linalg.norm(cross, axis=1), 1e-30)
            parts["v0"].append(w[0])
            parts["e1"].append(w[1] - w[0])
            parts["e2"].append(w[2] - w[0])
            parts["gn"].append((cross / length[:, None]).astype(np.float32))
            parts["normals"].append(np.stack(
                [(nrm[idx[:, k]] @ inv.T).astype(np.float32)
                 for k in range(3)], axis=1))
            parts["material"].append(
                np.full(idx.shape[0], prim.get("material", 0), np.int64))
    cat = {k: np.concatenate(v) for k, v in parts.items()}
    return Triangles(albedo=albedo, roughness=roughness, metallic=metallic,
                     emissive=emissive, **cat)
