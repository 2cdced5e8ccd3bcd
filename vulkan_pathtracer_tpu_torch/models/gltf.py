"""glTF 2.0 scene ingestion — the ``Scene.zig`` equivalent.

Port of ``vulkan_pathtracer_tpu/models/gltf.py``: the loader is NumPy
and unchanged; only the factor packing comes from the port's own
``ops/packing.py`` (the JAX package's packing module imports JAX).

Reproduces the reference's load-time contract (Scene.zig:79-546):

- ``.glb`` and ``.gltf`` (external files, embedded base64 data URIs,
  GLB binary chunk) — Scene.zig:89-136.
- **Hard contract** per primitive (Scene.zig:176-182, 251): triangle
  topology only; indices, POSITION (vec3 f32), NORMAL (vec3 f32),
  TANGENT (vec4 f32), TEXCOORD_0 (vec2 f32) and a material are all
  required — typed errors otherwise.  Indices must be uint16 or
  uint32 (the reference's ``else => unreachable``).
- Exactly one scene (Scene.zig:495-496).
- Materials: factors quantized to RGBA8 words, texture indices with
  0xffffffff = none (Scene.zig:448-485).
- Textures decoded to RGBA8 with a host thread pool
  (Scene.zig:354-446; decode itself is native code — PIL's C decoders
  here, stb_image there).
- Node graph flattened iteratively with an explicit stack
  (Scene.zig:487-546).  The reference composes mesh-node transforms as
  ``S · T · inherited · R`` (zalgebra's translate/scale pre-multiply)
  and lets non-mesh nodes pass their *inherited* matrix through
  unchanged, ignoring their own TRS — a documented quirk.  By default
  this loader uses the correct glTF composition
  ``world = inherited · T · R · S`` (with ``matrix`` support); pass
  ``quirk_mode=True`` for bit-parity with the reference's flattening.
- Animations (glTF 2.0, section "Animations"; the reference has none):
  the channels of every animation, played together, ``LINEAR`` or
  ``STEP`` keyframes of nodes' ``translation``, ``rotation`` and
  ``scale``, kept with the node graph and each instance's node
  (``Scene.animation``, a NodeGraph) for the device evaluator
  (models/node_animation.py).  ``CUBICSPLINE``, morph ``weights``, skins
  and animation under ``quirk_mode`` are not played: such a file loads
  at rest, with the reason in ``Scene.animation_refused``, which
  app/main.load_pipeline raises as a ValueError where a pose is asked
  for.

The hot byte-shuffling (accessor extraction) is NumPy views over the
raw buffers — zero-copy where stride allows — with an optional C++
fast path in ``native/`` used when built.
"""

from __future__ import annotations

import base64
import concurrent.futures
import io
import json
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from vulkan_pathtracer_tpu_torch.ops.packing import pack_unorm4x8

INVALID_TEXTURE_INDEX = 0xFFFFFFFF
MATERIAL_INDEX_MASK = 0xFFFFFF
UINT32_INDICES_MASK = 0x80000000


# --------------------------------------------------------------------------
# Typed contract errors (named after Scene.zig's error set)
# --------------------------------------------------------------------------
class GltfError(Exception):
    pass


class GltfNotATriangleTopology(GltfError):
    pass


class GltfNoIndices(GltfError):
    pass


class GltfNoPositions(GltfError):
    pass


class GltfNoNormals(GltfError):
    pass


class GltfNoTangents(GltfError):
    pass


class GltfNoTextureCoordinates(GltfError):
    pass


class NoMaterial(GltfError):
    pass


class NoBufferView(GltfError):
    pass


class InvalidPositionType(GltfError):
    pass


class InvalidNormalType(GltfError):
    pass


class InvalidTangentType(GltfError):
    pass


class InvalidTexcoordType(GltfError):
    pass


class InvalidIndexType(GltfError):
    pass


class NoScene(GltfError):
    pass


class TooManyScenes(GltfError):
    pass


class UnsupportedFile(GltfError):
    pass


# --------------------------------------------------------------------------
# Scene data model (host side, NumPy SoA)
# --------------------------------------------------------------------------
@dataclass
class Primitive:
    """One glTF primitive; mirrors Scene.zig's Primitive (:24-36) with
    arrays instead of byte offsets into a packed blob."""

    indices: np.ndarray     # (3T,) uint16 or uint32
    positions: np.ndarray   # (V, 3) f32
    normals: np.ndarray     # (V, 3) f32
    tangents: np.ndarray    # (V, 4) f32
    uvs: np.ndarray         # (V, 2) f32
    material_index: int
    uint32_indices: bool

    @property
    def triangle_count(self) -> int:
        return len(self.indices) // 3

    @property
    def max_vertex(self) -> int:
        return len(self.positions) - 1

    @property
    def info(self) -> int:
        """The packed info word (24-bit material index | u32-index flag),
        Scene.zig:32-36."""
        word = self.material_index & MATERIAL_INDEX_MASK
        if self.uint32_indices:
            word |= UINT32_INDICES_MASK
        return word


@dataclass
class Mesh:
    start: int  # first primitive index (global)
    end: int


@dataclass
class Instance:
    mesh_index: int
    transform: np.ndarray  # (4, 4) f32 world transform (math convention;
    # the reference stores it transposed as Vulkan row-major 3x4,
    # Scene.zig:529 — same matrix)
    node: int = -1         # the glTF node it was flattened from


@dataclass
class Texture:
    data: np.ndarray  # (H, W, 4) uint8 RGBA
    width: int
    height: int


# Material words — identical packing to Scene.zig:38-47 / material.glsl:7-16.
MATERIAL_DTYPE = np.dtype(
    [
        ("albedo_factor", np.uint32),
        ("metal_roughness_factor", np.uint32),
        ("emissive_factor", np.uint32),
        ("albedo_texture_index", np.uint32),
        ("metal_roughness_texture_index", np.uint32),
        ("emissive_texture_index", np.uint32),
        ("normal_texture_index", np.uint32),
    ]
)


@dataclass
class Channel:
    """One glTF animation channel with its sampler: the keyframes of one
    node's ``translation``, ``rotation`` (xyzw) or ``scale``."""

    node: int
    path: str             # translation | rotation | scale
    times: np.ndarray     # (K,) f32 key times in seconds, increasing
    values: np.ndarray    # (K, 3) or (K, 4) f32
    interpolation: str    # LINEAR | STEP


@dataclass
class NodeGraph:
    """What posing the instances at a time needs: every node's parent
    and rest TRS (or its static ``matrix``), the node of each instance,
    and the file's animation channels (all animations played together)."""

    parents: np.ndarray      # (N,) int64, -1 for a root
    translation: np.ndarray  # (N, 3) f64 rest values
    rotation: np.ndarray     # (N, 4) f64 xyzw
    scale: np.ndarray        # (N, 3) f64
    matrix: np.ndarray       # (N, 4, 4) f64 local matrix of a matrix node
    has_matrix: np.ndarray   # (N,) bool
    instance_node: np.ndarray  # (I,) int64
    channels: List[Channel]


@dataclass
class Scene:
    instances: List[Instance]
    meshes: List[Mesh]
    primitives: List[Primitive]
    materials: np.ndarray  # structured MATERIAL_DTYPE
    textures: List[Texture]
    animation: Optional[NodeGraph] = None  # set when the file animates
    # Why the file's animations are not played (it loads at rest), or "".
    animation_refused: str = ""

    @property
    def triangle_count(self) -> int:
        total = 0
        for inst in self.instances:
            mesh = self.meshes[inst.mesh_index]
            for prim in self.primitives[mesh.start:mesh.end]:
                total += prim.triangle_count
        return total


# --------------------------------------------------------------------------
# Accessor decoding
# --------------------------------------------------------------------------
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


def _read_accessor(gltf: dict, buffers: List[bytes], accessor_index: int) -> np.ndarray:
    """Decode an accessor into a contiguous (count, comps) array."""
    acc = gltf["accessors"][accessor_index]
    if "sparse" in acc:
        raise UnsupportedFile("sparse accessors not supported")
    if "bufferView" not in acc:
        raise NoBufferView()
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    comps = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    elem_size = dtype.itemsize * comps
    stride = view.get("byteStride", elem_size)
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = np.frombuffer(
        buf, dtype=np.uint8, count=stride * (count - 1) + elem_size, offset=offset
    )
    if stride == elem_size:
        out = raw.view(dtype).reshape(count, comps)
    else:
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, elem_size), strides=(stride, 1)
        )
        out = np.ascontiguousarray(strided).view(dtype).reshape(count, comps)
    return out


def _require_attr(attrs: dict, name: str, err) -> int:
    if name not in attrs:
        raise err()
    return attrs[name]


def _load_primitive(gltf: dict, buffers: List[bytes], prim: dict) -> Primitive:
    # mode 4 = TRIANGLES (default when absent).
    if prim.get("mode", 4) != 4:
        raise GltfNotATriangleTopology()
    if "indices" not in prim:
        raise GltfNoIndices()
    attrs = prim.get("attributes", {})
    pos_i = _require_attr(attrs, "POSITION", GltfNoPositions)
    nrm_i = _require_attr(attrs, "NORMAL", GltfNoNormals)
    tan_i = _require_attr(attrs, "TANGENT", GltfNoTangents)
    uv_i = _require_attr(attrs, "TEXCOORD_0", GltfNoTextureCoordinates)
    if "material" not in prim:
        raise NoMaterial()

    idx_acc = gltf["accessors"][prim["indices"]]
    if idx_acc["componentType"] == 5123:
        uint32_indices = False
    elif idx_acc["componentType"] == 5125:
        uint32_indices = True
    else:
        raise InvalidIndexType()

    def typed(acc_index, want, err):
        if gltf["accessors"][acc_index]["type"] != want:
            raise err()
        arr = _read_accessor(gltf, buffers, acc_index)
        if arr.dtype != np.float32:
            raise err()
        return arr.astype(np.float32, copy=False)

    indices = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1)
    positions = typed(pos_i, "VEC3", InvalidPositionType)
    normals = typed(nrm_i, "VEC3", InvalidNormalType)
    tangents = typed(tan_i, "VEC4", InvalidTangentType)
    uvs = typed(uv_i, "VEC2", InvalidTexcoordType)

    return Primitive(
        indices=indices,
        positions=positions,
        normals=normals,
        tangents=tangents,
        uvs=uvs,
        material_index=prim["material"],
        uint32_indices=uint32_indices,
    )


# --------------------------------------------------------------------------
# Texture decode (threaded, Scene.zig:354-446)
# --------------------------------------------------------------------------
def _decode_image(payload: bytes) -> Texture:
    """Force RGBA8 like stbi_load_from_memory(..., 4) — stb_image.zig:3-28."""
    from PIL import Image

    with Image.open(io.BytesIO(payload)) as img:
        rgba = img.convert("RGBA")
        data = np.asarray(rgba, dtype=np.uint8)
    return Texture(data=data, width=data.shape[1], height=data.shape[0])


def _image_payload(gltf: dict, buffers: List[bytes], base_dir: str, image: dict) -> bytes:
    uri = image.get("uri")
    if uri is not None:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(base_dir, uri), "rb") as f:
            return f.read()
    view = gltf["bufferViews"][image["bufferView"]]
    off = view.get("byteOffset", 0)
    return bytes(buffers[view["buffer"]][off:off + view["byteLength"]])


def _load_textures(gltf: dict, buffers: List[bytes], base_dir: str) -> List[Texture]:
    images = gltf.get("images", [])
    gltf_textures = gltf.get("textures", [])
    if not gltf_textures:
        return []
    payloads = [
        _image_payload(gltf, buffers, base_dir, images[t["source"]])
        for t in gltf_textures
    ]
    # Thread pool mirrors Scene.zig:373-394 (min(#textures, cpu count)).
    workers = max(1, min(len(payloads), os.cpu_count() or 1))
    if workers == 1:
        return [_decode_image(p) for p in payloads]
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(_decode_image, payloads))


# --------------------------------------------------------------------------
# Materials (Scene.zig:448-485)
# --------------------------------------------------------------------------
def _load_materials(gltf: dict) -> np.ndarray:
    gltf_materials = gltf.get("materials", [])
    materials = np.zeros(len(gltf_materials), dtype=MATERIAL_DTYPE)
    for i, m in enumerate(gltf_materials):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        rough = pbr.get("roughnessFactor", 1.0)
        metal = pbr.get("metallicFactor", 1.0)
        emissive = m.get("emissiveFactor", [0.0, 0.0, 0.0])

        def tex(entry) -> int:
            return entry["index"] if entry is not None else INVALID_TEXTURE_INDEX

        materials[i] = (
            pack_unorm4x8(base[0], base[1], base[2], 0.0),
            pack_unorm4x8(0.0, rough, metal, 0.0),
            pack_unorm4x8(emissive[0], emissive[1], emissive[2], 0.0),
            tex(pbr.get("baseColorTexture")),
            tex(pbr.get("metallicRoughnessTexture")),
            tex(m.get("emissiveTexture")),
            tex(m.get("normalTexture")),
        )
    return materials


# --------------------------------------------------------------------------
# Node flattening (Scene.zig:487-546)
# --------------------------------------------------------------------------
def _trs_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF stores column-major; numpy reshape order gives M[c][r].
        return np.array(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    t = node.get("translation")
    r = node.get("rotation")  # x, y, z, w
    s = node.get("scale")
    T = np.eye(4)
    if t is not None:
        T[:3, 3] = t
    R = np.eye(4)
    if r is not None:
        x, y, z, w = r
        R[:3, :3] = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
    S = np.eye(4)
    if s is not None:
        S[0, 0], S[1, 1], S[2, 2] = s
    return T @ R @ S if (t is not None or r is not None or s is not None) else m


def _flatten_scene(gltf: dict, quirk_mode: bool) -> List[Instance]:
    scenes = gltf.get("scenes", [])
    if len(scenes) == 0:
        raise NoScene()
    if len(scenes) > 1:
        raise TooManyScenes()
    nodes = gltf.get("nodes", [])
    instances: List[Instance] = []
    stack: List[Tuple[int, np.ndarray]] = []
    for root in scenes[0].get("nodes", []):
        stack.append((root, np.eye(4)))
        while stack:
            index, inherited = stack.pop()
            node = nodes[index]
            if "mesh" in node:
                if quirk_mode:
                    # Reference behavior (Scene.zig:514-532 with
                    # zalgebra's pre-multiplying translate/scale):
                    # S · T · inherited · R, TRS fields only.
                    T = np.eye(4)
                    T[:3, 3] = node.get("translation", [0.0, 0.0, 0.0])
                    R = _trs_matrix({"rotation": node.get("rotation", [0, 0, 0, 1])})
                    S = np.eye(4)
                    sv = node.get("scale", [1.0, 1.0, 1.0])
                    S[0, 0], S[1, 1], S[2, 2] = sv
                    matrix = S @ T @ inherited @ R
                else:
                    matrix = inherited @ _trs_matrix(node)
                instances.append(
                    Instance(
                        mesh_index=node["mesh"],
                        transform=matrix.astype(np.float32),
                        node=index,
                    )
                )
            else:
                # Quirk (Scene.zig:515-532): non-mesh nodes pass their
                # inherited matrix through, ignoring their own TRS.
                matrix = inherited if quirk_mode else inherited @ _trs_matrix(node)
            for child in node.get("children", []):
                stack.append((child, matrix))
    return instances


# --------------------------------------------------------------------------
# Animations (glTF 2.0 section "Animations")
# --------------------------------------------------------------------------
ANIMATED_PATHS = {"translation": 3, "rotation": 4, "scale": 3}
INTERPOLATIONS = ("LINEAR", "STEP")
# Normalized integer outputs (rotation only): value / max, at least -1.
_NORMALIZED = {5120: 127.0, 5121: 255.0, 5122: 32767.0, 5123: 65535.0}


def _animation_output(gltf: dict, buffers: List[bytes], index: int,
                      width: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    raw = _read_accessor(gltf, buffers, index)
    if raw.shape[1] != width:
        raise UnsupportedFile(f"animation output accessor {index}: "
                              f"{acc['type']}, wanted {width} components")
    if raw.dtype == np.float32:
        return raw.astype(np.float32)
    if acc.get("normalized") and acc["componentType"] in _NORMALIZED:
        return np.maximum(raw.astype(np.float64)
                          / _NORMALIZED[acc["componentType"]],
                          -1.0).astype(np.float32)
    raise UnsupportedFile(f"animation output accessor {index}: component "
                          f"type {acc['componentType']}")


def _load_animation(gltf: dict, buffers: List[bytes],
                    instances: List[Instance],
                    quirk_mode: bool) -> Optional[NodeGraph]:
    """The node graph and the animation channels of a file that has
    ``animations``, else None.  Not played, each by a ValueError that
    names it (``load`` keeps its text): ``CUBICSPLINE`` interpolation, morph target ``weights``, skins,
    animation under the reference's flattening quirk, a channel on a node
    with a ``matrix``, and two channels on one node's same path."""
    animations = gltf.get("animations", [])
    if not animations:
        return None
    if quirk_mode:
        raise ValueError("animated glTF: animations are not supported "
                         "under --gltf-quirk-mode (the reference's "
                         "flattening ignores non-mesh nodes' TRS)")
    nodes = gltf.get("nodes", [])
    if gltf.get("skins") or any("skin" in n for n in nodes):
        raise ValueError("animated glTF: skins are not supported")
    channels: List[Channel] = []
    targeted = set()
    for a, anim in enumerate(animations):
        samplers = anim.get("samplers", [])
        for ch in anim.get("channels", []):
            target = ch.get("target", {})
            path = target.get("path")
            if path == "weights":
                raise ValueError(f"animation {a}: morph target weights are "
                                 f"not supported")
            if path not in ANIMATED_PATHS:
                raise ValueError(f"animation {a}: target path {path!r} is "
                                 f"not supported")
            if "node" not in target:
                continue    # the specification: such a channel is ignored
            node = int(target["node"])
            if "matrix" in nodes[node]:
                raise ValueError(f"animation {a}: node {node} has a matrix; "
                                 f"an animated node takes TRS only")
            if (node, path) in targeted:
                raise ValueError(f"animation {a}: a second channel on node "
                                 f"{node}'s {path}")
            targeted.add((node, path))
            sampler = samplers[ch["sampler"]]
            interpolation = sampler.get("interpolation", "LINEAR")
            if interpolation == "CUBICSPLINE":
                raise ValueError(f"animation {a}: CUBICSPLINE interpolation "
                                 f"is not supported")
            if interpolation not in INTERPOLATIONS:
                raise ValueError(f"animation {a}: interpolation "
                                 f"{interpolation!r} is not supported")
            times = _read_accessor(gltf, buffers, sampler["input"])
            if times.dtype != np.float32 or times.shape[1] != 1:
                raise UnsupportedFile(f"animation {a}: input accessor "
                                      f"{sampler['input']} is not f32 "
                                      f"SCALAR")
            times = times.reshape(-1).astype(np.float32)
            values = _animation_output(gltf, buffers, sampler["output"],
                                       ANIMATED_PATHS[path])
            if len(times) == 0 or len(values) != len(times):
                raise UnsupportedFile(f"animation {a}: {len(times)} key "
                                      f"times, {len(values)} values")
            if np.any(np.diff(times) <= 0):
                raise UnsupportedFile(f"animation {a}: key times are not "
                                      f"increasing")
            channels.append(Channel(node, path, times, values,
                                    interpolation))
    n = len(nodes)
    parents = np.full(n, -1, np.int64)
    for i, node in enumerate(nodes):
        for child in node.get("children", []):
            parents[child] = i
    translation = np.zeros((n, 3))
    rotation = np.zeros((n, 4))
    rotation[:, 3] = 1.0
    scale = np.ones((n, 3))
    matrix = np.tile(np.eye(4), (n, 1, 1))
    has_matrix = np.zeros(n, bool)
    for i, node in enumerate(nodes):
        if "matrix" in node:
            matrix[i] = _trs_matrix(node)
            has_matrix[i] = True
        translation[i] = node.get("translation", translation[i])
        rotation[i] = node.get("rotation", rotation[i])
        scale[i] = node.get("scale", scale[i])
    return NodeGraph(parents=parents, translation=translation,
                     rotation=rotation, scale=scale, matrix=matrix,
                     has_matrix=has_matrix,
                     instance_node=np.array([inst.node for inst in instances],
                                            np.int64),
                     channels=channels)


# --------------------------------------------------------------------------
# Top-level load (Scene.zig:79-157)
# --------------------------------------------------------------------------
def _parse_glb(data: bytes) -> Tuple[dict, List[bytes]]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise UnsupportedFile("bad GLB magic")
    if version != 2:
        raise UnsupportedFile(f"unsupported GLB version {version}")
    offset = 12
    gltf_json = None
    binary = b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset:offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            binary = chunk
    if gltf_json is None:
        raise UnsupportedFile("GLB has no JSON chunk")
    return gltf_json, [binary]


def _load_buffers(gltf: dict, base_dir: str, glb_bin: Optional[List[bytes]]):
    buffers: List[bytes] = []
    for i, buf in enumerate(gltf.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise UnsupportedFile("buffer without uri outside GLB")
            buffers.append(glb_bin[0])
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def load(path: str, quirk_mode: bool = False, load_textures: bool = True) -> Scene:
    """Load a .glb or .gltf scene with the reference's contract."""
    base_dir = os.path.dirname(os.path.abspath(path))
    ext = os.path.splitext(path)[1].lower()
    if ext == ".glb":
        with open(path, "rb") as f:
            gltf, glb_bin = _parse_glb(f.read())
        buffers = _load_buffers(gltf, base_dir, glb_bin)
    elif ext == ".gltf":
        with open(path, "r", encoding="utf-8") as f:
            gltf = json.load(f)
        buffers = _load_buffers(gltf, base_dir, None)
    else:
        raise UnsupportedFile(f"unsupported extension: {ext}")

    meshes: List[Mesh] = []
    primitives: List[Primitive] = []
    for gltf_mesh in gltf.get("meshes", []):
        start = len(primitives)
        for prim in gltf_mesh.get("primitives", []):
            primitives.append(_load_primitive(gltf, buffers, prim))
        meshes.append(Mesh(start=start, end=len(primitives)))

    textures = _load_textures(gltf, buffers, base_dir) if load_textures else []
    materials = _load_materials(gltf)
    instances = _flatten_scene(gltf, quirk_mode)
    try:
        animation, refused = _load_animation(gltf, buffers, instances,
                                             quirk_mode), ""
    except (ValueError, GltfError) as exc:
        animation, refused = None, f"{os.path.basename(path)}: {exc}"
    return Scene(
        instances=instances,
        meshes=meshes,
        primitives=primitives,
        materials=materials,
        textures=textures,
        animation=animation,
        animation_refused=refused,
    )
