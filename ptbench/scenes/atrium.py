"""The benchmark's scene: a frozen copy of the procedural atrium.

``make_atrium`` writes the Sponza-class atrium as a binary glTF: an
enclosed two-story courtyard of paneled floors, walls and ceiling, two
colonnade levels, a balustrade and props, lit only by the sky through a
central opening; at ``detail=4.1`` it has 246,444 triangles in 32
materials, one mesh per material, every node at the identity.  This is
a copy of the repository's generator (``assets/procedural.py``: the
mesh building blocks, the GLB writer and ``make_atrium``), NumPy only,
kept here so that a change to the program or its assets cannot change
the benchmark's input: the same ``detail`` always writes the same bytes.
"""

from __future__ import annotations

import json
import math
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class PrimData:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    tangents: np.ndarray   # (V, 4) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (3T,) uint32 (narrowed to u16 when possible)
    material: int = 0


@dataclass
class MaterialDesc:
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 1.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    base_color_texture: Optional[int] = None
    metallic_roughness_texture: Optional[int] = None
    emissive_texture: Optional[int] = None
    normal_texture: Optional[int] = None


@dataclass
class NodeDesc:
    mesh: Optional[int] = None
    translation: Optional[Tuple[float, float, float]] = None
    rotation: Optional[Tuple[float, float, float, float]] = None  # xyzw
    scale: Optional[Tuple[float, float, float]] = None
    children: List[int] = field(default_factory=list)


def _quad(p0, p1, p2, p3, material: int) -> PrimData:
    """Two CCW triangles for the quad p0->p1->p2->p3 (viewed from the
    front face, i.e. the side the normal points to)."""
    p0, p1, p2, p3 = (np.asarray(p, dtype=np.float32) for p in (p0, p1, p2, p3))
    normal = np.cross(p1 - p0, p3 - p0)
    normal = normal / np.linalg.norm(normal)
    tangent = p1 - p0
    tangent = tangent / np.linalg.norm(tangent)
    positions = np.stack([p0, p1, p2, p3])
    normals = np.tile(normal.astype(np.float32), (4, 1))
    tangents = np.concatenate(
        [np.tile(tangent.astype(np.float32), (4, 1)), np.ones((4, 1), np.float32)],
        axis=1,
    )
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], dtype=np.uint32)
    return PrimData(positions, normals, tangents, uvs, indices, material)


def merge_prims(prims: List[PrimData], material: Optional[int] = None) -> PrimData:
    base = 0
    pos, nrm, tan, uv, idx = [], [], [], [], []
    for p in prims:
        pos.append(p.positions)
        nrm.append(p.normals)
        tan.append(p.tangents)
        uv.append(p.uvs)
        idx.append(p.indices + base)
        base += p.positions.shape[0]
    return PrimData(
        np.concatenate(pos), np.concatenate(nrm), np.concatenate(tan),
        np.concatenate(uv), np.concatenate(idx),
        material if material is not None else prims[0].material,
    )


def box_prim(center, size, material: int, inward: bool = False) -> PrimData:
    """Axis-aligned box; ``inward=True`` flips faces for interiors."""
    cx, cy, cz = center
    hx, hy, hz = (s * 0.5 for s in size)
    x0, x1 = cx - hx, cx + hx
    y0, y1 = cy - hy, cy + hy
    z0, z1 = cz - hz, cz + hz
    faces = [
        # +z
        ((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
        # -z
        ((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)),
        # +x
        ((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)),
        # -x
        ((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)),
        # +y
        ((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)),
        # -y
        ((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
    ]
    quads = []
    for q in faces:
        if inward:
            q = (q[1], q[0], q[3], q[2])  # reverse winding, flip normal
        quads.append(_quad(*q, material=material))
    return merge_prims(quads, material)



# --------------------------------------------------------------------------
# GLB writer
# --------------------------------------------------------------------------
def write_glb(path: str, meshes: List[List[PrimData]],
              materials: List[MaterialDesc],
              nodes: Optional[List[NodeDesc]] = None,
              textures: Optional[List[bytes]] = None) -> None:
    """meshes: list of meshes, each a list of primitives."""
    textures = textures or []
    if nodes is None:
        nodes = [NodeDesc(mesh=i) for i in range(len(meshes))]

    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []

    def _align(n: int = 4):
        total = sum(len(p) for p in bin_parts)
        pad = (-total) % n
        if pad:
            bin_parts.append(b"\x00" * pad)

    def add_view(data: bytes, target: Optional[int] = None) -> int:
        _align(4)
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(data)
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, type_: str, component: int,
                     target: int, minmax: bool = False) -> int:
        view = add_view(arr.tobytes(), target)
        acc = {
            "bufferView": view,
            "componentType": component,
            "count": arr.shape[0],
            "type": type_,
        }
        if minmax:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    gltf_meshes = []
    for prims in meshes:
        out_prims = []
        for p in prims:
            if p.positions.shape[0] <= 0xFFFF:
                idx = p.indices.astype(np.uint16)
                comp = 5123
            else:
                idx = p.indices.astype(np.uint32)
                comp = 5125
            prim = {
                "mode": 4,
                "material": p.material,
                "indices": add_accessor(idx.reshape(-1, 1), "SCALAR", comp, 34963),
                "attributes": {
                    "POSITION": add_accessor(
                        p.positions.astype(np.float32), "VEC3", 5126, 34962,
                        minmax=True,
                    ),
                    "NORMAL": add_accessor(
                        p.normals.astype(np.float32), "VEC3", 5126, 34962
                    ),
                    "TANGENT": add_accessor(
                        p.tangents.astype(np.float32), "VEC4", 5126, 34962
                    ),
                    "TEXCOORD_0": add_accessor(
                        p.uvs.astype(np.float32), "VEC2", 5126, 34962
                    ),
                },
            }
            out_prims.append(prim)
        gltf_meshes.append({"primitives": out_prims})

    gltf_images = []
    gltf_textures = []
    for png in textures:
        view = add_view(png)
        gltf_images.append({"bufferView": view, "mimeType": "image/png"})
        gltf_textures.append({"source": len(gltf_images) - 1, "sampler": 0})

    gltf_materials = []
    for m in materials:
        pbr = {
            "baseColorFactor": list(m.base_color),
            "metallicFactor": m.metallic,
            "roughnessFactor": m.roughness,
        }
        if m.base_color_texture is not None:
            pbr["baseColorTexture"] = {"index": m.base_color_texture}
        if m.metallic_roughness_texture is not None:
            pbr["metallicRoughnessTexture"] = {"index": m.metallic_roughness_texture}
        mat = {"pbrMetallicRoughness": pbr, "emissiveFactor": list(m.emissive)}
        if m.emissive_texture is not None:
            mat["emissiveTexture"] = {"index": m.emissive_texture}
        if m.normal_texture is not None:
            mat["normalTexture"] = {"index": m.normal_texture}
        gltf_materials.append(mat)

    gltf_nodes = []
    root_nodes = set(range(len(nodes)))
    for nd in nodes:
        node = {}
        if nd.mesh is not None:
            node["mesh"] = nd.mesh
        if nd.translation is not None:
            node["translation"] = list(nd.translation)
        if nd.rotation is not None:
            node["rotation"] = list(nd.rotation)
        if nd.scale is not None:
            node["scale"] = list(nd.scale)
        if nd.children:
            node["children"] = nd.children
            root_nodes -= set(nd.children)
        gltf_nodes.append(node)

    _align(4)
    binary = b"".join(bin_parts)

    gltf = {
        "asset": {"version": "2.0", "generator": "vulkan_pathtracer_tpu"},
        "scene": 0,
        "scenes": [{"nodes": sorted(root_nodes)}],
        "nodes": gltf_nodes,
        "meshes": gltf_meshes,
        "materials": gltf_materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(binary)}],
        "samplers": [{"magFilter": 9729, "minFilter": 9729,
                      "wrapS": 10497, "wrapT": 10497}],
    }
    if gltf_images:
        gltf["images"] = gltf_images
        gltf["textures"] = gltf_textures

    json_bytes = json.dumps(gltf, separators=(",", ":")).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(binary), 0x004E4942))
        f.write(binary)



def _panel_field(origin, du, dv, nu: int, nv: int, thickness: float,
                 normal_axis: int, normal_sign: float, mat_fn,
                 jitter: float = 0.0, rng=None) -> List[PrimData]:
    """Grid of nu x nv thin boxes tiling the rectangle origin + u*du +
    v*dv (du/dv are FULL edge vectors).  Each panel is extruded
    ``thickness`` along ``normal_axis`` (sign ``normal_sign``) with an
    optional random depth jitter — cheap Sponza-like relief detail."""
    origin = np.asarray(origin, np.float64)
    du = np.asarray(du, np.float64) / nu
    dv = np.asarray(dv, np.float64) / nv
    out = []
    for i in range(nu):
        for j in range(nv):
            c = origin + du * (i + 0.5) + dv * (j + 0.5)
            t = thickness * (1.0 + (rng.uniform(0, jitter) if jitter else 0))
            size = np.abs(du) * 0.94 + np.abs(dv) * 0.94
            size[normal_axis] = t
            center = c.copy()
            center[normal_axis] += normal_sign * t * 0.5
            out.append(box_prim(tuple(center), tuple(size), mat_fn(i, j)))
    return out


def make_atrium(path: str, detail: float = 1.0, n_materials: int = 32,
                mixed: bool = False) -> None:
    """config[2]: Sponza-class stand-in — an ENCLOSED two-story atrium
    (Sponza is an interior courtyard, not an open field): paneled
    floor/walls/ceiling with relief jitter, two colonnade levels
    around the court, a balustrade, scattered props, and a central
    ceiling opening that admits the sky (the only light, like the
    reference's sky-lit Sponza renders).  ``detail`` scales panel
    subdivision: detail=1.0 ~ 260k triangles (Sponza is ~262k).

    Interior-bench note: place the camera INSIDE (|x|<9, |z|<5,
    0.5<y<9); bench.py uses an interior orbit for BENCH_SCENE=atrium.

    ``mixed=True``: non-uniform tessellation like real Sponza —
    floors/walls/ceiling become LARGE panels (few huge triangles)
    while columns/props keep the ``detail`` tessellation.  Large
    polygons inflate BVH node overlap, which is exactly what triangle
    pre-splitting (VKPT_PRESPLIT) exists to fix; the uniform variant
    measured presplit as a no-op.
    """
    rng = np.random.default_rng(7)
    X, Z, H = 24.0, 14.0, 10.0   # hall half-extents 12 x 7, height 10
    hx, hz = X / 2, Z / 2
    materials = [
        MaterialDesc(
            base_color=tuple(rng.uniform(0.25, 0.8, size=3)) + (1.0,),
            metallic=float(rng.uniform(0.0, 0.3)),
            roughness=float(rng.uniform(0.3, 0.95)),
        )
        for _ in range(n_materials)
    ]

    def mat(i, j):
        return (i * 7 + j * 13) % n_materials

    s = math.sqrt(max(detail, 0.05))
    sp = 0.18 if mixed else s  # panel-field tessellation scale
    prims: List[PrimData] = []
    # Floor / ceiling panel fields (ceiling leaves a central opening).
    fnu, fnv = max(int(44 * sp), 3), max(int(26 * sp), 3)
    prims += _panel_field((-hx, 0, -hz), (X, 0, 0), (0, 0, Z), fnu, fnv,
                          0.06, 1, 1.0, mat, jitter=0.5, rng=rng)
    cnu, cnv = max(int(44 * sp), 5), max(int(26 * sp), 5)
    # Large central opening, like Sponza's court open to the sky.
    open_u = (0.2, 0.8)
    open_v = (0.16, 0.84)
    ceil = _panel_field((-hx, H, -hz), (X, 0, 0), (0, 0, Z), cnu, cnv,
                        0.06, 1, -1.0, mat, jitter=0.5, rng=rng)
    kept = []
    for idx, p in enumerate(ceil):
        i = idx // cnv
        j = idx % cnv
        if (open_u[0] < (i + 0.5) / cnu < open_u[1]
                and open_v[0] < (j + 0.5) / cnv < open_v[1]):
            continue
        kept.append(p)
    prims += kept
    # Walls (inward-extruded panels).
    wn_h = max(int(40 * sp), 3)
    wn_v = max(int(18 * sp), 3)
    prims += _panel_field((-hx, 0, -hz), (X, 0, 0), (0, H, 0), wn_h, wn_v,
                          0.08, 2, 1.0, mat, jitter=0.6, rng=rng)
    prims += _panel_field((-hx, 0, hz), (X, 0, 0), (0, H, 0), wn_h, wn_v,
                          0.08, 2, -1.0, mat, jitter=0.6, rng=rng)
    wn_h2 = max(int(24 * sp), 3)
    prims += _panel_field((-hx, 0, -hz), (0, 0, Z), (0, H, 0), wn_h2, wn_v,
                          0.08, 0, 1.0, mat, jitter=0.6, rng=rng)
    prims += _panel_field((hx, 0, -hz), (0, 0, Z), (0, H, 0), wn_h2, wn_v,
                          0.08, 0, -1.0, mat, jitter=0.6, rng=rng)

    # Two colonnade levels around the court ring.
    ring_x, ring_z = hx - 2.2, hz - 2.2
    seg = max(int(16 * s), 6)
    col_step = 1.6
    levels = [(0.0, 4.6), (5.0, 4.2)]
    xs = np.arange(-ring_x, ring_x + 1e-6, col_step)
    zs = np.arange(-ring_z, ring_z + 1e-6, col_step)
    positions = [(x, -ring_z) for x in xs] + [(x, ring_z) for x in xs] \
        + [(-ring_x, z) for z in zs[1:-1]] + [(ring_x, z) for z in zs[1:-1]]
    for ci, (cx, cz) in enumerate(positions):
        for li, (y0, ch) in enumerate(levels):
            parts = []
            for k in range(seg):
                r = 0.22 + 0.06 * math.sin(k * 1.3 + ci)
                parts.append(box_prim(
                    (cx, y0 + (k + 0.5) * ch / seg, cz),
                    (r, ch / seg, r), (ci + k + li) % n_materials))
            parts.append(box_prim((cx, y0 + ch + 0.1, cz),
                                  (0.5, 0.2, 0.5), ci % n_materials))
            prims += parts
    # Balustrade posts on level 2.
    post_step = 0.4
    xs2 = np.arange(-ring_x, ring_x + 1e-6, post_step)
    zs2 = np.arange(-ring_z, ring_z + 1e-6, post_step)
    ring2 = [(x, -ring_z) for x in xs2] + [(x, ring_z) for x in xs2] \
        + [(-ring_x, z) for z in zs2[1:-1]] + [(ring_x, z) for z in zs2[1:-1]]
    for pi, (px, pz) in enumerate(ring2):
        prims.append(box_prim((px, 5.0 + 0.35, pz), (0.08, 0.7, 0.08),
                              (pi * 3) % n_materials))
    # Level-2 walkway slabs between the colonnade ring and the walls.
    wnu = max(int(30 * sp), 3)
    prims += _panel_field((-hx, 4.9, -hz), (X, 0, 0), (0, 0, 2.2 - 0.1),
                          wnu, max(int(4 * s), 2), 0.1, 1, 1.0, mat,
                          rng=rng)
    prims += _panel_field((-hx, 4.9, hz - 2.1), (X, 0, 0), (0, 0, 2.0),
                          wnu, max(int(4 * s), 2), 0.1, 1, 1.0, mat,
                          rng=rng)
    # Floor props (crates/urns) in the court.
    n_props = int(120 * detail)
    for pi in range(n_props):
        px = rng.uniform(-ring_x + 1, ring_x - 1)
        pz = rng.uniform(-ring_z + 1, ring_z - 1)
        w = rng.uniform(0.25, 0.8)
        h = rng.uniform(0.25, 1.2)
        prims.append(box_prim((px, h / 2 + 0.08, pz), (w, h, w),
                              int(rng.integers(0, n_materials))))

    # Group prims into meshes by material (multi-primitive meshes).
    by_mat: dict = {}
    for p in prims:
        by_mat.setdefault(p.material, []).append(p)
    meshes = [[merge_prims(ps, m)] for m, ps in sorted(by_mat.items())]
    nodes = [NodeDesc(mesh=i) for i in range(len(meshes))]
    write_glb(path, meshes=meshes, materials=materials, nodes=nodes)


def make(path: str, detail: float, n_materials: int) -> None:
    """The benchmark's entry point: ``make_atrium`` at ``detail``."""
    make_atrium(path, detail=detail, n_materials=n_materials)
