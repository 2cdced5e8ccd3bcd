"""Device scene: the tensors the renderer reads, on one ``torch.device``.

Port of the FLAT path of ``vulkan_pathtracer_tpu/models/device_scene.py``
(``build_device_scene`` and ``bvh_with_leaf_blocks``): instance
transforms are baked at load time into one world-space triangle soup,
a binned-SAH BVH is built over it (``native/sah.cpp`` through the
port's ``ops/bvh.py`` and ``ops/native.py``), its leaves are rewritten
to fixed-size blocks, and the tables the renderer reads are uploaded:

- triangle SoA ``tri_v0/e1/e2/gn`` (T, 3) and ``tri_material`` (T,),
  padded to a multiple of 128 with degenerate triangles;
- ``tri_attr`` (T, 34) f32: the three vertex normals, tangents and
  uvs, the geometric normal and the material/primitive/local ids
  (bit-cast int32), exactly the JAX package's packed shading row;
- ``mat_packed`` (M, 8): factors and texture table per material, as
  int64 holding the uint32 words;
- the texel pool (P, 4) uint8 with offset/width/height tables;
- the traversal tables ``quad_box`` / ``quad_link`` and ``pair_box`` /
  ``pair_link`` (the default tiers of flat scenes: the BVH2 table for
  primaries at leaf <= 14, the quad table otherwise), the opt-in
  ``oct_box`` / ``oct_link`` (8-wide) and ``frontier_box`` /
  ``frontier_link`` (16- or 32-wide, guard-dilated; ops/frontier.py),
  the leaf table ``leaves`` (ops/stack_traverse.py describes the
  layouts) and, baked under ``mt="mxu"`` only, the coefficient table
  ``tri_coefs`` (ops/mxu_mt.py), as the JAX bake does
  (device_scene.py:667-678, :705-727);
- the skip-pointer node record ``skip_nodes`` (8 direction-octant
  preorders of the same tree, ``--traversal pallas_packet`` and
  ``bvh``) and, when asked for (``wide=True``, ``--traversal
  pallas8``), the 8-wide slot tiles ``wide_nodes`` (layouts in
  csrc/skip_traverse.cu and ops/bvh_wide.py);
- the root bounds, ``emissive_free``, ``bvh_depth``.

``build_bvh=False`` (``--traversal brute``) bakes the triangles only:
no traversal table, ``has_bvh`` False, as for a scene without
triangles; such scenes take brute force.

Two-level scenes (``instanced``; models/instanced_scene.py) share this
class: object-space triangles, pair tables only, and the instance
tables ``inst_inv`` / ``inst_nrm`` (and ``inst_feat`` under
``mt="mxu"``).

``scene_from_jax_arrays`` builds the same scene from the arrays of a
JAX ``DeviceScene``, flat or instanced, so a test can trace one scene
in both packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models.gltf import (
    INVALID_TEXTURE_INDEX,
    MATERIAL_DTYPE,
    Scene,
)
from vulkan_pathtracer_tpu_torch.ops.bvh import (
    build_bvh_host,
    octant_orders,
    pad_leaves_to_blocks,
    presplit_triangle_refs,
    tree_depth,
)
from vulkan_pathtracer_tpu_torch.ops.bvh_wide import build_wide_bvh
from vulkan_pathtracer_tpu_torch.ops.frontier import (
    build_frontier_tables,
    tables_from_jax,
)
from vulkan_pathtracer_tpu_torch.ops.mxu_mt import (
    build_mt_coef_rows,
    coef_rows_from_jax,
    feature_maps_from_jax,
)
from vulkan_pathtracer_tpu_torch.ops.native import (
    bake_triangles_native,
    transform_dirs_native,
)
from vulkan_pathtracer_tpu_torch.ops.refit import TreeMaps
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import (
    EMPTY,
    build_oct_tables,
    build_pair_tables,
    build_quad_tables,
    nary_tables_from_jax,
)
from vulkan_pathtracer_tpu_torch.utils.config import FRONTIER_WIDTH

PAD = 128


@dataclass
class DeviceScene:
    tri_v0: torch.Tensor        # (T, 3) f32
    tri_e1: torch.Tensor        # (T, 3) f32  v1 - v0
    tri_e2: torch.Tensor        # (T, 3) f32  v2 - v0
    tri_gn: torch.Tensor        # (T, 3) f32  baked geometric normal
    tri_material: torch.Tensor  # (T,) int32
    tri_attr: torch.Tensor      # (T, 34) f32 packed shading row
    mat_packed: torch.Tensor    # (M, 8) int64 (uint32 words)
    tex_texels: torch.Tensor    # (P, 4) uint8, texture 0 = 1x1 white
    tex_offset: torch.Tensor    # (NT,) int32
    tex_width: torch.Tensor     # (NT,) int32
    tex_height: torch.Tensor    # (NT,) int32
    leaves: torch.Tensor        # (n_leaves, block, 9) f32
    root_lo: torch.Tensor       # (3,) f32 root AABB (world)
    root_hi: torch.Tensor       # (3,) f32
    quad_box: Optional[torch.Tensor] = None   # (N4, 4, 6) f32, flat only
    quad_link: Optional[torch.Tensor] = None  # (N4, 4) int32
    pair_box: Optional[torch.Tensor] = None   # (Ni, 2, 6) f32
    pair_link: Optional[torch.Tensor] = None  # (Ni, 2) int32
    oct_box: Optional[torch.Tensor] = None    # (N8, 8, 6) f32, flat only
    oct_link: Optional[torch.Tensor] = None   # (N8, 8) int32
    frontier_box: Optional[torch.Tensor] = None   # (Nw, W, 6) f32, flat
    frontier_link: Optional[torch.Tensor] = None  # (Nw, W) int32
    # Coefficient leaves (mt="mxu"): (n_leaves, block, 20) f32 zero-free
    # rows; two-level scenes add the (I, 40) feature transforms.
    tri_coefs: Optional[torch.Tensor] = None
    inst_feat: Optional[torch.Tensor] = None
    # Two-level scenes (models/instanced_scene.py): leaf values pack
    # inst << mb_bits | mesh block, triangles are object space.
    inst_inv: Optional[torch.Tensor] = None   # (I, 16) invA | inv t | det sign
    inst_nrm: Optional[torch.Tensor] = None   # (I, 9) normal matrix inv(A)
    # Static maps of update_instance_transforms (InstanceMaps).
    inst_maps: Optional[object] = None
    # Build-order tree and static maps of a flat scene (TreeMaps).
    tree: Optional[TreeMaps] = None
    # 8 octant preorders of the binary tree, each Nn records of
    # bmin | bmax | skip | leaf (skip and leaf int32 bits).
    skip_nodes: Optional[torch.Tensor] = None  # (8*Nn, 8) f32
    wide_nodes: Optional[torch.Tensor] = None  # (8*Nw, 8, 8) f32 tiles
    num_triangles: int = 0      # un-padded triangle count
    max_leaf_size: int = 4      # leaf block size
    bvh_depth: int = 0          # binary tree depth (root = 1)
    has_textures: bool = False  # texel pool beyond the dummy
    # Every material's emissive factor is zero, so last-bounce radiance
    # is only the sky/miss decision and the renderer may use any hit.
    emissive_free: bool = False
    instanced: bool = False
    mb_bits: int = 0            # leaf-value mesh-block field width
    wide_seconds: float = 0.0   # host seconds of the wide-tile bake

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device

    @property
    def has_bvh(self) -> bool:
        return self.skip_nodes is not None


def _pad_rows(arr: np.ndarray, multiple: int, fill=0.0) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


def _bake_instance(scene: Scene, inst, acc: dict, vert_base: int) -> int:
    """Append one instance's triangles/vertices in world space
    (device_scene._bake_instance, through the native library)."""
    M = inst.transform.astype(np.float64)
    A = M[:3, :3]
    t = M[:3, 3]
    N = np.linalg.inv(A)  # triangle.glsl:79 row-vector normal matrix
    mesh = scene.meshes[inst.mesh_index]
    for prim_global in range(mesh.start, mesh.end):
        prim = scene.primitives[prim_global]
        nrm_w = transform_dirs_native(prim.normals, N)
        tan_w = prim.tangents.copy()
        tan_w[:, :3] = transform_dirs_native(prim.tangents[:, :3], N)

        idx = prim.indices.reshape(-1, 3).astype(np.int64)
        v0, e1, e2, gn = bake_triangles_native(prim.positions, idx, A, t, N)

        tcount = idx.shape[0]
        acc["tri_v0"].append(v0)
        acc["tri_e1"].append(e1)
        acc["tri_e2"].append(e2)
        acc["tri_gn"].append(gn)
        acc["tri_index"].append((idx + vert_base).astype(np.int32))
        acc["tri_material"].append(
            np.full(tcount, prim.material_index, dtype=np.int32))
        acc["tri_primitive"].append(
            np.full(tcount, prim_global, dtype=np.int32))
        acc["tri_local"].append(np.arange(tcount, dtype=np.int32))
        acc["vert_normal"].append(nrm_w)
        acc["vert_tangent"].append(tan_w)
        acc["vert_uv"].append(prim.uvs)
        vert_base += prim.positions.shape[0]
    return vert_base


def bvh_with_leaf_blocks(tri_v0, tri_e1, tri_e2, max_leaf_size: int,
                         presplit: float = 0.0):
    """Build the BVH and rewrite its leaves to fixed-size blocks.
    Returns (bvh, slot_map): slot_map (T',) maps leaf-block triangle
    slots to original triangle indices, -1 for padding.

    ``presplit`` > 0 on at least 1024 triangles pre-splits them with
    that budget factor (ops/bvh.presplit_triangle_refs): the SAH build
    sees the clipped reference boxes as degenerate box-spanning
    "triangles" (v0 = lo, e1 = e2 = hi - lo), and slot_map composes
    reference -> triangle, so a split triangle fills several slots
    (device_scene.py:304-343 of the JAX package)."""
    order = None
    if presplit > 0.0 and tri_v0.shape[0] >= 1024:
        lo, hi, order = presplit_triangle_refs(tri_v0, tri_e1, tri_e2,
                                               budget_factor=presplit)
        tri_v0, tri_e1, tri_e2 = lo, hi - lo, hi - lo
    bvh = build_bvh_host(tri_v0, tri_e1, tri_e2, max_leaf_size=max_leaf_size)
    gmap = pad_leaves_to_blocks(bvh, block=max_leaf_size)
    order = bvh.tri_order if order is None else order[bvh.tri_order]
    slot_map = np.where(gmap >= 0, order[np.maximum(gmap, 0)], -1)
    return bvh, slot_map


def apply_slot_map(arr: np.ndarray, slot_map: np.ndarray) -> np.ndarray:
    out = arr[np.maximum(slot_map, 0)]
    out[slot_map < 0] = 0
    return out


def _empty_tree(block: int):
    """Traversal tables of a scene without triangles: one row of empty
    slots, so every ray misses."""
    return (np.zeros((1, 4, 6), np.float32),
            np.full((1, 4), EMPTY, np.int32),
            np.zeros((1, block, 9), np.float32),
            np.zeros(3, np.float32), np.zeros(3, np.float32))


def skip_records(bmin, bmax, skip_local, leaf) -> np.ndarray:
    """(M, 8) f32 node records bmin | bmax | skip | leaf, the last two
    int32 bit patterns: the JAX package's ``bvh_packed``
    (device_scene.py:639-646)."""
    tail = np.stack([np.asarray(skip_local, np.int32).view(np.float32),
                     np.asarray(leaf, np.int32).view(np.float32)], axis=1)
    return np.concatenate([bmin, bmax, tail], axis=1).astype(np.float32)


def flat_skip_nodes(bvh):
    """(records, perm): the 8 octant preorders of a flat tree as one
    (8*Nn, 8) record table (device_scene.py:602-646; skips local to
    their octant block, leaves the block-aligned first triangle or -1)
    and the (8*Nn,) build-order node of each record."""
    skip8, lf8, _, perm8 = octant_orders(bvh)
    perm = perm8.reshape(-1)
    return skip_records(bvh.bmin[perm], bvh.bmax[perm], skip8.reshape(-1),
                        lf8.reshape(-1)), perm


def _block_count(leaf_first, leaf_count, block: int, n_blocks: int):
    """(n_blocks,) triangles of each leaf block of a build-order tree."""
    leaf = leaf_first >= 0
    out = np.zeros(n_blocks, np.int64)
    out[leaf_first[leaf] // block] = leaf_count[leaf]
    return out


def tree_maps(bvh, block: int, perm, src: dict, device) -> TreeMaps:
    """The TreeMaps of a host BVH whose leaves are block-aligned, with
    the src maps of its tables as their builders return them
    (``pair_src``, ``quad_src``, ``oct_src``, ``frontier_src``)."""
    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(
            device)

    n_blocks = int(bvh.leaf_first.max()) // block + 1
    return TreeMaps(
        left=up(bvh.left_child), right=up(bvh.right_child),
        leaf_first=up(bvh.leaf_first), leaf_count=up(bvh.leaf_count),
        block_count=up(_block_count(bvh.leaf_first, bvh.leaf_count, block,
                                    n_blocks)),
        perm=up(perm), **{k: up(v) for k, v in src.items()})


def _to_device(host: dict, meta: dict, device) -> DeviceScene:
    """Upload the host arrays (None stays None) and build the scene."""
    dev = torch.device(device)
    tensors = {k: None if v is None else
               torch.from_numpy(np.array(v, order="C")).to(dev)
               for k, v in host.items()}
    return DeviceScene(**tensors, **meta)


def pack_materials(scene: Scene) -> dict:
    """Material rows and the texel pool (device_scene.py's packed
    material path): ``mat_packed``, ``tex_*`` and the host flags
    ``has_textures`` / ``emissive_free``."""
    mats = scene.materials
    if len(mats) == 0:
        mats = np.zeros(1, dtype=MATERIAL_DTYPE)
        mats["albedo_factor"] = 0x00FFFFFF
        mats["metal_roughness_factor"] = 0x00FFFF00
        for f in ("albedo_texture_index", "metal_roughness_texture_index",
                  "emissive_texture_index", "normal_texture_index"):
            mats[f] = INVALID_TEXTURE_INDEX

    def remap(field):
        raw = mats[field].astype(np.int64)
        return np.where(raw == INVALID_TEXTURE_INDEX, 0, raw + 1)

    has_nrm = (mats["normal_texture_index"].astype(np.int64)
               != INVALID_TEXTURE_INDEX)
    mat_packed = np.stack([
        mats["albedo_factor"].astype(np.int64),
        mats["metal_roughness_factor"].astype(np.int64),
        mats["emissive_factor"].astype(np.int64),
        remap("albedo_texture_index"),
        remap("metal_roughness_texture_index"),
        remap("emissive_texture_index"),
        remap("normal_texture_index"),
        has_nrm.astype(np.int64),
    ], axis=1)

    texels = [np.full((1, 4), 255, dtype=np.uint8)]
    offsets, widths, heights = [0], [1], [1]
    cursor = 1
    for tex in scene.textures:
        flat = tex.data.reshape(-1, 4)
        texels.append(flat)
        offsets.append(cursor)
        widths.append(tex.width)
        heights.append(tex.height)
        cursor += flat.shape[0]
    return dict(
        mat_packed=mat_packed, tex_texels=np.concatenate(texels),
        tex_offset=np.asarray(offsets, np.int32),
        tex_width=np.asarray(widths, np.int32),
        tex_height=np.asarray(heights, np.int32),
        has_textures=len(scene.textures) > 0,
        # Emissive rgb is the low 3 bytes of the packed factor; a zero
        # factor zeroes the texture product too.
        emissive_free=bool(
            ((mats["emissive_factor"].astype(np.int64) & 0x00FFFFFF) == 0)
            .all()),
    )


def attr_rows(tri: dict, vert_normal, vert_tangent, vert_uv) -> np.ndarray:
    """(T, 34) packed shading rows: the three vertex normals, tangents
    and uvs, the geometric normal and the material/primitive/local ids
    (bit-cast int32)."""
    idx = tri["tri_index"]
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    gn = tri["tri_gn"]
    return np.concatenate([
        vert_normal[i0], vert_normal[i1], vert_normal[i2],      # 0:9
        vert_tangent[i0], vert_tangent[i1], vert_tangent[i2],   # 9:21
        vert_uv[i0], vert_uv[i1], vert_uv[i2],                  # 21:27
        gn,                                                     # 27:30
        np.ascontiguousarray(tri["tri_material"]).view(np.float32)[:, None],
        np.ascontiguousarray(tri["tri_primitive"]).view(np.float32)[:, None],
        np.ascontiguousarray(tri["tri_local"]).view(np.float32)[:, None],
        np.zeros((gn.shape[0], 1), np.float32),                 # pad: 34
    ], axis=1).astype(np.float32)


def build_device_scene(scene: Scene, max_leaf_size: int = 4,
                       device="cuda", build_bvh: bool = True,
                       wide: bool = False, mt: str = "exact",
                       frontier_width: int = FRONTIER_WIDTH,
                       presplit: float = 0.0) -> DeviceScene:
    """Bake a host Scene into device tensors with a BVH of
    ``max_leaf_size``-triangle leaf blocks (none with ``build_bvh=False``;
    the 8-wide tiles too with ``wide=True``; the coefficient table too
    with ``mt="mxu"``; the frontier tables at ``frontier_width``; the
    triangles pre-split with budget ``presplit`` when > 0, see
    bvh_with_leaf_blocks).  The wide bake is a Python loop; its seconds
    are in ``scene.wide_seconds``.  The scene carries the tree's
    TreeMaps (``scene.tree``), which ops/refit.py regenerates from."""
    return bake_flat(scene, max_leaf_size, device, build_bvh, wide, mt,
                     frontier_width, presplit)[0]


def bake_flat(scene: Scene, max_leaf_size: int, device, build_bvh: bool,
              wide: bool, mt: str, frontier_width: int, presplit: float):
    """(DeviceScene, slot_map) of build_device_scene: slot_map maps
    each triangle slot before the padding to its triangle in bake order
    (-1: a padded slot; None without a BVH)."""
    acc = {k: [] for k in (
        "tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_index", "tri_material",
        "tri_primitive", "tri_local", "vert_normal", "vert_tangent",
        "vert_uv",
    )}
    vert_base = 0
    for inst in scene.instances:
        vert_base = _bake_instance(scene, inst, acc, vert_base)

    def cat(key, dtype, cols):
        if acc[key]:
            arr = np.concatenate(acc[key]).astype(dtype)
            return arr.reshape(-1, cols) if cols > 1 else arr
        return np.zeros((0, cols) if cols > 1 else (0,), dtype=dtype)

    tri_v0 = cat("tri_v0", np.float32, 3)
    tri_e1 = cat("tri_e1", np.float32, 3)
    tri_e2 = cat("tri_e2", np.float32, 3)
    tri_gn = cat("tri_gn", np.float32, 3)
    tri_index = cat("tri_index", np.int32, 3)
    tri_material = cat("tri_material", np.int32, 1)
    tri_primitive = cat("tri_primitive", np.int32, 1)
    tri_local = cat("tri_local", np.int32, 1)
    vert_normal = cat("vert_normal", np.float32, 3)
    vert_tangent = cat("vert_tangent", np.float32, 4)
    vert_uv = cat("vert_uv", np.float32, 2)
    num_triangles = tri_v0.shape[0]

    bvh = slot_map = None
    if num_triangles > 0 and build_bvh:
        bvh, slot_map = bvh_with_leaf_blocks(tri_v0, tri_e1, tri_e2,
                                             max_leaf_size, presplit)
        tri_v0, tri_e1, tri_e2, tri_gn, tri_index, tri_material, \
            tri_primitive, tri_local = (
                apply_slot_map(a, slot_map) for a in (
                    tri_v0, tri_e1, tri_e2, tri_gn, tri_index, tri_material,
                    tri_primitive, tri_local))
    tri_v0, tri_e1, tri_e2, tri_gn, tri_index, tri_material, tri_primitive, \
        tri_local = (_pad_rows(a, PAD) for a in (
            tri_v0, tri_e1, tri_e2, tri_gn, tri_index, tri_material,
            tri_primitive, tri_local))
    if vert_normal.shape[0] == 0:
        vert_normal = np.zeros((1, 3), np.float32)
        vert_tangent = np.zeros((1, 4), np.float32)
        vert_uv = np.zeros((1, 2), np.float32)

    mat = pack_materials(scene)
    tri_attr = attr_rows(dict(
        tri_index=tri_index, tri_gn=tri_gn, tri_material=tri_material,
        tri_primitive=tri_primitive, tri_local=tri_local),
        vert_normal, vert_tangent, vert_uv)

    pair_box = pair_link = skip_nodes = wide_nodes = tri_coefs = None
    oct_box = oct_link = frontier_box = frontier_link = None
    wide_seconds = 0.0
    if bvh is not None:
        quad_box, quad_link, quad_src = build_quad_tables(bvh, max_leaf_size)
        pair_box, pair_link, pair_src = build_pair_tables(bvh, max_leaf_size)
        oct_box, oct_link, oct_src = build_oct_tables(bvh, max_leaf_size)
        frontier_box, frontier_link, frontier_src = build_frontier_tables(
            bvh, max_leaf_size, frontier_width)
        skip_nodes, perm = flat_skip_nodes(bvh)
        if wide:
            t0 = time.perf_counter()
            wide_nodes = build_wide_bvh(bvh, max_leaf_size).nodes
            wide_seconds = time.perf_counter() - t0
        n_blocks = int(bvh.leaf_first.max()) // max_leaf_size + 1
        flat = np.concatenate([tri_v0, tri_e1, tri_e2], axis=1)[
            : n_blocks * max_leaf_size]
        leaves = flat.reshape(n_blocks, max_leaf_size, 9)
        if mt == "mxu":
            tri_coefs = build_mt_coef_rows(leaves)
        root_lo = np.asarray(bvh.bmin[0], np.float32)
        root_hi = np.asarray(bvh.bmax[0], np.float32)
        depth = tree_depth(bvh)
    else:   # no BVH (--traversal brute, or no triangles): brute force
        quad_box = quad_link = None
        leaves = np.zeros((1, max_leaf_size, 9), np.float32)
        root_lo = root_hi = np.zeros(3, np.float32)
        if num_triangles:   # the root box bounds the soup
            n = num_triangles
            corners = np.concatenate([tri_v0[:n], tri_v0[:n] + tri_e1[:n],
                                      tri_v0[:n] + tri_e2[:n]])
            root_lo, root_hi = corners.min(axis=0), corners.max(axis=0)
        depth = 0

    has_textures = mat.pop("has_textures")
    emissive_free = mat.pop("emissive_free")
    host = dict(
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2, tri_gn=tri_gn,
        tri_material=tri_material, tri_attr=tri_attr, **mat,
        quad_box=quad_box, quad_link=quad_link, pair_box=pair_box,
        pair_link=pair_link, oct_box=oct_box, oct_link=oct_link,
        frontier_box=frontier_box, frontier_link=frontier_link,
        tri_coefs=tri_coefs, leaves=leaves, root_lo=root_lo,
        root_hi=root_hi, skip_nodes=skip_nodes, wide_nodes=wide_nodes,
    )
    meta = dict(
        num_triangles=num_triangles, max_leaf_size=max_leaf_size,
        bvh_depth=depth, has_textures=has_textures,
        emissive_free=emissive_free, wide_seconds=wide_seconds,
    )
    dev = _to_device(host, meta, device)
    if bvh is not None:
        dev.tree = tree_maps(bvh, max_leaf_size, perm, dict(
            pair_src=pair_src, quad_src=quad_src, oct_src=oct_src,
            frontier_src=frontier_src), dev.device)
    return dev, slot_map


def scene_from_jax_arrays(arrays: dict, meta: dict, device) -> DeviceScene:
    """The port's scene from a JAX ``DeviceScene``'s arrays as NumPy
    (its ``_ARRAY_FIELDS``; absent fields None) and its static fields
    ``num_triangles``, ``max_leaf_size``, ``bvh_depth``,
    ``emissive_free`` (``has_textures``, ``instanced`` and ``mb_bits``
    are optional).

    Converts the JAX quad rows (N4, 32) and oct rows (N8, 64) — boxes,
    then enc links as f32 values, NaN boxes in empty slots — into
    quad_box / quad_link and oct_box / oct_link with the EMPTY sentinel,
    the frontier tiles into frontier_box / frontier_link (width from
    ``bvh_frontier_src``), the pair rows (Ni, 16) into pair_box /
    pair_link (int32 links, leaf values verbatim), the leaf table
    (n_leaves, block*9) into (n_leaves, block, 9) and the coefficient
    rows (n_leaves, 10, 4*block) into (n_leaves, block, 20).  An
    instanced scene brings its pair rows, ``inst_inv``, ``inst_nrm``,
    ``inst_feat`` (the (I, 10, 16) transforms as their (I, 40)
    non-zero entries) and ``mb_bits``; it has no quad, oct or frontier
    rows.  Trees whose root is a leaf have no JAX rows; the
    port's tables for them are built as build_quad_tables and
    build_pair_tables build them.  ``bvh_packed`` is the skip record
    as it is, ``bvh_wide_nodes`` the wide tiles (8 octant orders: a JAX
    bake with ``octant_order=False`` is refused).  A flat scene's
    build-order tree and static maps become its TreeMaps
    (_tree_from_jax)."""
    block = int(meta["max_leaf_size"])
    instanced = bool(meta.get("instanced", False))
    packed = arrays.get("bvh_packed")
    if int(meta.get("bvh_orders", 8)) != 8:
        raise ValueError("scene_from_jax_arrays: the port reads 8 octant "
                         "orders (octant_order=True)")
    quad_box = quad_link = pair_box = pair_link = None
    if packed is None:
        quad_box, quad_link, leaves, root_lo, root_hi = _empty_tree(block)
    else:
        blocks = arrays["tri_blocks"]
        leaves = blocks.reshape(blocks.shape[0], block, 9)
        root_lo = packed[0, 0:3].astype(np.float32)
        root_hi = packed[0, 3:6].astype(np.float32)
        leaf_first = int(np.ascontiguousarray(packed[0, 7:8]).view(
            np.int32)[0])
        # Root is a leaf when its packed leaf field is >= 0; its value
        # is a block-aligned slot (flat) or a packed leaf value.
        root_leaf = leaf_first if instanced else leaf_first // block
        rows = arrays.get("bvh_quad")
        if rows is not None:
            quad_box, quad_link = nary_tables_from_jax(rows, 4)
        elif not instanced and leaf_first >= 0:
            quad_box = np.zeros((1, 4, 6), np.float32)
            quad_link = np.full((1, 4), EMPTY, np.int32)
            quad_box[0, 0] = packed[0, 0:6]
            quad_link[0, 0] = -(root_leaf + 1)
        pairs = arrays.get("bvh_pair")
        if pairs is not None:
            pair_box = pairs[:, :12].reshape(-1, 2, 6).astype(np.float32)
            pair_link = pairs[:, 12:14].astype(np.int64).astype(np.int32)
        elif leaf_first >= 0:
            pair_box = np.broadcast_to(packed[0, 0:6], (1, 2, 6)).astype(
                np.float32)
            pair_link = np.full((1, 2), -(root_leaf + 1), np.int32)
    oct_box = oct_link = frontier_box = frontier_link = tri_coefs = None
    if arrays.get("bvh_oct") is not None:
        oct_box, oct_link = nary_tables_from_jax(arrays["bvh_oct"], 8)
    if arrays.get("bvh_frontier") is not None:
        frontier_box, frontier_link = tables_from_jax(
            arrays["bvh_frontier"], arrays["bvh_frontier_src"].shape[1])
    if arrays.get("tri_coefs") is not None:
        tri_coefs = coef_rows_from_jax(arrays["tri_coefs"], block)
    host = dict(
        tri_v0=arrays["tri_v0"], tri_e1=arrays["tri_e1"],
        tri_e2=arrays["tri_e2"], tri_gn=arrays["tri_gn"],
        tri_material=arrays["tri_material"].astype(np.int32),
        tri_attr=arrays["tri_attr"],
        mat_packed=arrays["mat_packed"].astype(np.int64),
        tex_texels=arrays["tex_texels"], tex_offset=arrays["tex_offset"],
        tex_width=arrays["tex_width"], tex_height=arrays["tex_height"],
        quad_box=quad_box, quad_link=quad_link, pair_box=pair_box,
        pair_link=pair_link, oct_box=oct_box, oct_link=oct_link,
        frontier_box=frontier_box, frontier_link=frontier_link,
        tri_coefs=tri_coefs, leaves=leaves, root_lo=root_lo,
        root_hi=root_hi, skip_nodes=packed,
        wide_nodes=arrays.get("bvh_wide_nodes"),
        inst_inv=arrays.get("inst_inv") if instanced else None,
        inst_nrm=arrays.get("inst_nrm") if instanced else None,
        inst_feat=(feature_maps_from_jax(arrays["inst_feat"])
                   if instanced and arrays.get("inst_feat") is not None
                   else None),
    )
    out_meta = dict(
        num_triangles=int(meta["num_triangles"]), max_leaf_size=block,
        bvh_depth=int(meta["bvh_depth"]),
        has_textures=bool(meta.get("has_textures",
                                   arrays["tex_offset"].shape[0] > 1)),
        emissive_free=bool(meta["emissive_free"]),
        instanced=instanced,
        mb_bits=int(meta.get("mb_bits", 0)) if instanced else 0,
    )
    dev = _to_device(host, out_meta, device)
    if not instanced and arrays.get("bvh_left") is not None:
        dev.tree = _tree_from_jax(arrays, dev, block)
    return dev


def _tree_from_jax(arrays: dict, dev: DeviceScene, block: int) -> TreeMaps:
    """The TreeMaps of a flat JAX scene: its build-order arrays and its
    (src, enc) maps, each enc checked against the converted table's
    links (EMPTY where src is -1).  A table without JAX maps (a root
    leaf's one row) gets the map of its one slot; the pair rows'
    children come from ``bvh_left`` / ``bvh_right``."""
    left = np.asarray(arrays["bvh_left"], np.int64)
    right = np.asarray(arrays["bvh_right"], np.int64)
    lf = np.asarray(arrays["bvh_leaf_first_build"], np.int64)
    lc = np.asarray(arrays["bvh_leaf_count_build"], np.int64)
    internal = np.nonzero(left >= 0)[0]
    pairs = (np.stack([left[internal], right[internal]], axis=1)
             if left[0] >= 0 else np.zeros((1, 2), np.int64))

    def src_of(name, link):
        if link is None:
            return None
        src = arrays.get(f"bvh_{name}_src")
        if src is None:
            src = np.full(link.shape, -1, np.int64)
            src[0, 0] = 0
            return src
        src = np.asarray(src, np.int64)
        enc = arrays[f"bvh_{name}_enc"]
        want = np.where(src < 0, EMPTY, enc.astype(np.int64))
        if src.shape != link.shape or not np.array_equal(
                want, link.cpu().numpy()):
            raise ValueError(f"bvh_{name}_enc does not match the "
                             f"converted {name} table's links")
        return src

    def up(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.int64)).to(dev.device)

    return TreeMaps(
        left=up(left), right=up(right), leaf_first=up(lf), leaf_count=up(lc),
        block_count=up(_block_count(lf, lc, block, dev.leaves.shape[0])),
        perm=up(arrays["bvh_perm"]),
        pair_src=up(pairs), quad_src=up(src_of("quad", dev.quad_link)),
        oct_src=up(src_of("oct", dev.oct_link)),
        frontier_src=up(src_of("frontier", dev.frontier_link)))
