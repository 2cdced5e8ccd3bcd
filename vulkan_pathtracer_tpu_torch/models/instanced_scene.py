"""Two-level BVH / instancing: per-mesh BLAS + TLAS, geometry stored once.

Port of ``vulkan_pathtracer_tpu/models/instanced_scene.py``
(``build_instanced_scene``, ``update_instance_transforms``).  The
reference's TLAS references one BLAS per mesh — N instances share
geometry with only a 3x4 transform each (Tlas.zig:33-51,
RaytracingPass.zig:224-352).  The bake:

- one object-space BLAS per MESH (SAH tree + fixed leaf blocks, the
  flat bake's machinery), triangles and vertex attributes stored ONCE
  regardless of instance count;
- a top tree (TLAS) over conservative instance world boxes;
- the two levels SPLICED into one preorder per direction octant (the
  8 octant orders of every BLAS and of the TLAS): each TLAS instance
  leaf is replaced by a copy of its mesh's BLAS nodes with world-space
  conservative boxes (the object box's corners transformed).  Only
  nodes are per instance;
- leaf values pack (instance, global mesh leaf block) into one integer
  ``inst << mb_bits | block`` (< 2^24, LEAF_PACK_BITS); traversal
  transforms the ray into object space at each leaf visit
  (ops/stack_traverse.py, ops/skip_traverse.py) and culls by the world
  winding;
- the skip record ``skip_nodes`` of the 8 spliced preorders (the JAX
  ``bvh_packed``, ``--traversal pallas_packet`` and ``bvh``) and the
  pair table (``pair_box`` / ``pair_link``) of the octant-0 preorder
  (the pair kernels descend near-first by each ray's own entry
  distance, so one order serves every ray);
- under ``mt="mxu"`` the coefficient leaves of the pair kernels
  (instanced_scene.py:434-440 of the JAX package): the per-mesh
  object-space ``tri_coefs`` and the per-instance feature transforms
  ``inst_feat`` (ops/mxu_mt.py), which update_instance_transforms
  regenerates.  The dense rows serve a tier that is not ported.

Shading parity: attribute rows are object space; the hit decode
(render/shading.py) transforms interpolated normals/tangents and the
geometric normal by the instance normal matrix inverse(A).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models.device_scene import (
    PAD,
    DeviceScene,
    _pad_rows,
    _to_device,
    apply_slot_map,
    attr_rows,
    bvh_with_leaf_blocks,
    pack_materials,
    skip_records,
)
from vulkan_pathtracer_tpu_torch.models.gltf import Scene
from vulkan_pathtracer_tpu_torch.ops.bvh import (
    build_bvh_host,
    octant_orders,
    tree_depth,
)
from vulkan_pathtracer_tpu_torch.ops.mxu_mt import (
    build_mt_coef_rows,
    coef_table,
    instance_feature_maps,
)
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import (
    build_pair_tables_preorder,
)

LEAF_PACK_BITS = 24  # packed (inst, block) stays below 2^24


@dataclass
class InstanceMaps:
    """Static maps of ``update_instance_transforms`` (topology fixed,
    boxes move), over the 8 spliced preorders' 8 * Nn records (octant
    o's node p is record o * Nn + p; the pair table reads octant 0)."""
    pair_src: torch.Tensor     # (Ni, 2) int64 node ids of each row's children
    node_inst: torch.Tensor    # (8*Nn,) int64 instance of the node, -1 = TLAS
    node_obj_lo: torch.Tensor  # (8*Nn, 3) f32 object box of instance nodes
    node_obj_hi: torch.Tensor  # (8*Nn, 3) f32
    inst_root_obj: torch.Tensor  # (I, 6) f32 mesh root object box
    top_kids: torch.Tensor     # (2*Ntop,) int64 TLAS left children, then
    # right children (build order); a leaf is its own two children
    top_leaf_inst: torch.Tensor  # (Ntop,) int64 instance of a TLAS leaf | -1
    top_node: torch.Tensor     # (8, Ntop) int64 record of each TLAS node
    top_depth: int
    top_inner: torch.Tensor    # (Ninner,) int64 TLAS internal nodes
    inner_records: torch.Tensor  # (8*Ninner,) their records, octant-major


def _transform_aabb(bmin, bmax, A, t):
    """Conservative world AABB of an object AABB under x -> A@x + t
    (instanced_scene._transform_aabb: centre/extent in f32, products
    in f64).  Vectorized over leading axes."""
    c = (bmin + bmax) * 0.5
    e = (bmax - bmin) * 0.5
    wc = c @ A.T + t
    we = e @ np.abs(A).T
    return (wc - we).astype(np.float32), (wc + we).astype(np.float32)


def _mesh_blas(scene: Scene, m: int, block: int, vert_base: int):
    """Object-space triangles of mesh m in leaf-block order, its BVH,
    the mesh's vertex attributes and the next vertex base."""
    mesh = scene.meshes[m]
    cols = {k: [] for k in ("tri_v0", "tri_e1", "tri_e2", "tri_gn",
                            "tri_index", "tri_material", "tri_primitive",
                            "tri_local")}
    verts = {"normal": [], "tangent": [], "uv": []}
    for prim_global in range(mesh.start, mesh.end):
        prim = scene.primitives[prim_global]
        idx = prim.indices.reshape(-1, 3).astype(np.int64)
        pos = prim.positions.astype(np.float32)
        v0 = pos[idx[:, 0]]
        e1 = pos[idx[:, 1]] - v0
        e2 = pos[idx[:, 2]] - v0
        gn = np.cross(e1.astype(np.float64), e2.astype(np.float64))
        nrm = np.linalg.norm(gn, axis=1, keepdims=True)
        tcount = idx.shape[0]
        cols["tri_v0"].append(v0)
        cols["tri_e1"].append(e1)
        cols["tri_e2"].append(e2)
        cols["tri_gn"].append((gn / np.maximum(nrm, 1e-30)).astype(
            np.float32))
        cols["tri_index"].append((idx + vert_base).astype(np.int32))
        cols["tri_material"].append(
            np.full(tcount, prim.material_index, np.int32))
        cols["tri_primitive"].append(np.full(tcount, prim_global, np.int32))
        cols["tri_local"].append(np.arange(tcount, dtype=np.int32))
        verts["normal"].append(prim.normals)
        verts["tangent"].append(prim.tangents)
        verts["uv"].append(prim.uvs)
        vert_base += prim.positions.shape[0]
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    bvh, slot_map = bvh_with_leaf_blocks(cat["tri_v0"], cat["tri_e1"],
                                         cat["tri_e2"], block)
    tri = {k: apply_slot_map(v, slot_map) for k, v in cat.items()}
    return tri, bvh, verts, vert_base


def _splice(o, top, top_orders, meshes, inst_mesh, mb_base, mb_bits, block,
            A, t):
    """Octant o's spliced preorder (instanced_scene.py:198-276 of the
    JAX package): boxes, local skips, packed leaf values (-1 inside),
    the instance and object box of each node, and the position of
    each TLAS node (by build id)."""
    top_skip8, top_lf8, _, top_perm8 = top_orders
    top_skip, top_lf, top_perm = top_skip8[o], top_lf8[o], top_perm8[o]
    n_top = top.node_count
    sizes = np.ones(n_top, np.int64)
    for i in range(n_top):
        if top_lf[i] >= 0:
            inst = int(top.tri_order[top_lf[i]])
            sizes[i] = meshes[inst_mesh[inst]]["n_nodes"]
    pos = np.zeros(n_top + 1, np.int64)
    np.cumsum(sizes, out=pos[1:])
    total = int(pos[n_top])
    out = dict(bmin=np.empty((total, 3), np.float32),
               bmax=np.empty((total, 3), np.float32),
               skip=np.empty(total, np.int64),
               leaf=np.full(total, -1, np.int64),
               inst=np.full(total, -1, np.int64),
               obj_lo=np.zeros((total, 3), np.float32),
               obj_hi=np.zeros((total, 3), np.float32),
               top_node=np.zeros(n_top, np.int64))
    for i in range(n_top):
        p = pos[i]
        esc = pos[top_skip[i]]
        bld = top_perm[i]
        out["top_node"][bld] = p
        if top_lf[i] < 0:
            out["bmin"][p] = top.bmin[bld]
            out["bmax"][p] = top.bmax[bld]
            out["skip"][p] = esc
            continue
        inst = int(top.tri_order[top_lf[i]])
        mi = inst_mesh[inst]
        md = meshes[mi]
        nn = md["n_nodes"]
        perm = md["perm8"][o]
        obmin = md["bvh"].bmin[perm]
        obmax = md["bvh"].bmax[perm]
        sl = slice(p, p + nn)
        out["bmin"][sl], out["bmax"][sl] = _transform_aabb(
            obmin, obmax, A[inst], t[inst])
        skips = md["skip8"][o].astype(np.int64)
        out["skip"][sl] = np.where(skips >= nn, esc, skips + p)
        lf = md["lf8"][o]
        out["leaf"][sl] = np.where(
            lf >= 0, (np.int64(inst) << mb_bits)
            | (lf.astype(np.int64) // block + mb_base[mi]), -1)
        out["inst"][sl] = inst
        out["obj_lo"][sl] = obmin
        out["obj_hi"][sl] = obmax
    return out


def build_instanced_scene(scene: Scene, max_leaf_size: int = 14,
                          device="cuda", mt: str = "exact",
                          mxu_precision: str = "highest") -> DeviceScene:
    """Bake a host Scene into a two-level DeviceScene (geometry once,
    per-instance node copies; see the module docstring); ``mt="mxu"``
    adds the coefficient leaves, their table in bf16 under
    ``mxu_precision="default"`` (the feature transforms stay f32)."""
    block = max_leaf_size
    n_inst = len(scene.instances)
    if n_inst == 0:
        raise ValueError("build_instanced_scene: the scene has no instances")

    # ---- per-mesh object-space BLAS ---------------------------------------
    mesh_ids = sorted({inst.mesh_index for inst in scene.instances})
    mesh_slot = {m: i for i, m in enumerate(mesh_ids)}
    tri_parts, verts = [], {"normal": [], "tangent": [], "uv": []}
    meshes = []
    mb_base = [0]
    vert_base = 0
    for m in mesh_ids:
        tri, bvh, mverts, vert_base = _mesh_blas(scene, m, block, vert_base)
        tri_parts.append(tri)
        for k in verts:
            verts[k] += mverts[k]
        skip8, lf8, _, perm8 = octant_orders(bvh)
        meshes.append(dict(bvh=bvh, skip8=skip8, lf8=lf8, perm8=perm8,
                           n_nodes=bvh.node_count))
        mb_base.append(mb_base[-1] + tri["tri_v0"].shape[0] // block)
    total_blocks = mb_base[-1]
    mb_bits = max(int(np.ceil(np.log2(max(total_blocks, 2)))), 1)
    if (n_inst << mb_bits) >= (1 << LEAF_PACK_BITS):
        raise ValueError(
            f"instanced scene too large to pack: {n_inst} instances x "
            f"{total_blocks} leaf blocks needs more than "
            f"{LEAF_PACK_BITS} bits")

    # ---- instance transforms + world boxes --------------------------------
    inst_mesh = np.array([mesh_slot[inst.mesh_index]
                          for inst in scene.instances], np.int32)
    M = np.stack([inst.transform for inst in scene.instances]).astype(
        np.float64)
    A = M[:, :3, :3]
    t = M[:, :3, 3]
    inst_root_obj = np.stack([
        np.concatenate([meshes[mi]["bvh"].bmin[0], meshes[mi]["bvh"].bmax[0]])
        for mi in inst_mesh]).astype(np.float32)
    root_bmin = np.empty((n_inst, 3), np.float32)
    root_bmax = np.empty((n_inst, 3), np.float32)
    for i in range(n_inst):
        root_bmin[i], root_bmax[i] = _transform_aabb(
            inst_root_obj[i, :3], inst_root_obj[i, 3:], A[i], t[i])

    # ---- top tree (TLAS) over instance boxes ------------------------------
    # Fake triangles whose boxes equal the instance boxes (v0 = bmin,
    # e1 = extent, e2 = 0) feed the standard builder with 1-item leaves.
    top = build_bvh_host(root_bmin, root_bmax - root_bmin,
                         np.zeros_like(root_bmin), max_leaf_size=1,
                         use_native=False)
    top_orders = octant_orders(top)

    # ---- splice the instance subtrees into each octant's top preorder -----
    octs = [_splice(o, top, top_orders, meshes, inst_mesh, mb_base, mb_bits,
                    block, A, t) for o in range(8)]
    nn = octs[0]["bmin"].shape[0]
    cat = {k: np.concatenate([oc[k] for oc in octs])
           for k in ("bmin", "bmax", "skip", "leaf", "inst", "obj_lo",
                     "obj_hi")}
    skip_nodes = skip_records(cat["bmin"], cat["bmax"], cat["skip"],
                              cat["leaf"])
    # top_node: spliced position of each TLAS node (build id) in the
    # stacked 8 * Nn record table.
    top_node = np.stack([oc["top_node"] + o * nn
                         for o, oc in enumerate(octs)])
    o0 = octs[0]
    pair_box, pair_link, pair_src = build_pair_tables_preorder(
        o0["bmin"], o0["bmax"], o0["skip"], o0["leaf"])

    # ---- triangles, shading rows, instance tables --------------------------
    tri = {k: np.concatenate([p[k] for p in tri_parts])
           for k in tri_parts[0]}
    num_triangles = tri["tri_v0"].shape[0]
    tri = {k: _pad_rows(v, PAD) for k, v in tri.items()}
    tri_attr = attr_rows(tri, np.concatenate(verts["normal"]),
                         np.concatenate(verts["tangent"]),
                         np.concatenate(verts["uv"]))
    leaves = np.concatenate([tri["tri_v0"], tri["tri_e1"], tri["tri_e2"]],
                            axis=1)[: total_blocks * block].reshape(
                                total_blocks, block, 9)
    # Instance tables: object <- world rows and the normal matrix inv(A)
    # (triangle.glsl row-vector quirk parity).
    Ainv = np.linalg.inv(A)
    inv_t = -np.einsum("ijk,ik->ij", Ainv, t)
    det_sign = np.sign(np.linalg.det(A)).astype(np.float32)
    inst_inv = np.zeros((n_inst, 16), np.float32)
    inst_inv[:, 0:9] = Ainv.reshape(n_inst, 9)
    inst_inv[:, 9:12] = inv_t
    inst_inv[:, 12] = np.where(det_sign == 0, 1.0, det_sign)
    inst_nrm = Ainv.reshape(n_inst, 9).astype(np.float32)

    mat = pack_materials(scene)
    has_textures = mat.pop("has_textures")
    emissive_free = mat.pop("emissive_free")
    host = dict(
        tri_v0=tri["tri_v0"], tri_e1=tri["tri_e1"], tri_e2=tri["tri_e2"],
        tri_gn=tri["tri_gn"], tri_material=tri["tri_material"],
        tri_attr=tri_attr, **mat, leaves=leaves, root_lo=o0["bmin"][0],
        root_hi=o0["bmax"][0], pair_box=pair_box, pair_link=pair_link,
        inst_inv=inst_inv, inst_nrm=inst_nrm, skip_nodes=skip_nodes,
        tri_coefs=build_mt_coef_rows(leaves) if mt == "mxu" else None,
        inst_feat=(instance_feature_maps(torch.from_numpy(inst_inv)).numpy()
                   if mt == "mxu" else None),
    )
    meta = dict(
        num_triangles=num_triangles, max_leaf_size=block,
        bvh_depth=tree_depth(top) + max(tree_depth(md["bvh"])
                                         for md in meshes),
        has_textures=has_textures, emissive_free=emissive_free,
        instanced=True, mb_bits=mb_bits,
    )
    dev = _to_device(host, meta, device)
    if dev.tri_coefs is not None:
        dev.tri_coefs = coef_table(dev.tri_coefs, mxu_precision)
    top_leaf_inst = np.where(top.leaf_first >= 0,
                             top.tri_order[np.maximum(top.leaf_first, 0)],
                             -1)
    top_inner = np.flatnonzero(top_leaf_inst < 0)
    own = np.arange(len(top_leaf_inst))
    top_kids = np.concatenate([
        np.where(top_leaf_inst < 0, top.left_child, own),
        np.where(top_leaf_inst < 0, top.right_child, own)])

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev.device)

    dev.inst_maps = InstanceMaps(
        pair_src=up(pair_src), node_inst=up(cat["inst"]),
        node_obj_lo=up(cat["obj_lo"]), node_obj_hi=up(cat["obj_hi"]),
        inst_root_obj=up(inst_root_obj),
        top_kids=up(top_kids.astype(np.int64)),
        top_leaf_inst=up(top_leaf_inst.astype(np.int64)),
        top_node=up(top_node), top_depth=tree_depth(top),
        top_inner=up(top_inner.astype(np.int64)),
        inner_records=up(top_node[:, top_inner].reshape(-1)))
    return dev


def _transform_boxes(lo, hi, A, t):
    """Device twin of _transform_aabb: f32 centre/extent, f64 products.
    lo, hi (N, 3) f32; A (N, 3, 3) and t (N, 3) f64."""
    c = ((lo + hi) * 0.5).double()
    e = ((hi - lo) * 0.5).double()
    wc = (A @ c[:, :, None])[:, :, 0] + t
    we = (A.abs() @ e[:, :, None])[:, :, 0]
    return (wc - we).float(), (wc + we).float()


def _det3(A: torch.Tensor) -> torch.Tensor:
    """(N,) determinants of (N, 3, 3) matrices: the triple product of
    their columns (no factorisation, no read of the device)."""
    c0, c1, c2 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
    return (c0 * torch.linalg.cross(c1, c2)).sum(dim=1)


def update_instance_transforms(scene: DeviceScene, transforms) -> DeviceScene:
    """A copy of an instanced scene with new (I, 4, 4) instance
    transforms, all on the scene's device: the instance tables, the
    instance nodes' world boxes in all 8 octant preorders (shared mesh
    object boxes transformed), the TLAS boxes by a bottom-up sweep over
    the top tree, the skip record (boxes new, skips and leaves kept) and
    the pair table regenerated through its static map, and the feature
    transforms of coefficient leaves (``inst_feat``) when the scene has
    them.  No triangle is touched.  A fixed sequence of launches: the
    inverse takes no singularity check (``inv_ex``), the TLAS's internal
    nodes come from the bake's index tensors, so nothing reads the
    device back."""
    maps = scene.inst_maps
    dev = scene.device
    M = torch.as_tensor(transforms, dtype=torch.float64, device=dev)
    A = M[:, :3, :3]
    t = M[:, :3, 3]
    n_inst = A.shape[0]
    Ainv = torch.linalg.inv_ex(A).inverse
    inv_t = -(Ainv @ t[:, :, None])[:, :, 0]
    det_sign = torch.where(_det3(A) < 0, -1.0, 1.0).double()
    inst_inv = torch.cat([Ainv.reshape(n_inst, 9), inv_t, det_sign[:, None],
                          torch.zeros((n_inst, 3), dtype=torch.float64,
                                      device=dev)], dim=1).float()

    # Instance nodes: the shared object boxes under their instance.
    ii = maps.node_inst.clamp(min=0)
    lo, hi = _transform_boxes(maps.node_obj_lo, maps.node_obj_hi, A[ii],
                              t[ii])
    # TLAS: leaves hold their instance's world root box; internal nodes
    # take the union of their children, top_depth - 1 sweeps of three
    # launches (a node at height h is right after h sweeps, whatever it
    # held before; a leaf, its own two children, keeps its box).
    root = maps.inst_root_obj
    ilo, ihi = _transform_boxes(root[:, :3], root[:, 3:], A, t)
    box = torch.cat([ilo, ihi], dim=1)[maps.top_leaf_inst.clamp(min=0)]
    n_top = box.shape[0]
    for _ in range(max(maps.top_depth - 1, 0)):
        kids = box[maps.top_kids].view(2, n_top, 6)
        box = torch.empty_like(box)
        torch.minimum(kids[0, :, :3], kids[1, :, :3], out=box[:, :3])
        torch.maximum(kids[0, :, 3:], kids[1, :, 3:], out=box[:, 3:])
    # TLAS internal nodes into their spliced positions in every octant
    # (a TLAS leaf's position is its instance subtree's root, set above).
    inner = box[maps.top_inner].repeat(8, 1)
    lo[maps.inner_records] = inner[:, :3]
    hi[maps.inner_records] = inner[:, 3:]
    src = maps.pair_src   # octant 0: records 0 .. Nn-1
    pair_box = torch.cat([lo[src], hi[src]], dim=2)
    skip_nodes = torch.cat([lo, hi, scene.skip_nodes[:, 6:8]], dim=1)
    inst_feat = (None if scene.inst_feat is None
                 else instance_feature_maps(inst_inv))
    return dataclasses.replace(
        scene, inst_inv=inst_inv, inst_nrm=Ainv.reshape(n_inst, 9).float(),
        inst_feat=inst_feat,
        pair_box=pair_box, skip_nodes=skip_nodes, root_lo=lo[0].clone(),
        root_hi=hi[0].clone())
