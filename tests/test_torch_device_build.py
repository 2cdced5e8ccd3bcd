"""PyTorch port vs JAX: the device LBVH build and rebuild.

- ``clz32``, the Morton codes, the Karras radix tree and every integer
  array of ``device_build_bvh`` (triangle order, children, subtree
  ranges, the 8 octant permutations, skips, leaf fields) equal JAX's
  exactly; the boxes and the slot-ordered triangles bitwise.
- The invariants of tests/test_device_build.py:81 on the port's build.
- ``device_rebuild_scene`` bitwise JAX's rebuild converted
  (``scene_from_jax_arrays``): triangles, shading rows, pair and quad
  tables, skip records, leaf blocks and the TreeMaps; its coefficient
  rows bitwise a host bake of the rebuilt leaves; oct, frontier and the
  8-wide tiles dropped, and the tier dispatch on the rebuilt scene the
  launcher JAX's dispatch picks.
- The deforming rebuild (tests/test_device_build.py:155's warp at two
  phases) against brute force over the deformed triangles (t within
  1e-5, as there); pair and quad hits on the rebuilt tables exactly the
  ``--traversal bvh`` walk's (t and triangle).
- A mid-row empty slot (nary_maps pads early leaves in the middle of a
  row) is never visited, by the quad walk and by the frontier walk
  with its sorting network.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.ops import device_build as jdb
from vulkan_pathtracer_tpu.ops.mxu_mt import build_mt_coef_rows
from vulkan_pathtracer_tpu.ops.pallas_pair import nary_maps_device
from vulkan_pathtracer_tpu_torch.app.dynamic import twist
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    build_device_scene,
    scene_from_jax_arrays,
)
from vulkan_pathtracer_tpu_torch.ops import device_build as tdb
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops import traverse as tv
from vulkan_pathtracer_tpu_torch.ops.intersect import (
    MISS_T,
    brute_force_closest_hit,
)
from vulkan_pathtracer_tpu_torch.ops.mxu_mt import coef_rows_from_jax
from vulkan_pathtracer_tpu_torch.ops.refit import refit_scene, tree_violations
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.utils import RenderConfig

from tests.native_guard import native_libraries  # noqa: F401
from tests.test_torch_presplit_refit import assert_tables_equal
from tests.test_torch_scene import jax_scene_arrays

pytestmark = pytest.mark.usefixtures("native_libraries")

INT_FIELDS = ("skip_local", "leaf_first", "leaf_count", "perm", "left",
              "right", "leaf_first_build", "leaf_count_build", "tri_order")
F32_FIELDS = ("bmin", "bmax", "tri_v0", "tri_e1", "tri_e2")


def _rand_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4.0, 4.0, size=(n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    return v0, e1, e2


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def test_clz_and_morton_match_jax():
    x = np.array([0, 1, 2, 3, 255, 256, 0xFFFF, 0x10000, 0x7FFFFFFF,
                  0x80000000, 0xFFFFFFFF, 12345678], np.uint32)
    rng = np.random.default_rng(4)
    x = np.concatenate([x, rng.integers(0, 2 ** 32, 4000, dtype=np.uint64)
                        .astype(np.uint32), 1 << np.arange(32, dtype=np.uint32)])
    want = np.asarray(jax.lax.clz(jnp.asarray(x))).astype(np.int64)
    assert np.array_equal(tdb.clz32(torch.from_numpy(x.astype(np.int64)))
                          .numpy(), want)
    v0, e1, e2 = _rand_tris(3000, 5)
    cent = v0 + (e1 + e2) / np.float32(3.0)
    jc, jlo, jhi = jdb.morton_codes_device(jnp.asarray(cent),
                                           jnp.ones((3000,), bool))
    tc, tlo, thi = tdb.morton_codes(torch.from_numpy(cent))
    assert np.array_equal(np.asarray(jc).astype(np.int64), tc.numpy())
    assert np.array_equal(np.asarray(jlo), tlo.numpy())


@pytest.mark.parametrize("kind", ["random", "duplicates", "all_equal",
                                  "clustered_9000", "duplicates_4096"])
def test_radix_tree_matches_jax(kind):
    """Exact, with JAX's 26/26/27 loop steps against the port's, which
    stop at the bit length of L (power-of-two and larger L too)."""
    rng = np.random.default_rng(3)
    codes = {"random": np.sort(rng.integers(0, 1 << 30, 64, dtype=np.uint32)),
             "duplicates": np.sort(np.repeat(rng.integers(
                 0, 1 << 30, 8, dtype=np.uint32), 8)),
             "all_equal": np.zeros(16, np.uint32),
             "clustered_9000": np.sort(rng.integers(0, 1 << 12, 9000,
                                                    dtype=np.uint32) << 18),
             "duplicates_4096": np.sort(np.repeat(rng.integers(
                 0, 1 << 30, 256, dtype=np.uint32), 16))}[kind]
    want = jdb.build_radix_tree(jnp.asarray(codes))
    got = tdb.build_radix_tree(torch.from_numpy(codes.astype(np.int64)))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


@pytest.mark.parametrize("n,block", [(5, 8), (100, 8), (1000, 8),
                                     (1000, 4), (777, 28)])
def test_device_build_matches_jax(n, block):
    v0, e1, e2 = _rand_tris(n, n)
    want = jdb.device_build_bvh(jnp.asarray(v0), jnp.asarray(e1),
                                jnp.asarray(e2), num_triangles=n,
                                block=block, octants=8)
    got = tdb.device_build_bvh(torch.from_numpy(v0), torch.from_numpy(e1),
                               torch.from_numpy(e2), n, block)
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(want[f]).astype(np.int64),
                              got[f].numpy()), f
    for f in F32_FIELDS:
        assert np.array_equal(np.asarray(want[f]).view(np.uint32),
                              got[f].numpy().view(np.uint32)), f
    assert (got["n_nodes"], got["depth"]) == (want["n_nodes"], want["depth"])
    for L in (1, 2, 3, 4, 1023, 1024, 1025, 8802, 2 ** 20):
        assert tdb.depth_bound(L) == jdb._depth_bound(L)


@pytest.mark.parametrize("n_tris", [5, 100, 1000])
def test_device_build_invariants(n_tris):
    """tests/test_device_build.py:81 on the port's build, per octant:
    skips escape forward, leaf ranges cover every triangle once, every
    node box contains its leaf's triangles (exactly: the boxes are the
    triangles' min and max)."""
    v0, e1, e2 = (torch.from_numpy(a) for a in _rand_tris(n_tris))
    b = tdb.device_build_bvh(v0, e1, e2, n_tris, 8)
    nn = b["n_nodes"]
    bmin = b["bmin"].view(8, nn, 3)
    bmax = b["bmax"].view(8, nn, 3)
    skip = b["skip_local"].view(8, nn)
    lf = b["leaf_first"].view(8, nn)
    lc = b["leaf_count"].view(8, nn)
    s0 = b["tri_v0"]
    corners = (s0, s0 + b["tri_e1"], s0 + b["tri_e2"])
    for o in range(8):
        assert (skip[o] > torch.arange(nn)).all()
        covered = torch.zeros(s0.shape[0], dtype=torch.int64)
        for node in torch.nonzero(lf[o] >= 0).squeeze(1).tolist():
            a, c = int(lf[o, node]), int(lc[o, node])
            covered[a:a + c] += 1
            for p in corners:
                assert (p[a:a + c] >= bmin[o, node]).all()
                assert (p[a:a + c] <= bmax[o, node]).all()
        assert (covered[:n_tris] == 1).all() and covered[n_tris:].sum() == 0
    assert sorted(b["tri_order"].tolist()) == list(range(n_tris))


@pytest.fixture(scope="module")
def rebuilt(columns_glb):
    """(JAX rebuild converted, the port's rebuild, the port's template):
    the columns scene, leaf 4, from a template without a BVH (8 octant
    orders on JAX's side), the port's rebuild with coefficient rows."""
    jt = jax_build(jgltf.load(columns_glb), build_bvh=False)
    jt = dataclasses.replace(jt, bvh_orders=8)
    jr = jdb.device_rebuild_scene(jt, jt.tri_v0, jt.tri_e1, jt.tri_e2,
                                  jt.tri_gn, jt.tri_attr)
    conv = scene_from_jax_arrays(*jax_scene_arrays(jr), "cpu")
    tt = build_device_scene(gltf.load(columns_glb), max_leaf_size=4,
                            device="cpu", build_bvh=False)
    tr = tdb.device_rebuild_scene(tt, tt.tri_v0, tt.tri_e1, tt.tri_e2,
                                  tt.tri_gn, tt.tri_attr, coefs=True)
    return conv, tr, tt


def test_rebuild_matches_jax(rebuilt):
    conv, tr, _ = rebuilt
    assert_tables_equal(tr, conv, (
        "tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_attr", "tri_material",
        "leaves", "pair_box", "pair_link", "quad_box", "quad_link",
        "root_lo", "root_hi"))
    assert tr.bvh_depth == conv.bvh_depth
    assert tr.oct_box is tr.frontier_box is tr.wide_nodes is None
    fresh = coef_rows_from_jax(build_mt_coef_rows(
        tr.leaves.numpy().reshape(tr.leaves.shape[0], -1), 4), 4)
    assert np.array_equal(tr.tri_coefs.numpy().view(np.uint32),
                          fresh.view(np.uint32))
    assert tree_violations(tr) == (0, 0)
    # The quad rows keep early leaves' empty slots mid-row.
    link = tr.quad_link.numpy()
    empty = link == st.EMPTY
    assert (empty[:, :-1] & ~empty[:, 1:]).any()


def test_rebuild_refits(rebuilt):
    """A rebuilt scene carries its TreeMaps: a refit of it is itself."""
    _, tr, _ = rebuilt
    assert_tables_equal(refit_scene(tr), tr, (
        "pair_box", "quad_box", "leaves", "tri_coefs", "root_lo"))


def test_nary_maps_match_jax(rebuilt):
    _, tr, _ = rebuilt
    t = tr.tree
    for width in (4, 8):
        js, je = nary_maps_device(jnp.asarray(t.left.numpy()),
                                  jnp.asarray(t.right.numpy()),
                                  jnp.asarray(t.leaf_first.numpy()), 4, width)
        src, link = tdb.nary_maps(t.left, t.right, t.leaf_first, 4, width)
        js = np.asarray(js).astype(np.int64)
        assert np.array_equal(js, src.numpy())
        assert np.array_equal(np.where(js < 0, st.EMPTY, np.asarray(je)),
                              link.numpy())


@pytest.mark.parametrize("kernel", ["pair", "quad"])
def test_rebuilt_hits_match_bvh_walk(rebuilt, kernel):
    """Exact: the pair and quad walks (plain versions) over the rebuilt
    tables against the skip walk over its skip records, t and
    triangle."""
    _, tr, _ = rebuilt
    o, d = _rays(700, 31)
    ref = tv.bvh_closest_hit(tr, o, d)
    hit = getattr(st, f"{kernel}_closest_hit")(tr, o, d)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.tri, ref.tri)
    occ = getattr(st, f"{kernel}_any_hit")(tr, o, d)
    assert torch.equal(occ, ref.t < MISS_T)


@pytest.mark.parametrize("phase", [0.0, 1.0])
def test_deforming_rebuild_matches_brute_force(rebuilt, phase):
    """app/dynamic.twist, the warp of tests/test_device_build.py:166-176
    (every vertex turned about y by 0.3 * sin(phase) * y)."""
    _, _, tt = rebuilt
    w0, we1, we2, gn = twist(tt.tri_v0, tt.tri_e1, tt.tri_e2, phase)
    scene = tdb.device_rebuild_scene(tt, w0, we1, we2, gn, tt.tri_attr)
    plain = dataclasses.replace(tt, tri_v0=w0, tri_e1=we1, tri_e2=we2)
    o, d = _rays(500, 9)
    ref = brute_force_closest_hit(plain, o, d)
    for fn in (tv.bvh_closest_hit, st.pair_closest_hit,
               st.quad_closest_hit):
        got = fn(scene, o, d)
        np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert tree_violations(scene) == (0, 0)


def test_rebuilt_dispatch_matches_jax(columns_glb, monkeypatch):
    """On a rebuilt scene (oct and frontier dropped) each tier falls
    through to the launcher JAX's dispatch picks on JAX's rebuild."""
    from tests.test_torch_tiers import _jax_choice, _port_name

    jd = jax_build(jgltf.load(columns_glb), build_bvh=True, max_leaf_size=4,
                   wide=False)
    jr = jdb.device_rebuild_scene(jd, jd.tri_v0, jd.tri_e1, jd.tri_e2,
                                  jd.tri_gn, jd.tri_attr)
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=4,
                            device="cpu")
    tr = tdb.device_rebuild_scene(td, td.tri_v0, td.tri_e1, td.tri_e2,
                                  td.tri_gn, td.tri_attr)
    for tiers in ({}, {"kernel_primary": "oct"},
                  {"kernel_primary": "frontier"},
                  {"kernel_secondary": "oct"}, {"kernel_primary": "quad"}):
        for phase in ("primary", "secondary"):
            want = _jax_choice(monkeypatch, jr, tiers, phase=phase)
            got, _ = _port_name(wavefront._closest_tier(
                tr, RenderConfig(**tiers).tiers, phase))
            assert [got] == want, (tiers, phase)
    for tiers in ({}, {"anyhit_kernel": "frontier"}):
        want = _jax_choice(monkeypatch, jr, tiers, any_hit=True)
        got, _ = _port_name(wavefront._any_tier(tr,
                                                RenderConfig(**tiers).tiers))
        assert [got] == want


def _mid_row_empty_tables(box, link, leaves):
    """The tables with a spare leaf block 0 (degenerate, no walk should
    reach it: every leaf link moves up by one) and each row's slots
    rotated by one, so an empty slot sits before a live one."""
    leaf = (link < 0) & (link != st.EMPTY)
    link = torch.where(leaf, link - 1, link)
    leaves = torch.cat([torch.zeros_like(leaves[:1]), leaves])
    return (torch.roll(box, 1, dims=1).contiguous(),
            torch.roll(link, 1, dims=1).contiguous(), leaves)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("table", ["quad", "frontier"])
def test_mid_row_empty_never_visited(columns_glb, table, any_hit):
    """Empty slots mid-row (as nary_maps leaves them) are skipped: an
    empty slot's link read as a leaf would reach block 0, which no live
    link names, so block 0 is never visited; t (closest hit) and the
    bit (any hit) are the unrotated tables'.  The quad walk, and the
    frontier walk with its Batcher network."""
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=4,
                            device="cpu")
    box, link = getattr(td, f"{table}_box"), getattr(td, f"{table}_link")
    rbox, rlink, rleaves = _mid_row_empty_tables(box, link, td.leaves)
    empty = rlink == st.EMPTY
    assert (empty[:, :-1] & ~empty[:, 1:]).any()
    o, d = _rays(600, 12)
    t_lane = st.lane_limits(600, None, o.device)
    closest, anyhit = {"quad": (st.quad_closest_hit_plain,
                                st.quad_any_hit_plain),
                       "frontier": (fr.frontier_closest_hit_plain,
                                    fr.frontier_any_hit_plain)}[table]
    fn = anyhit if any_hit else closest
    want = fn(box, link, td.leaves, o, d, t_lane)
    visits = torch.zeros(rleaves.shape[0], dtype=torch.int64)
    got = fn(rbox, rlink, rleaves, o, d, t_lane, leaf_visits=visits)
    if any_hit:
        assert torch.equal(got, want) and got.any()
    else:
        assert torch.equal(got.t, want.t) and (got.t < MISS_T).any()
    assert visits[0] == 0 and visits[1:].sum() > 0
