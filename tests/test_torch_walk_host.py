"""The walks' CUDA source on the CPU: the pair, quad and frontier kernels
of ``csrc/stack_walk.cuh`` (``pair_traverse.cu``, ``stack_traverse.cu``,
``frontier_traverse.cu``) and the skip and wide kernels
(``skip_traverse.cu``) compiled with g++ against ``csrc/host_mock.h``, a
stand-in for the CUDA runtime that runs each warp as 32 threads voting
through a barrier, and held bitwise to their plain PyTorch versions.

What this covers that the CPU tests of the plain versions cannot: the
kernels' own control flow — postponed leaves and their near-first order
in a pair row, preorder in a skip walk, slot order in a wide tile or a
frontier node, the frontier kernels' leaf entries and the closest hit's
Batcher network, persistent warps and ray refill on a small grid (the
mock reports 2 SMs of 2 blocks, so warps take many batches), the
instance cache of two-level scenes, the statistics builds — on the
columns scene flat and two-level, exact and coefficient leaves,
frontier widths 16 and 32, with a third of the lanes inactive and a ray
count that is no multiple of 32.
The comparison is exact (t, tri, u, v and the any-hit bit): the sources
are built with ``-ffp-contract=off``, as nvcc builds them with
``-fmad=false``, and perform the plain versions' float operations in
the same order.  What the card's compiler accepts is not checked here.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import kernels, mxu_mt
from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vulkan_pathtracer_tpu_torch", "csrc")
UNITS = ("stack_traverse.cu", "pair_traverse.cu", "skip_traverse.cu",
         "frontier_traverse.cu")
FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-fPIC",
         "-x", "c++"]
LAUNCH = re.compile(r"(\w+(?:<[^;{}]*?>)?)<<<(.*?)>>>\(", re.S)
MOCK_LAUNCH = r"vkpt_mock::launch(vkpt_mock::Cfg{\2}, \1, "


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The walk's launchers built for the CPU: the sources copied with
    each ``k<<<cfg>>>(args)`` rewritten to the mock's launcher and a
    ``cuda_runtime.h`` that includes the mock; one g++ per unit."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("walk_host")
    for name in os.listdir(CSRC):
        if name.endswith((".cu", ".cuh", ".h")):
            with open(os.path.join(CSRC, name)) as f:
                text = LAUNCH.sub(MOCK_LAUNCH, f.read())
            (out / name).write_text(text)
    (out / "cuda_runtime.h").write_text('#include "host_mock.h"\n')
    procs = [subprocess.Popen(
        ["g++", *FLAGS, "-I", str(out), "-c", "-o", str(out / (u + ".o")),
         str(out / u)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for u in UNITS]
    logs = [p.communicate()[0] for p in procs]
    for u, p, log in zip(UNITS, procs, logs):
        assert p.returncode == 0, f"g++ {u}:\n{log}"
    lib_path = out / "libwalk_host.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(lib_path),
                    *(str(out / (u + ".o")) for u in UNITS)], check=True)
    return kernels.bind(ctypes.CDLL(str(lib_path)))


def _ptrs(*tensors):
    return [None if x is None else x.data_ptr() for x in tensors]


def _outputs(n):
    return (torch.full((n,), -7.0), torch.full((n,), -7, dtype=torch.int32),
            torch.full((n,), -7.0), torch.full((n,), -7.0))


def _launch(fn, *args, n):
    """Call a launcher with a fresh batch counter and no stream."""
    batches = torch.full((1,), 12345, dtype=torch.int32)
    assert fn(*args, batches.data_ptr(), None) == 0


def pair_host(lib, any_hit, box, link, leaves, o, d, t_lane, inst_inv=None,
              mb_bits=0, inst_feat=None):
    n = o.shape[0]
    coef = int(leaves.shape[2] == mxu_mt.COLS)
    head = (*_ptrs(box, link, leaves), leaves.shape[1], coef,
            *_ptrs(inst_inv, inst_feat), mb_bits, *_ptrs(o, d, t_lane), n)
    if any_hit:
        hit = torch.full((n,), 7, dtype=torch.uint8)
        _launch(lib.vkpt_pair_any_hit, *head, hit.data_ptr(), n=n)
        return hit.bool()
    out = _outputs(n)
    _launch(lib.vkpt_pair_closest_hit, *head, *_ptrs(*out), n=n)
    return out


def quad_host(lib, any_hit, box, link, leaves, o, d, t_lane):
    n = o.shape[0]
    coef = int(leaves.shape[2] == mxu_mt.COLS)
    head = (*_ptrs(box, link, leaves), leaves.shape[1], coef,
            *_ptrs(o, d, t_lane), n)
    if any_hit:
        hit = torch.full((n,), 7, dtype=torch.uint8)
        _launch(lib.vkpt_quad_any_hit, *head, hit.data_ptr(), n=n)
        return hit.bool()
    out = _outputs(n)
    _launch(lib.vkpt_quad_closest_hit, *head, *_ptrs(*out), n=n)
    return out


def skip_host(lib, nodes, leaves, o, d, t_lane, inst_inv=None, mb_bits=0):
    n = o.shape[0]
    out = _outputs(n)
    _launch(lib.vkpt_skip_closest_hit, *_ptrs(nodes), nodes.shape[0] // 8,
            *_ptrs(leaves), leaves.shape[1], *_ptrs(inst_inv), mb_bits,
            *_ptrs(o, d, t_lane), n, *_ptrs(*out), n=n)
    return out


def frontier_host(lib, any_hit, box, link, leaves, o, d, t_lane):
    n = o.shape[0]
    head = (*_ptrs(box, link), box.shape[1], *_ptrs(leaves), leaves.shape[1],
            int(leaves.shape[2] == mxu_mt.COLS), *_ptrs(o, d, t_lane), n)
    if any_hit:
        hit = torch.full((n,), 7, dtype=torch.uint8)
        _launch(lib.vkpt_frontier_any_hit, *head, hit.data_ptr(), n=n)
        return hit.bool()
    out = _outputs(n)
    _launch(lib.vkpt_frontier_closest_hit, *head, *_ptrs(*out), n=n)
    return out


def wide_host(lib, tiles, leaves, o, d, t_lane):
    n = o.shape[0]
    out = _outputs(n)
    _launch(lib.vkpt_wide_closest_hit, *_ptrs(tiles), tiles.shape[0] // 8,
            *_ptrs(leaves), leaves.shape[1], *_ptrs(o, d, t_lane), n,
            *_ptrs(*out), n=n)
    return out


def stats_host(lib, any_hit, kind, box, link, leaves, o, d, t_lane,
               inst_inv=None, mb_bits=0, inst_feat=None):
    """The statistics build of kernel ``kind`` (quad, pair, skip or wide
    with ``box`` the skip records or wide tiles and ``link`` None, or
    frontier; quad, pair and frontier take exact or coefficient
    leaves)."""
    n = o.shape[0]
    out = _outputs(n)
    hit = torch.full((n,), 7, dtype=torch.uint8)
    counters = torch.zeros(lib.vkpt_stack_stats_count(), dtype=torch.int64)
    if kind == "wide":
        _launch(lib.vkpt_wide_stats, *_ptrs(box), box.shape[0] // 8,
                *_ptrs(leaves), leaves.shape[1], *_ptrs(o, d, t_lane), n,
                *_ptrs(*out), counters.data_ptr(), n=n)
        return out, counters.tolist()
    if kind == "skip":
        lead = (0, *_ptrs(box), box.shape[0] // 8, *_ptrs(leaves),
                leaves.shape[1], *_ptrs(inst_inv), mb_bits)
    elif kind == "frontier":
        lead = (int(any_hit), *_ptrs(box, link), box.shape[1], *_ptrs(leaves),
                leaves.shape[1], int(leaves.shape[2] == mxu_mt.COLS))
    else:
        lead = (int(any_hit), *_ptrs(box, link, leaves), leaves.shape[1],
                int(leaves.shape[2] == mxu_mt.COLS))
        if kind == "pair":
            lead = (*lead, *_ptrs(inst_inv, inst_feat), mb_bits)
    fn = getattr(lib, f"vkpt_{kind}_stats")
    _launch(fn, *lead, *_ptrs(o, d, t_lane), n, *_ptrs(*out),
            hit.data_ptr(), counters.data_ptr(), n=n)
    return (hit.bool() if any_hit else out), counters.tolist()


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = torch.from_numpy(rng.random(n) < 0.67)
    return (torch.from_numpy(origins), torch.from_numpy(d.astype(np.float32)),
            active)


def _assert_closest(got, ref):
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.fixture(scope="module")
def scenes(columns_glb):
    host = gltf.load(columns_glb)
    return {
        "flat": build_device_scene(host, max_leaf_size=8, device="cpu",
                                   mt="mxu", wide=True),
        "flat32": build_device_scene(host, max_leaf_size=8, device="cpu",
                                     mt="mxu", frontier_width=32),
        "instanced": build_instanced_scene(host, max_leaf_size=14,
                                           device="cpu", mt="mxu")}


@pytest.mark.parametrize("coef", [False, True], ids=["exact", "coef"])
@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_pair_kernels_match_plain(host_lib, scenes, kind, coef):
    """Both pair kernels of the kept designs, bitwise their plain
    versions; with exact leaves the any hit equals the closest-hit mask."""
    scene = scenes[kind]
    o, d, active = _rays(999, seed=5 + coef)
    args = st.pair_args(scene, o, d, active, coef)
    ref = st.pair_closest_hit_plain(*args)
    assert 100 < int((ref.t < MISS_T).sum()) < int(active.sum())
    _assert_closest(pair_host(host_lib, False, *args), ref)
    occ = pair_host(host_lib, True, *args)
    assert torch.equal(occ, st.pair_any_hit_plain(*args))
    if not coef:
        assert torch.equal(occ, ref.t < MISS_T)
    assert not occ[~active].any()


@pytest.mark.parametrize("coef", [False, True], ids=["exact", "coef"])
def test_quad_kernels_match_plain(host_lib, scenes, coef):
    """The quad kernels, which share the walk, bitwise their plain
    versions."""
    o, d, active = _rays(777, seed=9 + coef)
    args = st.quad_args(scenes["flat"], o, d, active, coef)
    _assert_closest(quad_host(host_lib, False, *args),
                    st.quad_closest_hit_plain(*args))
    assert torch.equal(quad_host(host_lib, True, *args),
                       st.quad_any_hit_plain(*args))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_pair_statistics_build(host_lib, scenes, kind, any_hit):
    """The pair kernels' statistics build: the plain versions' outputs,
    one traced ray per active lane, the plain versions' leaf visits
    (the closest hit's own sequence; the any hit's slot-order walk), and
    on a two-level scene instance changes no more than leaf visits."""
    scene = scenes[kind]
    o, d, active = _rays(640, seed=13)
    args = st.pair_args(scene, o, d, active)
    out, counters = stats_host(host_lib, any_hit, "pair", *args[:6],
                               inst_inv=args[6], mb_bits=args[7])
    plain_stats = {}
    if any_hit:
        assert torch.equal(out, st.pair_any_hit_plain(*args,
                                                      stats=plain_stats))
    else:
        _assert_closest(out, st.pair_closest_hit_plain(*args,
                                                       stats=plain_stats))
    c = dict(zip(kernels.STACK_STATS, counters))
    hist = counters[len(kernels.STACK_STATS):]
    assert c["rays"] == int(active.sum()) == sum(hist)
    assert 0 < c["deepest"] <= st.STACK_SLOTS[2]
    assert c["leaf_visits"] == plain_stats["leaf_visits"]
    if kind == "instanced":
        assert 0 < c["instance_changes"] <= c["leaf_visits"]
        assert c["instance_changes"] == plain_stats["instance_changes"]
    else:
        assert c["instance_changes"] == 0


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["quad", "pair", "pair_instanced"])
def test_coefficient_statistics_build(host_lib, scenes, kind, any_hit):
    """The statistics builds of the quad and pair kernels with
    coefficient leaves: the plain versions' outputs and leaf visits, and
    their counts of the coefficient test's exits (triangles tested, then
    rejected at det <= 0, at u' < 0, at the v' window; the any hit up to
    its first accepted triangle), of instance changes (two-level), and
    one shared-row count per leaf visit (the mock's lanes never match)."""
    scene = scenes["instanced" if kind == "pair_instanced" else "flat"]
    o, d, active = _rays(640, seed=19)
    fam = kind.split("_")[0]
    args = (st.pair_args if fam == "pair" else st.quad_args)(
        scene, o, d, active, True)
    if fam == "pair":
        out, counters = stats_host(host_lib, any_hit, "pair", *args[:6],
                                   inst_inv=args[6], mb_bits=args[7],
                                   inst_feat=args[8])
    else:
        out, counters = stats_host(host_lib, any_hit, "quad", *args)
    plain = getattr(st, f"{fam}_{'any' if any_hit else 'closest'}_hit_plain")
    stats = {}
    ref = plain(*args, stats=stats)
    if any_hit:
        assert torch.equal(out, ref)
    else:
        _assert_closest(out, ref)
    c = dict(zip(kernels.STACK_STATS, counters))
    assert c["rays"] == int(active.sum())
    assert c["leaf_visits"] == stats["leaf_visits"] > 0
    for key in ("tri_tested", "tri_back", "tri_u", "tri_v"):
        assert c[key] == stats[key], key
    assert min(c["tri_back"], c["tri_u"], c["tri_v"]) > 0
    block = scene.max_leaf_size
    if any_hit:
        assert c["tri_tested"] < c["leaf_visits"] * block
    else:
        assert c["tri_tested"] == c["leaf_visits"] * block
    if kind == "pair_instanced":
        assert 0 < c["instance_changes"] == stats["instance_changes"]
    else:
        assert c["instance_changes"] == 0
    assert c["share_1"] == c["leaf_visits"]
    assert sum(c[f"share_{k}"] for k in range(2, 33)) == 0


def test_pair_leaf_order_decides_ties(host_lib):
    """Two leaf children whose triangles lie at the same t: the closest
    hit tests the nearer box first (slot 1 here, its box starts closer),
    so slot 1's triangle wins the tie under the strict-less update, as
    in the plain version and pallas_pair.py:807."""
    def tri(z):
        return [-1.0, -1.0, z, 0.0, 4.0, 0.0, 4.0, 0.0, 0.0]

    leaves = torch.tensor([[tri(5.0)], [tri(5.0)]])
    box = torch.tensor([[[-2.0, -2.0, 4.0, 4.0, 4.0, 6.0],
                         [-2.0, -2.0, 1.0, 4.0, 4.0, 6.0]]])
    link = torch.tensor([[-1, -2]], dtype=torch.int32)
    n = 96
    o = torch.zeros((n, 3))
    o[:, :2] = torch.linspace(-0.5, 0.5, n)[:, None]
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    t_lane = st.lane_limits(n, None, "cpu")
    ref = st.pair_closest_hit_plain(box, link, leaves, o, d, t_lane)
    assert (ref.t == 5.0).all() and (ref.tri == 1).all()
    _assert_closest(pair_host(host_lib, False, box, link, leaves, o, d,
                              t_lane), ref)


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_skip_kernel_matches_plain(host_lib, scenes, kind):
    """The skip kernel of the kept design (postponed leaves; two-level:
    the instance cache), bitwise its plain version."""
    o, d, active = _rays(999, seed=21)
    args = sk.skip_args(scenes[kind], o, d, active)
    ref = sk.skip_closest_hit_plain(*args)
    assert 100 < int((ref.t < MISS_T).sum()) < int(active.sum())
    _assert_closest(skip_host(host_lib, *args), ref)


@pytest.mark.parametrize("coef", [False, True], ids=["exact", "coef"])
@pytest.mark.parametrize("width", [16, 32])
def test_frontier_any_hit_matches_plain(host_lib, scenes, width, coef):
    """The frontier any hit on the shared walk (slot order, leaf entries,
    refill), bitwise its plain version; with exact leaves the closest
    hit's mask too."""
    scene = scenes["flat" if width == 16 else "flat32"]
    assert scene.frontier_box.shape[1] == width
    o, d, active = _rays(999, seed=31 + coef)
    args = fr.frontier_args(scene, o, d, active, coef)
    occ = frontier_host(host_lib, True, *args)
    ref = fr.frontier_any_hit_plain(*args)
    assert 100 < int(ref.sum()) < int(active.sum())
    assert torch.equal(occ, ref)
    if not coef:
        assert torch.equal(occ, fr.frontier_closest_hit_plain(*args).t
                           < MISS_T)
    assert not occ[~active].any()


@pytest.mark.parametrize("coef", [False, True], ids=["exact", "coef"])
@pytest.mark.parametrize("width", [16, 32])
def test_frontier_closest_hit_matches_plain(host_lib, scenes, width, coef):
    """The frontier closest hit (near-first, the Batcher network, leaf
    slots in slot order), bitwise its plain version."""
    scene = scenes["flat" if width == 16 else "flat32"]
    o, d, active = _rays(999, seed=41 + coef)
    args = fr.frontier_args(scene, o, d, active, coef)
    ref = fr.frontier_closest_hit_plain(*args)
    assert 100 < int((ref.t < MISS_T).sum()) < int(active.sum())
    _assert_closest(frontier_host(host_lib, False, *args), ref)
    assert (ref.t[~active] == MISS_T).all()


def test_wide_kernel_matches_plain(host_lib, scenes):
    """The wide kernel (leaf slots in slot order against the tightening
    t_best), bitwise its plain version."""
    o, d, active = _rays(999, seed=43)
    args = sk.wide_args(scenes["flat"], o, d, active)
    ref = sk.wide_closest_hit_plain(*args)
    assert 100 < int((ref.t < MISS_T).sum()) < int(active.sum())
    _assert_closest(wide_host(host_lib, *args), ref)


@pytest.mark.parametrize("kind", ["flat", "instanced", "frontier",
                                  "frontier_coef", "frontier_closest",
                                  "frontier_closest_coef", "wide"])
def test_skip_and_frontier_statistics_build(host_lib, scenes, kind):
    """The statistics builds of the skip and wide kernels and of both
    frontier kernels: the plain versions' outputs and leaf visits (each
    ray tests its leaves in its plain version's order), one traced ray
    per active lane, instance changes on the two-level scene only, no
    stack in the skip and wide walks; the frontier closest hit's count
    of visited nodes by hit internal children, the plain version's."""
    o, d, active = _rays(640, seed=17)
    stats = {}
    if kind.startswith("frontier"):
        args = fr.frontier_args(scenes["flat"], o, d, active,
                                kind.endswith("coef"))
        if "closest" in kind:
            out, counters = stats_host(host_lib, False, "frontier", *args)
            _assert_closest(out, fr.frontier_closest_hit_plain(
                *args, stats=stats))
        else:
            out, counters = stats_host(host_lib, True, "frontier", *args)
            assert torch.equal(out, fr.frontier_any_hit_plain(*args,
                                                              stats=stats))
    elif kind == "wide":
        args = sk.wide_args(scenes["flat"], o, d, active)
        out, counters = stats_host(host_lib, False, "wide", args[0], None,
                                   *args[1:])
        _assert_closest(out, sk.wide_closest_hit_plain(*args, stats=stats))
    else:
        args = sk.skip_args(scenes[kind], o, d, active)
        out, counters = stats_host(host_lib, False, "skip", args[0], None,
                                   *args[1:])
        _assert_closest(out, sk.skip_closest_hit_plain(*args, stats=stats))
    c = dict(zip(kernels.STACK_STATS, counters))
    hist = counters[len(kernels.STACK_STATS):]
    assert c["rays"] == int(active.sum()) == sum(hist)
    assert c["leaf_visits"] == stats["leaf_visits"] > 0
    assert (c["instance_changes"] > 0) == (kind == "instanced")
    assert c["instance_changes"] <= c["leaf_visits"]
    if kind.startswith("frontier"):
        assert 0 < c["deepest"] <= st.STACK_SLOTS[16]
    else:
        assert c["deepest"] == 0 and hist[0] == c["rays"]
    if "closest" in kind:
        assert [c[f"inner_{k}"] for k in range(3)] == [
            stats[f"inner_{k}"] for k in range(3)]
        assert sum(c[f"inner_{k}"] for k in range(3)) == stats["node_visits"]
        assert min(c[f"inner_{k}"] for k in range(3)) > 0
    else:
        assert c["inner_0"] == c["inner_1"] == c["inner_2"] == 0
    tri = ("tri_tested", "tri_back", "tri_u", "tri_v")
    if kind.endswith("coef"):
        assert [c[k] for k in tri] == [stats[k] for k in tri]
        assert c["tri_tested"] > 0
    else:
        assert [c[k] for k in tri] == [0, 0, 0, 0]
    assert c["share_1"] == c["leaf_visits"]


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_skip_plain_counts_early_exits(scenes, kind):
    """The skip plain version's statistics count where the kernel's
    early-exit triangle test stops (back face, u, v), which the bound
    subtracts, and leave its outputs bitwise as they were: every ray
    with a hit passed all three tests at least once."""
    o, d, active = _rays(777, seed=23)
    args = sk.skip_args(scenes[kind], o, d, active)
    stats = {}
    ref = sk.skip_closest_hit_plain(*args)
    _assert_closest(sk.skip_closest_hit_plain(*args, stats=stats), ref)
    tested = stats["leaf_visits"] * scenes[kind].leaves.shape[1]
    exits = stats["tri_back"] + stats["tri_u"] + stats["tri_v"]
    assert min(stats["tri_back"], stats["tri_u"], stats["tri_v"]) > 0
    assert tested - exits >= int((ref.t < MISS_T).sum()) > 0


def _skip_records(order):
    """(8*3, 8) skip records of a root and two leaf records, the leaves
    in preorder ``order`` in every octant block: block-1 leaf values 0
    (box z 4..6) and 1 (box z 1..6)."""
    leaf_box = {0: [-2.0, -2.0, 4.0, 4.0, 4.0, 6.0],
                1: [-2.0, -2.0, 1.0, 4.0, 4.0, 6.0]}
    recs = [([-2.0, -2.0, 0.0, 4.0, 4.0, 6.0], 3, -1)]
    recs += [(leaf_box[v], 2 + k, v) for k, v in enumerate(order)]
    block = np.zeros((3, 8), np.float32)
    for r, (box, skip, leaf) in enumerate(recs):
        block[r, :6] = box
        block[r, 6:8] = np.array([skip, leaf], np.int32).view(np.float32)
    return torch.from_numpy(np.tile(block, (8, 1)))


@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["0-1", "1-0"])
def test_skip_preorder_decides_ties(host_lib, order):
    """Two leaves whose triangles lie at the same t: the first leaf in
    the ray's preorder wins the tie under the strict-less update, so
    swapping the two records swaps the winner; the postponed kernel
    keeps each ray's preorder (some lanes miss the root and finish at
    once, the others wait at a leaf for the warp's leaf phase)."""
    def tri(z):
        return [-1.0, -1.0, z, 0.0, 4.0, 0.0, 4.0, 0.0, 0.0]

    leaves = torch.tensor([[tri(5.0)], [tri(5.0)]])
    nodes = _skip_records(order)
    n = 96
    o = torch.zeros((n, 3))
    o[:, 0] = torch.linspace(-3.0, 0.5, n)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    t_lane = st.lane_limits(n, None, "cpu")
    ref = sk.skip_closest_hit_plain(nodes, leaves, o, d, t_lane)
    hit = ref.t < MISS_T
    assert 0 < int(hit.sum()) < n and (ref.t[hit] == 5.0).all()
    assert (ref.tri[hit] == order[0]).all()
    _assert_closest(skip_host(host_lib, nodes, leaves, o, d, t_lane), ref)


def _tie_rays(n, x0, x1):
    """n rays along +z from z = 0, spread along x from x0 to x1."""
    o = torch.zeros((n, 3))
    o[:, 0] = torch.linspace(x0, x1, n)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    return o, d, st.lane_limits(n, None, "cpu")


def _tie_leaves():
    """Two block-1 leaves whose triangles lie at the same t (z = 5)."""
    tri = [-1.0, -1.0, 5.0, 0.0, 4.0, 0.0, 4.0, 0.0, 0.0]
    return torch.tensor([[tri], [tri]])


@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["0-1", "1-0"])
def test_frontier_slot_order_decides_ties(host_lib, order, width):
    """Two leaf slots of one frontier node whose triangles lie at the same
    t: the closest hit tests a node's leaf slots in slot order, so the
    lower slot wins the tie under the strict-less update although the
    other slot's box starts nearer (slots 3 and 9 hold the two leaves, in
    the order given); the postponed walk keeps it (some lanes miss both
    boxes and finish at once)."""
    box = torch.zeros((1, width, 6))
    link = torch.full((1, width), st.EMPTY, dtype=torch.int32)
    box[0, 3] = torch.tensor([-2.0, -2.0, 4.0, 4.0, 4.0, 6.0])
    box[0, 9] = torch.tensor([-2.0, -2.0, 1.0, 4.0, 4.0, 6.0])
    link[0, 3], link[0, 9] = -(order[0] + 1), -(order[1] + 1)
    leaves = _tie_leaves()
    o, d, t_lane = _tie_rays(96, -3.0, 0.5)
    ref = fr.frontier_closest_hit_plain(box, link, leaves, o, d, t_lane)
    hit = ref.t < MISS_T
    assert 0 < int(hit.sum()) < 96 and (ref.t[hit] == 5.0).all()
    assert (ref.tri[hit] == order[0]).all()
    _assert_closest(frontier_host(host_lib, False, box, link, leaves, o, d,
                                  t_lane), ref)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["0-1", "1-0"])
def test_wide_slot_order_decides_ties(host_lib, order):
    """Two leaf slots of one wide tile whose triangles lie at the same t:
    the lower slot wins the tie (slots 2 and 5 hold the two leaves' first
    triangles, in the order given; the other slots are empty), in the
    plain version and in the postponed kernel."""
    tile = np.zeros((8, 8), np.float32)
    tile[:, 0:3], tile[:, 3:6], tile[:, 6] = 3e38, -3e38, -2.0
    tile[2, :7] = [-2.0, -2.0, 4.0, 4.0, 4.0, 6.0, order[0]]
    tile[5, :7] = [-2.0, -2.0, 1.0, 4.0, 4.0, 6.0, order[1]]
    tile[0, 7] = 1.0   # the skip pointer: past the last tile
    tiles = torch.from_numpy(np.tile(tile[None], (8, 1, 1)))
    leaves = _tie_leaves()
    o, d, t_lane = _tie_rays(96, -3.0, 0.5)
    ref = sk.wide_closest_hit_plain(tiles, leaves, o, d, t_lane)
    hit = ref.t < MISS_T
    assert 0 < int(hit.sum()) < 96 and (ref.t[hit] == 5.0).all()
    assert (ref.tri[hit] == order[0]).all()
    _assert_closest(wide_host(host_lib, tiles, leaves, o, d, t_lane), ref)


def test_launch_guard_and_batch_counters(monkeypatch):
    """kernels._launch: the tensors' device is made current around the
    launch, the launch goes to that device's current stream, and each
    (device, stream) gets its own batch counter, reused on that stream.
    The CUDA calls are replaced by recorders (this runs on the CPU)."""
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append(None)

    stream_of = {"cpu": 77}
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type(
        "S", (), {"cuda_stream": stream_of[device.type]})())
    monkeypatch.setattr(kernels, "_BATCHES", {})
    calls = []

    def launcher(*args):
        calls.append((list(entered), args))
        return 0

    dev = torch.device("cpu")
    kernels._launch("k", dev, launcher, 1, 2, batches=100)
    kernels._launch("k", dev, launcher, 3, batches=5)
    counter = kernels._BATCHES[(dev, 77)]
    assert calls == [([dev], (1, 2, counter.data_ptr(), 77)),
                     ([dev, None, dev], (3, counter.data_ptr(), 77))]
    stream_of["cpu"] = 78
    kernels._launch("k", dev, launcher, batches=5)
    other = kernels._BATCHES[(dev, 78)]
    assert other.data_ptr() != counter.data_ptr()
    assert set(kernels._BATCHES) == {(dev, 77), (dev, 78)}
    kernels._launch("k", dev, launcher, 4)   # no counter: not a stack kernel
    assert calls[-1][1] == (4, 78)
    with pytest.raises(RuntimeError, match="k launch failed: CUDA error 9"):
        kernels._launch("k", dev, lambda *a: 9)
    with pytest.raises(ValueError, match="2\\^31"):
        kernels._batches(2 ** 31, dev, 77)
