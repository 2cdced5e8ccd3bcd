"""PyTorch port vs JAX: the frontier (16- and 32-wide) kernels.

- The bake: the port's frontier tables equal the JAX bake's
  ``bvh_frontier`` coefficient tiles bitwise at widths 16 and 32 —
  the guard-dilated planes of every slot, the links, and NaN planes
  with enc -1 in empty slots where the port has a zero box and EMPTY.
- The Batcher network: the port's comparator list is JAX's, sorts every
  0/1 input (16) and random keys (32), and is the list compiled into
  csrc/sortnet.cuh.
- The plain versions against ``pallas_frontier_closest_hit`` and
  ``pallas_frontier_any_hit`` in interpret mode: exact leaves at the
  JAX suite's tolerances (hit masks equal, t allclose 1e-5, tri
  agreement >= 0.999), the any-hit bit equal to the port's own
  ``closest.t < MISS_T``; coefficient leaves (``VKPT_MT=mxu`` around
  the JAX call) at tests/test_mxu_mt.py's relaxed budget.
- A 64x48 frame with the frontier kernels on every bounce against the
  JAX pipeline with ``VKPT_KERNEL_*=frontier`` and
  ``VKPT_ANYHIT_KERNEL=frontier``.
"""

import itertools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mxu import assert_relaxed_parity
from tests.test_torch_tiers import frame_pair
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.ops import pallas_frontier as pf
from vulkan_pathtracer_tpu.ops.intersect import MISS_T
from vulkan_pathtracer_tpu.ops.mxu_mt import ensure_mt_coefs
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

LEAF = 4   # interpret mode unrolls the leaf loop: small blocks compile fast


@pytest.fixture(scope="module")
def scenes(request):
    """width -> (JAX bake, port bake) of the columns scene at leaf 4,
    both with coefficient tables."""
    cache = {}

    def get(width):
        if width not in cache:
            path = request.getfixturevalue("columns_glb")
            old = os.environ.get("VKPT_FRONTIER_WIDTH")
            os.environ["VKPT_FRONTIER_WIDTH"] = str(width)
            try:
                jd = jax_build(jgltf.load(path), build_bvh=True,
                               max_leaf_size=LEAF)
            finally:
                if old is None:
                    del os.environ["VKPT_FRONTIER_WIDTH"]
                else:
                    os.environ["VKPT_FRONTIER_WIDTH"] = old
            ensure_mt_coefs(jd)
            cache[width] = (jd, build_device_scene(
                gltf.load(path), max_leaf_size=LEAF, device="cpu", mt="mxu",
                frontier_width=width))
        return cache[width]
    return get


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


@pytest.mark.parametrize("width", [16, 32])
def test_tables_match_jax_tiles(scenes, width):
    jd, td = scenes(width)
    tiles = np.asarray(jd.bvh_frontier)
    assert int(jd.bvh_frontier_src.shape[1]) == width
    box, link = td.frontier_box.numpy(), td.frontier_link.numpy()
    assert box.shape == (tiles.shape[0], width, 6)
    empty = link == fr.EMPTY
    assert empty.any() and (~empty).sum() > tiles.shape[0]
    for a in range(3):
        lo = tiles[:, a, a * width:(a + 1) * width]
        hi = tiles[:, a, (3 + a) * width:(4 + a) * width]
        assert np.array_equal(np.isnan(lo), empty)
        assert np.array_equal(box[:, :, a][~empty], lo[~empty])
        assert np.array_equal(box[:, :, 3 + a][~empty], hi[~empty])
    assert (box[empty] == 0).all()
    enc = tiles[:, 6, :width]
    assert np.array_equal(link[~empty], enc[~empty].astype(np.int64))
    assert (enc[empty] == -1).all()


def test_tables_from_jax_round_trip(scenes):
    jd, td = scenes(16)
    box, link = fr.tables_from_jax(np.asarray(jd.bvh_frontier), 16)
    assert np.array_equal(box, td.frontier_box.numpy())
    assert np.array_equal(link, td.frontier_link.numpy())


def test_guard_dilates_every_box(scenes):
    """The guard only widens: with guard 0 the bake gives the exact
    child boxes, which the dilated ones strictly contain."""
    from vulkan_pathtracer_tpu_torch.ops.bvh import build_bvh_host
    from vulkan_pathtracer_tpu_torch.ops.bvh import pad_leaves_to_blocks

    _, td = scenes(16)
    n = td.num_triangles
    bvh = build_bvh_host(td.tri_v0[:n].numpy(), td.tri_e1[:n].numpy(),
                         td.tri_e2[:n].numpy(), max_leaf_size=LEAF)
    pad_leaves_to_blocks(bvh, block=LEAF)
    exact, link0 = fr.build_frontier_tables(bvh, LEAF, 16, guard=0.0)
    box, link = fr.build_frontier_tables(bvh, LEAF, 16)
    assert np.array_equal(link, link0)
    live = link != fr.EMPTY
    assert (box[..., :3][live] < exact[..., :3][live]).all()
    assert (box[..., 3:][live] > exact[..., 3:][live]).all()
    assert fr.GUARD == pf._guard() == 2.0 ** -7


@pytest.mark.parametrize("n", [16, 32])
def test_batcher_network(n):
    net = fr.batcher_oem(n)
    assert net == pf._batcher_oem(n)
    assert len(net) == {16: 63, 32: 191}[n]
    rng = np.random.default_rng(n)
    if n == 16:   # the 0/1 principle: every binary input
        keys = np.array(list(itertools.product([0, 1], repeat=16)))
    else:
        keys = rng.random((4096, n))
    keys = keys.astype(np.float32)
    for a, b in net:
        lo = np.minimum(keys[:, a], keys[:, b])
        hi = np.maximum(keys[:, a], keys[:, b])
        keys[:, a], keys[:, b] = lo, hi
    assert (np.diff(keys, axis=1) >= 0).all()
    src = open(os.path.join(os.path.dirname(st.__file__), "..", "csrc",
                            "sortnet.cuh")).read()
    body = src.split(f"#define VKPT_BATCHER{n}(CS)")[1].split("\n\n")[0]
    pairs = [tuple(map(int, p)) for p in re.findall(r"CS\((\d+), (\d+)\)",
                                                    body)]
    assert pairs == net


def test_network_order_is_the_kernels(scenes):
    """The plain version orders internal children with the network (not
    a stable sort): equal keys come out in the network's order."""
    keys = torch.tensor([[1.0, 1.0, 0.5, 1.0] + [3e38] * 12])
    lk = torch.arange(16, dtype=torch.int32)[None]
    skeys, child = st._sort_children(keys, lk, fr.batcher_oem(16))
    assert skeys[0, 0] == 0.5 and child[0, 0] == 2
    assert sorted(child[0, 1:4].tolist()) == [0, 1, 3]


@pytest.mark.parametrize("width", [16, 32])
def test_closest_plain_matches_pallas_interpret(scenes, width):
    jd, td = scenes(width)
    o, d = _rays(1024, seed=width)
    ref = pf.pallas_frontier_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                         interpret=True, packet=512)
    got = fr.frontier_closest_hit(td, torch.from_numpy(o),
                                  torch.from_numpy(d))
    hit = np.asarray(ref.t) < MISS_T
    assert 100 < hit.sum() < 1024
    assert np.array_equal(got.t.numpy() < MISS_T, hit)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5,
                               atol=1e-5)
    assert (got.tri.numpy() == np.asarray(ref.tri)).mean() >= 0.999
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), rtol=1e-4,
                               atol=1e-5)
    # The frontier walk returns the quad kernel's hits up to ties.
    quad = st.quad_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(quad.t, got.t)


def test_any_plain_matches_pallas_interpret(scenes):
    jd, td = scenes(16)
    o, d = _rays(1024, seed=7)
    active = np.random.default_rng(3).random(1024) < 0.8
    ref = pf.pallas_frontier_any_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(active), interpret=True,
                                     packet=512)
    act = torch.from_numpy(active)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = fr.frontier_any_hit(td, o_t, d_t, act)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    closest = fr.frontier_closest_hit(td, o_t, d_t, act)
    assert torch.equal(got, closest.t < MISS_T)
    assert not got[~act].any() and got.sum() > 100


def test_coefficient_leaves_match_pallas_interpret(scenes, monkeypatch):
    jd, td = scenes(16)
    o, d = _rays(1024, seed=11)
    monkeypatch.setenv("VKPT_MT", "mxu")
    ref = pf.pallas_frontier_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                         interpret=True, packet=512)
    ref_any = pf.pallas_frontier_any_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                         interpret=True, packet=512)
    monkeypatch.delenv("VKPT_MT")
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = fr.frontier_closest_hit(td, o_t, d_t, coef=True)
    assert_relaxed_parity(ref, got)
    occ = fr.frontier_any_hit(td, o_t, d_t, coef=True)
    assert (occ.numpy() != np.asarray(ref_any)).mean() <= 0.002
    assert (occ != (got.t < MISS_T)).float().mean() <= 0.002


def test_exact_leaves_above_14_are_refused(columns_glb):
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=28,
                            device="cpu", mt="mxu")
    o, d = map(torch.from_numpy, _rays(64, seed=2))
    with pytest.raises(ValueError, match="leaf <= 14"):
        fr.frontier_closest_hit(td, o, d)
    with pytest.raises(ValueError, match="leaf <= 14"):
        fr.frontier_any_hit(td, o, d)
    got = fr.frontier_closest_hit(td, o, d, coef=True)
    assert (got.t < MISS_T).any()


def test_frontier_frame_matches_jax(columns_glb, monkeypatch):
    tiers = {"kernel_primary": "frontier", "kernel_secondary": "frontier",
             "anyhit_kernel": "frontier"}
    ref, ref_rays, got, rays = frame_pair(columns_glb, LEAF, tiers,
                                          monkeypatch)
    assert rays == ref_rays > 64 * 48
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
