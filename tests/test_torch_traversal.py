"""PyTorch port vs JAX: ``--traversal`` (pallas_packet, pallas8, bvh,
brute) on the CPU.

Held to the JAX package:

- the bakes, bitwise: the flat 8-octant skip record (``bvh_packed``)
  at leaf 14 and 28, the 8-wide tiles (``bvh_wide_nodes``), the
  instanced 8-octant splice on the columns fixture and on a mirrored
  box pair; after ``update_instance_transforms`` the record's skips and
  leaves stay bitwise and its boxes match JAX's update within 1e-5
  (JAX transforms the boxes in f32, the port in f64 as its bake does);
- the skip kernel's plain version against each Pallas kernel it stands
  for, in interpret mode as tests/test_pallas.py runs them: kernel 5
  ``pallas_closest_hit`` flat and instanced, kernel 6 (``pipe=True``),
  kernel 7 (``group_mt`` 1 and 2 at packet 2048) and kernel 9
  ``pallas_dense_closest_hit`` flat, instanced and with ``hbm_leaves``;
  the wide plain version against kernel 8 ``pallas_wide_closest_hit``;
- the port's ``bvh_closest_hit`` against JAX's XLA ``bvh_closest_hit``,
  flat at leaf 28 and instanced;
- a 64x48 frame under each ``--traversal`` value against the JAX
  ``RenderPipeline`` with the same traversal.

Flat kernel checks and frames use leaf-4 blocks, instanced ones leaf
14: interpret mode unrolls the leaf loop (8 slots x block triangles in
kernel 8), and its compile time grows with the block.

Tolerances are the JAX suite's own (test_pallas.py:36-44): hit masks
equal, t within 1e-5, tri agreement >= 0.999, u within rtol 1e-4 —
a TPU packet descends when any lane hits and the port's cursor on its
own box test, so equal-t ties may resolve to another triangle.  Frames
are allclose 1e-5 (tests/test_torch_render.py: XLA and PyTorch need
not round the shading chain alike).
"""

import copy
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_scene import jax_scene_arrays
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_flat,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    build_instanced_scene as jax_inst,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    update_instance_transforms as jax_update,
)
from vulkan_pathtracer_tpu.ops import pallas_traverse as pt
from vulkan_pathtracer_tpu.ops.intersect import MISS_T
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit as jax_bvh
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    build_device_scene,
    scene_from_jax_arrays,
)
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
    update_instance_transforms,
)
from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
from vulkan_pathtracer_tpu_torch.ops.traverse import bvh_closest_hit
from vulkan_pathtracer_tpu_torch.render.pipeline import TRAVERSALS

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")


@pytest.fixture(scope="module")
def flat(columns_glb):
    """leaf -> (JAX flat bake, port flat bake with wide tiles)."""
    cache = {}

    def get(leaf):
        if leaf not in cache:
            cache[leaf] = (
                jax_flat(jgltf.load(columns_glb), build_bvh=True,
                         max_leaf_size=leaf),
                build_device_scene(gltf.load(columns_glb),
                                   max_leaf_size=leaf, device="cpu",
                                   wide=True))
        return cache[leaf]
    return get


@pytest.fixture(scope="module")
def mirrored_glb():
    """One box mesh, two instances: identity-scaled and X-mirrored."""
    from assets import procedural as pr

    prim = pr.box_prim((0, 0, 0), (1, 1, 1), 0)
    nodes = [pr.NodeDesc(mesh=0, translation=(-1.5, 0, 0)),
             pr.NodeDesc(mesh=0, translation=(1.5, 0, 0),
                         scale=(-1.0, 1.0, 1.0))]
    path = tempfile.mktemp(suffix=".glb")
    pr.write_glb(path, meshes=[[prim]],
                 materials=[pr.MaterialDesc(base_color=(1, 0, 0, 1))],
                 nodes=nodes)
    return path


@pytest.fixture(scope="module")
def inst(request):
    """name -> (JAX instanced bake, port instanced bake) at leaf 14."""
    cache = {}

    def get(name):
        if name not in cache:
            path = request.getfixturevalue(f"{name}_glb")
            cache[name] = (jax_inst(jgltf.load(path), max_leaf_size=14),
                           build_instanced_scene(gltf.load(path),
                                                 max_leaf_size=14,
                                                 device="cpu"))
        return cache[name]
    return get


def _rays(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) < 0.8
    return origins, d.astype(np.float32), active


def _assert_hits_close(got, ref):
    hit = np.asarray(ref.t) < MISS_T
    assert np.array_equal(got.t.numpy() < MISS_T, hit)
    assert 100 < hit.sum() < hit.size
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5,
                               atol=1e-5)
    assert (got.tri.numpy() == np.asarray(ref.tri)).mean() >= 0.999
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), rtol=1e-4,
                               atol=1e-5)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


# -- bakes --------------------------------------------------------------------

@pytest.mark.parametrize("leaf", [14, 28])
def test_flat_skip_record_matches_jax(flat, leaf):
    jd, td = flat(leaf)
    assert np.array_equal(_bits(td.skip_nodes), _bits(jd.bvh_packed))
    assert np.array_equal(_bits(td.wide_nodes), _bits(jd.bvh_wide_nodes))
    bridged = scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")
    assert torch.equal(bridged.skip_nodes.view(torch.int32),
                       td.skip_nodes.view(torch.int32))
    assert torch.equal(bridged.wide_nodes, td.wide_nodes)


def test_flat_bake_without_bvh(columns_glb):
    """``--traversal brute`` bakes the triangles in load order and no
    traversal table, as JAX ``build_bvh=False`` does."""
    jd = jax_flat(jgltf.load(columns_glb), build_bvh=False)
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                            device="cpu", build_bvh=False)
    assert not td.has_bvh and not jd.has_bvh
    assert td.quad_box is None and td.wide_nodes is None
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_attr"):
        assert np.array_equal(_bits(getattr(td, f)), _bits(getattr(jd, f)))


@pytest.mark.parametrize("name", ["columns", "mirrored"])
def test_instanced_skip_record_matches_jax(inst, name):
    jd, td = inst(name)
    assert np.array_equal(_bits(td.skip_nodes), _bits(jd.bvh_packed))
    nn = td.skip_nodes.shape[0] // 8
    # The pair table is the octant-0 splice.
    src = td.inst_maps.pair_src
    assert int(src.max()) < nn
    assert torch.equal(td.pair_box[:, :, :3], td.skip_nodes[src, 0:3])


def test_update_refreshes_every_octant(inst, columns_glb):
    jd, td = inst("columns")
    host = gltf.load(columns_glb)
    transforms = np.stack([i.transform for i in host.instances]).astype(
        np.float64)
    transforms[:, :3, 3] += np.random.default_rng(5).uniform(
        -1.5, 1.5, size=(len(host.instances), 3))
    moved = update_instance_transforms(td, transforms)
    ref = np.asarray(jax_update(jd, transforms).bvh_packed)
    got = moved.skip_nodes.numpy()
    assert np.array_equal(_bits(got[:, 6:8]), _bits(ref[:, 6:8]))
    np.testing.assert_allclose(got[:, :6], ref[:, :6], rtol=1e-5, atol=1e-5)
    assert not np.array_equal(got[:, :6], td.skip_nodes.numpy()[:, :6])
    src = moved.inst_maps.pair_src
    assert torch.equal(moved.pair_box[:, :, 3:], moved.skip_nodes[src, 3:6])

    # Moving the instances keeps pallas_packet right: the hits of a
    # fresh bake of the moved scene.
    host2 = copy.deepcopy(host)
    for i, m in zip(host2.instances, transforms):
        i.transform = m.astype(np.float32)
    fresh = build_instanced_scene(host2, max_leaf_size=14, device="cpu")
    o, d, _ = map(torch.from_numpy, _rays(1024, seed=31))
    a = sk.skip_closest_hit(moved, o, d)
    b = sk.skip_closest_hit(fresh, o, d)
    assert torch.equal(a.t < MISS_T, b.t < MISS_T)
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (a.tri == b.tri).float().mean() >= 0.999


# -- the skip kernel's plain version vs Pallas kernels 5, 6, 7, 9 -------------

KERNEL_LEAF = 4


def _scene(kind, flat, inst):
    return inst("columns") if kind == "instanced" else flat(KERNEL_LEAF)


def _skip_vs(ref_fn, jd, td):
    o, d, active = _rays()
    ref = ref_fn(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(active))
    got = sk.skip_closest_hit(td, *map(torch.from_numpy, (o, d, active)))
    _assert_hits_close(got, ref)
    assert (got.tri.numpy()[~active] == -1).all()


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_skip_matches_packet_kernel(kind, flat, inst):
    """Kernel 5: pallas_closest_hit (the packet cursor)."""
    _skip_vs(lambda *a: pt.pallas_closest_hit(*a, interpret=True),
             *_scene(kind, flat, inst))


def test_skip_matches_pipe_kernel(flat):
    """Kernel 6: two interleaved packet chains (VKPT_PIPE)."""
    _skip_vs(lambda *a: pt.pallas_closest_hit(*a, interpret=True,
                                              pipe=True), *flat(KERNEL_LEAF))


@pytest.mark.parametrize("group_mt", [1, 2])
def test_skip_matches_group_mt_kernel(flat, group_mt):
    """Kernel 7: sublane-group MT (VKPT_GROUP_MT) at packet 2048."""
    _skip_vs(lambda *a: pt.pallas_closest_hit(
        *a, interpret=True, packet=2048, group_mt=group_mt),
        *flat(KERNEL_LEAF))


@pytest.mark.parametrize("kind,hbm", [("flat", False), ("instanced", False),
                                      ("flat", True)])
def test_skip_matches_dense_kernel(kind, hbm, flat, inst):
    """Kernel 9: the dense-row kernel, VMEM-resident or with the leaf
    table streamed from HBM."""
    _skip_vs(lambda *a: pt.pallas_dense_closest_hit(
        *a, interpret=True, hbm_leaves=hbm), *_scene(kind, flat, inst))


def test_wide_matches_wide_kernel(flat):
    """Kernel 8: pallas_wide_closest_hit over the same tiles."""
    jd, td = flat(KERNEL_LEAF)
    o, d, active = _rays(seed=7)
    ref = pt.pallas_wide_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(active), interpret=True)
    got = sk.wide_closest_hit(td, *map(torch.from_numpy, (o, d, active)))
    _assert_hits_close(got, ref)


# -- the per-ray bvh traversal vs the XLA traversal ----------------------------

@pytest.mark.parametrize("kind", ["flat28", "instanced"])
def test_bvh_matches_xla(kind, flat, inst):
    """Flat at leaf 28, where JAX's packet tier declines
    (pallas_traverse.py:560-564), and instanced."""
    jd, td = inst("columns") if kind == "instanced" else flat(28)
    o, d, active = _rays(seed=11)
    ref = jax_bvh(jd, jnp.asarray(o), jnp.asarray(d),
                  active=jnp.asarray(active))
    got = bvh_closest_hit(td, *map(torch.from_numpy, (o, d, active)))
    _assert_hits_close(got, ref)
    # The same walk with the kernels' hoisted slab finds the same hits.
    skip = sk.skip_closest_hit(td, *map(torch.from_numpy, (o, d, active)))
    _assert_hits_close(skip, ref)


def test_wrappers_keep_plain_on_cpu(flat):
    """CPU tensors run the plain versions: no launch is counted."""
    from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st

    _, td = flat(KERNEL_LEAF)
    o, d, active = map(torch.from_numpy, _rays(256, seed=13))
    before = dict(st.LAUNCHES)
    sk.skip_closest_hit(td, o, d, active)
    sk.wide_closest_hit(td, o, d, active)
    assert st.LAUNCHES == before


# -- frames --------------------------------------------------------------------

def _frame_pair(path, traversal, instanced):
    from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
    from vulkan_pathtracer_tpu.render.pipeline import (
        RenderPipeline as JaxPipeline,
    )
    from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    kw = dict(num_samples=1, num_bounces=2, resolution_x=64, resolution_y=48)
    bvh = traversal != "brute"
    if instanced:
        jd = jax_inst(jgltf.load(path), max_leaf_size=14)
        td = build_instanced_scene(gltf.load(path), max_leaf_size=14,
                                   device="cpu")
    else:
        jd = jax_flat(jgltf.load(path), build_bvh=bvh,
                      max_leaf_size=KERNEL_LEAF)
        td = build_device_scene(gltf.load(path), max_leaf_size=KERNEL_LEAF,
                                device="cpu", build_bvh=bvh,
                                wide=traversal == "pallas8")
    cam = JaxCamera(aspect_ratio=64 / 48,
                    position=np.asarray([0.0, 3.0, -9.0], np.float32))
    ref, ref_rays = JaxPipeline(jd, JaxConfig(traversal=traversal, **kw)) \
        .render_numpy(cam, 2)
    got, rays = RenderPipeline(td, RenderConfig(traversal=traversal, **kw)) \
        .render_numpy(cam, 2)
    assert rays == ref_rays > 64 * 48
    assert np.isfinite(got).all() and got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("traversal", TRAVERSALS)
def test_frame_matches_jax(columns_glb, traversal):
    _frame_pair(columns_glb, traversal, instanced=False)


def test_instanced_packet_frame_matches_jax(columns_glb):
    """Two-level pallas_packet: the port runs the skip kernel, JAX its
    XLA traversal (the packet kernel's VMEM gate)."""
    _frame_pair(columns_glb, "pallas_packet", instanced=True)


@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("traversal", TRAVERSALS)
def test_cli_renders_every_tier(columns_glb, tmp_path, traversal, instanced):
    from vulkan_pathtracer_tpu_torch.app.main import main
    from vulkan_pathtracer_tpu_torch.utils import read_png

    out = tmp_path / "x.png"
    argv = ["-s", columns_glb, "-x", "32", "-y", "24", "-o", str(out),
            "--device", "cpu", "--traversal", traversal]
    assert main(argv + (["--instanced"] if instanced else [])) == 0
    image = read_png(str(out))
    assert image.shape == (24, 32, 3) and 0 < image.mean() < 255


def test_pipeline_refuses_a_missing_table(columns_glb):
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    no_wide = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                                 device="cpu")
    with pytest.raises(ValueError, match="wide tiles"):
        RenderPipeline(no_wide, RenderConfig(traversal="pallas8"))
    no_bvh = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                                device="cpu", build_bvh=False)
    with pytest.raises(ValueError, match="needs a BVH"):
        RenderPipeline(no_bvh, RenderConfig(traversal="pallas_packet"))
