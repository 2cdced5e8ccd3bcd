"""The port runs without JAX and never falls back silently.

- Every module of ``vulkan_pathtracer_tpu_torch`` imports, and the CLI
  renders a 64x64 box on ``--device cpu``, in a subprocess where
  ``import jax`` fails (``sys.modules["jax"] = None``).
- No module of the port and not ``chip_smoke.py`` imports the JAX
  package (``vulkan_pathtracer_tpu``): a source scan, and subprocesses
  with both ``jax`` and ``vulkan_pathtracer_tpu`` blocked that import
  every module and render ``--instanced``, ``--traversal
  pallas_packet``, ``--traversal pallas8`` and a kernel-tier frame
  (the frontier kernels with coefficient leaves, chosen by the
  ``VKPT_*`` variables) on ``--device cpu``, and run the progressive
  CLI (a joint batch, a checkpoint and its resume) and the pooled
  fly-through CLI (``--pool-frames``).
- Without CUDA, the default ``--device cuda`` exits non-zero with a
  clear message instead of switching to the CPU.
- The traversal wrappers raise for a device that is neither CPU nor
  CUDA; the CLI parses ``--devices`` and ``--shard-mode``, also with
  ``--interactive``, and ``VKPT_MXU_PRECISION=default`` (with JAX's
  warning; the tier frame renders under it too).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import vulkan_pathtracer_tpu_torch
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(vulkan_pathtracer_tpu_torch.__file__)
BLOCK_JAX = "import sys; sys.modules['jax'] = None; "
BLOCK_JAX_PACKAGE = BLOCK_JAX + "sys.modules['vulkan_pathtracer_tpu'] = None; "
IMPORT_ALL_AND_RUN_CLI = (
    "import importlib, pkgutil, runpy; "
    "import vulkan_pathtracer_tpu_torch as p; "
    "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
    "p.__path__, p.__name__ + '.') if not m.name.endswith('__main__')]; "
    "sys.argv = ['vkpt'] + sys.argv[1:]; "
    "runpy.run_module('vulkan_pathtracer_tpu_torch', run_name='__main__')")


def _run(code, *args, block=BLOCK_JAX, env=None):
    return subprocess.run([sys.executable, "-c", block + code, *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=None if env is None else {**os.environ, **env})


def test_source_never_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), name


def test_source_never_imports_jax_package():
    """No import statement of the port or of chip_smoke.py reaches the
    JAX package (``vulkan_pathtracer_tpu_torch`` is the port itself)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|vulkan_pathtracer_tpu)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 20
    for module in ("utils/profiling.py", "utils/validation.py",
                   "app/viewer.py"):
        assert os.path.join(PKG, module) in paths, module
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_cli_renders_instanced_without_jax_package(columns_glb, tmp_path):
    out = tmp_path / "columns.png"
    proc = _run(IMPORT_ALL_AND_RUN_CLI, "-s", columns_glb, "-x", "48", "-y",
                "32", "-o", str(out), "--instanced", "--device", "cpu",
                block=BLOCK_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert "two-level BVH: " in proc.stderr and "17 instances" in proc.stderr
    from vulkan_pathtracer_tpu_torch.utils import read_png

    image = read_png(str(out))
    assert image.shape == (32, 48, 3) and 0 < image.mean() < 255


@pytest.mark.parametrize("traversal", ["pallas_packet", "pallas8"])
def test_cli_renders_traversal_without_jax_package(columns_glb, tmp_path,
                                                   traversal):
    out = tmp_path / "columns.png"
    proc = _run(IMPORT_ALL_AND_RUN_CLI, "-s", columns_glb, "-x", "48", "-y",
                "32", "-o", str(out), "--traversal", traversal, "--device",
                "cpu", block=BLOCK_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert ("8-wide tiles: " in proc.stderr) == (traversal == "pallas8")
    from vulkan_pathtracer_tpu_torch.utils import read_png

    image = read_png(str(out))
    assert image.shape == (32, 48, 3) and 0 < image.mean() < 255


def test_cli_renders_tier_frame_without_jax_package(columns_glb, tmp_path):
    """The frontier kernels with coefficient leaves at leaf 28, chosen by
    the JAX package's variables, in a process without JAX."""
    out = tmp_path / "columns.png"
    env = {"VKPT_KERNEL_PRIMARY": "frontier",
           "VKPT_KERNEL_SECONDARY": "frontier",
           "VKPT_ANYHIT_KERNEL": "frontier", "VKPT_MT": "mxu",
           "VKPT_LEAF": "28"}
    proc = _run(IMPORT_ALL_AND_RUN_CLI, "-s", columns_glb, "-x", "48", "-y",
                "32", "-b", "3", "-o", str(out), "--device", "cpu",
                block=BLOCK_JAX_PACKAGE, env=env)
    assert proc.returncode == 0, proc.stderr
    assert ("kernel tiers: primary=frontier secondary=frontier "
            "anyhit=frontier mt=mxu leaf=28 mxu_precision=highest"
            ) in proc.stderr
    assert "quality-broken" not in proc.stderr
    from vulkan_pathtracer_tpu_torch.utils import read_png

    image = read_png(str(out))
    assert image.shape == (32, 48, 3) and 0 < image.mean() < 255


def test_cli_renders_bf16_tier_frame_without_jax_package(columns_glb,
                                                         tmp_path):
    """``VKPT_MT=mxu VKPT_MXU_PRECISION=default``: the two-level frame
    with the bf16 product of the coefficient leaves, in a process
    without JAX, with JAX's warning once on stderr."""
    out = tmp_path / "columns.png"
    env = {"VKPT_MT": "mxu", "VKPT_MXU_PRECISION": "default"}
    proc = _run(IMPORT_ALL_AND_RUN_CLI, "-s", columns_glb, "-x", "48", "-y",
                "32", "--instanced", "-o", str(out), "--device", "cpu",
                block=BLOCK_JAX_PACKAGE, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "mt=mxu leaf=14 mxu_precision=default" in proc.stderr
    assert proc.stderr.count("VKPT_MXU_PRECISION=default is "
                             "quality-broken") == 1
    from vulkan_pathtracer_tpu_torch.utils import read_png

    image = read_png(str(out))
    assert image.shape == (32, 48, 3) and 0 < image.mean() < 255


def test_cli_renders_without_jax(box_glb, tmp_path):
    out = tmp_path / "box.png"
    proc = _run(IMPORT_ALL_AND_RUN_CLI, "-s", box_glb, "-x", "64", "-y",
                "64", "-o", str(out), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    from vulkan_pathtracer_tpu.utils.png import read_png

    image = read_png(str(out))
    assert image.shape == (64, 64, 3) and 0 < image.mean() < 255


def test_cli_progressive_without_jax_package(box_glb, tmp_path):
    """The convergence path (a joint batch with Russian roulette, a
    checkpoint, then its resume) in a process without JAX."""
    out = tmp_path / "box.png"
    ckpt = tmp_path / "acc.npz"
    args = ["-s", box_glb, "-x", "48", "-y", "32", "-o", str(out),
            "--progressive", "--batch-frames", "2", "--russian-roulette",
            "--checkpoint", str(ckpt), "--checkpoint-interval", "2",
            "--device", "cpu"]
    proc = _run(IMPORT_ALL_AND_RUN_CLI, *args, "--frames", "2",
                block=BLOCK_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    proc = _run(IMPORT_ALL_AND_RUN_CLI, *args, "--frames", "4",
                block=BLOCK_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert "resumed checkpoint at frame 2 (2 spp)" in proc.stderr
    assert f"wrote {out} (4 spp)" in proc.stderr
    from vulkan_pathtracer_tpu_torch.utils import read_png

    image = read_png(str(out))
    assert image.shape == (32, 48, 3) and 0 < image.mean() < 255


def test_cli_pooled_without_jax_package(box_glb, tmp_path):
    """The fly-through path (``--pool-frames``: groups of frames as one
    pooled wavefront) in a process without JAX."""
    out = tmp_path / "box.png"
    proc = _run(IMPORT_ALL_AND_RUN_CLI, "-s", box_glb, "-x", "48", "-y",
                "32", "-o", str(out), "--frames", "3", "--pool-frames", "2",
                "--device", "cpu", block=BLOCK_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert "3 frame(s) on cpu" in proc.stderr
    from vulkan_pathtracer_tpu_torch.utils import read_png

    image = read_png(str(out))
    assert image.shape == (32, 48, 3) and 0 < image.mean() < 255


def test_cuda_device_without_cuda_fails(box_glb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    proc = _run("import runpy; sys.argv = ['vkpt'] + sys.argv[1:]; "
                "runpy.run_module('vulkan_pathtracer_tpu_torch', "
                "run_name='__main__')",
                "-s", box_glb, "-x", "64", "-y", "64",
                "-o", str(tmp_path / "x.png"))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("flag", [["--devices", "2"],
                                  ["--shard-mode", "spp"]])
def test_unported_flags_refused(flag, monkeypatch):
    """The multi-device flags parse (they run in
    tests/test_torch_multidevice.py), with ``--interactive`` too (the
    multi-rank viewer), and so does ``VKPT_MXU_PRECISION=default`` (the
    one-pass bf16 product, with JAX's warning)."""
    from vulkan_pathtracer_tpu_torch.app.main import parse_args

    _, args = parse_args(["-s", "scene.glb", *flag])
    assert (args.devices, args.shard_mode) == (
        (2, "tiles") if flag[0] == "--devices" else (1, "spp"))
    _, args = parse_args(["-s", "scene.glb", "--interactive", "--devices",
                          "2", *flag])
    assert args.interactive and args.devices == 2
    monkeypatch.setenv("VKPT_MT", "mxu")
    monkeypatch.setenv("VKPT_MXU_PRECISION", "default")
    with pytest.warns(UserWarning, match="VKPT_MXU_PRECISION=default is "
                      "quality-broken"):
        config, args = parse_args(["-s", "scene.glb", *flag])
    assert config.mt == "mxu" and config.mxu_precision == "default"
    assert (args.devices, args.shard_mode) == (
        (2, "tiles") if flag[0] == "--devices" else (1, "spp"))


@pytest.mark.parametrize("fn", [st.quad_closest_hit, st.quad_any_hit,
                                st.pair_closest_hit, st.pair_any_hit,
                                sk.skip_closest_hit, sk.wide_closest_hit,
                                st.oct_closest_hit, fr.frontier_closest_hit,
                                fr.frontier_any_hit])
def test_wrapper_raises_for_meta_tensor(fn):
    class Tables:
        quad_box = torch.zeros((1, 4, 6), device="meta")
        quad_link = torch.zeros((1, 4), dtype=torch.int32, device="meta")
        oct_box = torch.zeros((1, 8, 6), device="meta")
        oct_link = torch.zeros((1, 8), dtype=torch.int32, device="meta")
        frontier_box = torch.zeros((1, 16, 6), device="meta")
        frontier_link = torch.zeros((1, 16), dtype=torch.int32,
                                    device="meta")
        pair_box = torch.zeros((1, 2, 6), device="meta")
        pair_link = torch.zeros((1, 2), dtype=torch.int32, device="meta")
        skip_nodes = torch.zeros((8, 8), device="meta")
        wide_nodes = torch.zeros((8, 8, 8), device="meta")
        leaves = torch.zeros((1, 4, 9), device="meta")
        instanced = False

    o = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="no traversal for device type"):
        fn(Tables, o, o)
    assert set(st.LAUNCHES.values()) == {0}


def test_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing."""
    box = torch.zeros((1, 4, 6))
    box[0, 0] = torch.tensor([-1.0, -1.0, 1.0, 1.0, 1.0, 1.0])
    link = torch.tensor([[-1, st.EMPTY, st.EMPTY, st.EMPTY]],
                        dtype=torch.int32)
    leaves = torch.zeros((1, 4, 9))
    leaves[0, 0] = torch.tensor([-1.0, -1.0, 1.0, 0.0, 2.0, 0.0,
                                 2.0, 0.0, 0.0])

    class Tables:
        quad_box, quad_link = box, link

    Tables.leaves = leaves
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    hit = st.quad_closest_hit(Tables, o, d)
    assert np.allclose(hit.t.numpy(), 1.0) and (hit.tri == 0).all()
    assert st.quad_any_hit(Tables, o, d).all()
    assert set(st.LAUNCHES.values()) == {0}
