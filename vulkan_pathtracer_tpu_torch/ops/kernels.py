"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc``
per ``.cu`` file, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/torch_kernels/<hash>/`` at the root
of the checkout (``build/`` is git-ignored), keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  A failed build, a failed load or a non-zero
``cudaGetLastError()`` from a launcher raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "torch_kernels")
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_INFO = {}  # seconds, ptxas log, library path of the loaded build


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (its CUDA_HOME), else on
    PATH, else under /usr/local/cuda."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build() -> str:
    """Compile csrc/ into the hashed build directory (unless already
    built) and return the library path."""
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_DIR, digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libvkpt_torch_kernels.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(seconds=0.0, log="(cached build)", path=lib_path)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in sources if s.endswith(".cu")):
        obj = os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    outs = [proc.communicate()[0] for _, _, proc in jobs]   # wait for all
    for (cmd, _, proc), out in zip(jobs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    log = "".join(outs)
    tmp = f"{lib_path}.{tag}"
    cmd = [nvcc, *GENCODE, "-shared", "-o", tmp, *(j[1] for j in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    for _, obj, _ in jobs:
        os.remove(obj)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log,
                      path=lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        p = ctypes.c_void_p
        i, i64 = ctypes.c_int, ctypes.c_int64
        handle.vkpt_quad_closest_hit.restype = ctypes.c_int
        handle.vkpt_quad_closest_hit.argtypes = [
            p, p, p, i, i, p, p, p, i64, p, p, p, p, p, p]
        handle.vkpt_oct_closest_hit.restype = ctypes.c_int
        handle.vkpt_oct_closest_hit.argtypes = [
            p, p, p, i, p, p, p, i64, p, p, p, p, p, p]
        handle.vkpt_quad_any_hit.restype = ctypes.c_int
        handle.vkpt_quad_any_hit.argtypes = [
            p, p, p, i, i, p, p, p, i64, p, p, p]
        handle.vkpt_quad_stats.restype = ctypes.c_int
        handle.vkpt_quad_stats.argtypes = [
            i, p, p, p, i, p, p, p, i64, p, p, p, p, p, p, p, p]
        handle.vkpt_quad_stats_count.restype = ctypes.c_int
        handle.vkpt_quad_stats_count.argtypes = []
        handle.vkpt_pair_closest_hit.restype = ctypes.c_int
        handle.vkpt_pair_closest_hit.argtypes = [
            p, p, p, i, i, p, p, i, p, p, p, i64, p, p, p, p, p]
        handle.vkpt_pair_any_hit.restype = ctypes.c_int
        handle.vkpt_pair_any_hit.argtypes = [
            p, p, p, i, i, p, p, i, p, p, p, i64, p, p]
        handle.vkpt_frontier_closest_hit.restype = ctypes.c_int
        handle.vkpt_frontier_closest_hit.argtypes = [
            p, p, i, p, i, i, p, p, p, i64, p, p, p, p, p]
        handle.vkpt_frontier_any_hit.restype = ctypes.c_int
        handle.vkpt_frontier_any_hit.argtypes = [
            p, p, i, p, i, i, p, p, p, i64, p, p]
        handle.vkpt_skip_closest_hit.restype = ctypes.c_int
        handle.vkpt_skip_closest_hit.argtypes = [
            p, ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int, p, p, p,
            ctypes.c_int64, p, p, p, p, p]
        handle.vkpt_wide_closest_hit.restype = ctypes.c_int
        handle.vkpt_wide_closest_hit.argtypes = [
            p, ctypes.c_int, p, ctypes.c_int, p, p, p, ctypes.c_int64, p, p,
            p, p, p]
        _LIB = handle
    return _LIB


def _check(name: str, x: torch.Tensor, dtype, shape,
           align: int = 16) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape[1:]) != tuple(shape[1:]) or (
            shape[0] is not None and x.shape[0] != shape[0]):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"{name}: must be contiguous and {align}-byte "
                         f"aligned")


TABLE_NAMES = {2: "pair", 4: "quad", 8: "oct", 16: "frontier",
               32: "frontier"}


def _check_tables(box, link, leaves, width: int = 4, coef_ok: bool = True):
    """Node tables of ``width`` slots and the leaf table; returns 1 when
    the leaf table is a coefficient table (40 columns), else 0."""
    kind = TABLE_NAMES[width]
    _check(f"{kind}_box", box, torch.float32, (None, width, 6))
    _check(f"{kind}_link", link, torch.int32, (box.shape[0], width),
           align=min(16, 4 * width))
    coef = _check_leaves(leaves, box.device)
    if coef and not coef_ok:
        raise ValueError(f"{kind} kernel: exact leaves only (n_leaves, "
                         f"block, 9)")
    return coef


def _check_leaves(leaves, device) -> int:
    """Exact leaf blocks (n_leaves, block, 9) -> 0, coefficient rows
    (n_leaves, block, 40) -> 1 (ops/mxu_mt.py)."""
    if leaves.dim() != 3 or leaves.shape[2] not in (9, 40):
        raise ValueError("leaves: expected (n_leaves, block, 9) or "
                         "coefficients (n_leaves, block, 40)")
    _check("leaves", leaves, torch.float32,
           (None, leaves.shape[1], leaves.shape[2]))
    if leaves.device != device:
        raise ValueError(f"leaves lie on {leaves.device}, tables on {device}")
    return int(leaves.shape[2] == 40)


def _check_feat(inst_feat, inst, coef: int, device):
    """The (I, 10, 16) feature transforms a two-level scene's coefficient
    leaves need, or None."""
    if not (coef and inst is not None):
        return None
    if inst_feat is None:
        raise ValueError("coefficient leaves of a two-level scene need "
                         "inst_feat (I, 10, 16)")
    _check("inst_feat", inst_feat, torch.float32, (None, 10, 16))
    if inst_feat.device != device:
        raise ValueError(f"inst_feat lies on {inst_feat.device}, tables on "
                         f"{device}")
    return inst_feat.data_ptr()


def _check_inst(inst_inv, mb_bits: int, device):
    """The instance table of a two-level scene, or None (flat)."""
    if inst_inv is None:
        return None
    _check("inst_inv", inst_inv, torch.float32, (None, 16))
    if inst_inv.device != device:
        raise ValueError(f"inst_inv lies on {inst_inv.device}, tables on "
                         f"{device}")
    if not 0 < mb_bits < 31:
        raise ValueError(f"mb_bits {mb_bits} out of range")
    return inst_inv.data_ptr()


def _check_rays(origin, direction, t_lane, device):
    n = origin.shape[0]
    for name, x, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t_lane", t_lane, (n,))):
        _check(name, x, torch.float32, shape, align=4)
        if x.device != device:
            raise ValueError(f"{name} lies on {x.device}, tables on {device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _hit_outputs(n: int, device):
    t = torch.empty(n, dtype=torch.float32, device=device)
    tri = torch.empty(n, dtype=torch.int32, device=device)
    return t, tri, torch.empty_like(t), torch.empty_like(t)


def _ptrs(*tensors):
    return [x.data_ptr() for x in tensors]


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


_BATCHES = {}  # device -> the stack kernels' batch counter


def _batches(n: int, device) -> torch.Tensor:
    """The counter from which the persistent warps of the stack kernels
    take their 32-ray batches: one per device, zeroed by the launcher on
    the launch's stream before each launch (so launches of one device
    share it in stream order)."""
    if n > 2 ** 31 - 64:
        raise ValueError(f"{n} rays: the stack kernels take fewer than 2^31")
    if device not in _BATCHES:
        _BATCHES[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _BATCHES[device]


def quad_closest_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the quad closest-hit kernel (coefficient leaves when
    ``leaves`` has 40 columns); returns (t, tri, u, v)."""
    coef = _check_tables(box, link, leaves)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _raise_on("quad_closest_hit", lib().vkpt_quad_closest_hit(
        box.data_ptr(), link.data_ptr(), leaves.data_ptr(), leaves.shape[1],
        coef, *_ptrs(origin, direction, t_lane), n, *_ptrs(*out),
        _batches(n, origin.device).data_ptr(), _stream(origin.device)))
    return out


def oct_closest_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the oct closest-hit kernel (exact leaves); returns
    (t, tri, u, v)."""
    _check_tables(box, link, leaves, width=8, coef_ok=False)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _raise_on("oct_closest_hit", lib().vkpt_oct_closest_hit(
        box.data_ptr(), link.data_ptr(), leaves.data_ptr(), leaves.shape[1],
        *_ptrs(origin, direction, t_lane), n, *_ptrs(*out),
        _batches(n, origin.device).data_ptr(), _stream(origin.device)))
    return out


def quad_any_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the quad any-hit kernel (coefficient leaves when ``leaves``
    has 40 columns); returns an (N,) bool tensor."""
    coef = _check_tables(box, link, leaves)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    hit = torch.empty(n, dtype=torch.uint8, device=origin.device)
    _raise_on("quad_any_hit", lib().vkpt_quad_any_hit(
        box.data_ptr(), link.data_ptr(), leaves.data_ptr(), leaves.shape[1],
        coef, *_ptrs(origin, direction, t_lane), n, hit.data_ptr(),
        _batches(n, origin.device).data_ptr(), _stream(origin.device)))
    return hit.bool()


# Counters of the quad kernels' statistics build (csrc/stack_traverse.cu,
# the kSt* enum), then a 65-bin histogram of each ray's deepest stack
# (0..63 entries, 64 or more).
STACK_STATS = ("node_warps", "node_lanes", "leaf_warps", "leaf_lanes",
               "rays", "warps", "batch_rounds", "deepest")


def quad_stats(any_hit: bool, box, link, leaves, origin, direction, t_lane):
    """Run the statistics build of a quad kernel (the kernels' own
    designs, exact leaves) and return (its hit outputs, the list of
    counters: STACK_STATS, then the depth histogram)."""
    if _check_tables(box, link, leaves, coef_ok=False):
        raise ValueError("the statistics build takes exact leaves")
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    dev = origin.device
    out = _hit_outputs(n, dev)
    hit = torch.empty(n, dtype=torch.uint8, device=dev)
    st = torch.zeros(lib().vkpt_quad_stats_count(), dtype=torch.int64,
                     device=dev)
    _raise_on("quad_stats", lib().vkpt_quad_stats(
        int(any_hit), box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
        leaves.shape[1], *_ptrs(origin, direction, t_lane), n, *_ptrs(*out),
        hit.data_ptr(), _batches(n, dev).data_ptr(), st.data_ptr(),
        _stream(dev)))
    return (hit.bool() if any_hit else out), st.cpu().tolist()


def summarize_stack_stats(counters) -> dict:
    """SIMT efficiency (active lanes / 32, averaged over warp iterations)
    of the node steps and of the entries into a node's leaves, node
    steps per ray against node-step rounds per warp batch (the tail),
    and the stack depth reached by each ray (mean, 99th percentile,
    deepest, share above 8 and 24 entries), from the counters of the
    statistics build."""
    c = dict(zip(STACK_STATS, counters))
    hist = list(counters[len(STACK_STATS):])
    rays, total = max(c["rays"], 1), max(sum(hist), 1)
    acc, p99 = 0, None
    for k, x in enumerate(hist):
        acc += x
        if p99 is None and acc >= 0.99 * total:
            p99 = k
    return {
        "simt_node": c["node_lanes"] / max(32 * c["node_warps"], 1),
        "simt_leaf": c["leaf_lanes"] / max(32 * c["leaf_warps"], 1),
        "steps_per_ray": c["node_lanes"] / rays,
        "rounds_per_warp": c["batch_rounds"] / max(c["warps"], 1),
        "leaf_entries_per_ray": c["leaf_lanes"] / rays,
        "depth_mean": sum(k * x for k, x in enumerate(hist)) / total,
        "depth_p99": p99, "deepest": c["deepest"],
        "depth_over_8": sum(hist[9:]) / total,
        "depth_over_24": sum(hist[25:]) / total,
    }


def pair_closest_hit(box, link, leaves, origin, direction, t_lane,
                     inst_inv=None, mb_bits: int = 0, inst_feat=None):
    """Launch the pair closest-hit kernel (instanced when ``inst_inv`` is
    given; coefficient leaves when ``leaves`` has 40 columns, with
    ``inst_feat`` on a two-level scene); returns (t, tri, u, v)."""
    coef = _check_tables(box, link, leaves, width=2)
    _check_rays(origin, direction, t_lane, box.device)
    inst = _check_inst(inst_inv, mb_bits, box.device)
    feat = _check_feat(inst_feat, inst, coef, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _raise_on("pair_closest_hit", lib().vkpt_pair_closest_hit(
        box.data_ptr(), link.data_ptr(), leaves.data_ptr(), leaves.shape[1],
        coef, inst, feat, mb_bits, *_ptrs(origin, direction, t_lane), n,
        *_ptrs(*out), _stream(origin.device)))
    return out


def pair_any_hit(box, link, leaves, origin, direction, t_lane,
                 inst_inv=None, mb_bits: int = 0, inst_feat=None):
    """Launch the pair any-hit kernel (instanced / coefficient leaves as
    for pair_closest_hit); returns an (N,) bool tensor."""
    coef = _check_tables(box, link, leaves, width=2)
    _check_rays(origin, direction, t_lane, box.device)
    inst = _check_inst(inst_inv, mb_bits, box.device)
    feat = _check_feat(inst_feat, inst, coef, box.device)
    n = origin.shape[0]
    hit = torch.empty(n, dtype=torch.uint8, device=origin.device)
    _raise_on("pair_any_hit", lib().vkpt_pair_any_hit(
        box.data_ptr(), link.data_ptr(), leaves.data_ptr(), leaves.shape[1],
        coef, inst, feat, mb_bits, *_ptrs(origin, direction, t_lane), n,
        hit.data_ptr(), _stream(origin.device)))
    return hit.bool()


def _frontier_width(box) -> int:
    width = box.shape[1] if box.dim() == 3 else 0
    if width not in (16, 32):
        raise ValueError(f"frontier_box: expected (Nw, 16 or 32, 6), got "
                         f"{tuple(box.shape)}")
    return width


def frontier_closest_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the frontier closest-hit kernel (width 16 or 32 from the
    table; coefficient leaves when ``leaves`` has 40 columns); returns
    (t, tri, u, v)."""
    width = _frontier_width(box)
    coef = _check_tables(box, link, leaves, width=width)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _raise_on("frontier_closest_hit", lib().vkpt_frontier_closest_hit(
        box.data_ptr(), link.data_ptr(), width, leaves.data_ptr(),
        leaves.shape[1], coef, *_ptrs(origin, direction, t_lane), n,
        *_ptrs(*out), _stream(origin.device)))
    return out


def frontier_any_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the frontier any-hit kernel; returns an (N,) bool tensor."""
    width = _frontier_width(box)
    coef = _check_tables(box, link, leaves, width=width)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    hit = torch.empty(n, dtype=torch.uint8, device=origin.device)
    _raise_on("frontier_any_hit", lib().vkpt_frontier_any_hit(
        box.data_ptr(), link.data_ptr(), width, leaves.data_ptr(),
        leaves.shape[1], coef, *_ptrs(origin, direction, t_lane), n,
        hit.data_ptr(), _stream(origin.device)))
    return hit.bool()


def skip_closest_hit(nodes, leaves, origin, direction, t_lane,
                     inst_inv=None, mb_bits: int = 0):
    """Launch the skip-record closest-hit kernel over the 8 octant
    preorders (instanced when ``inst_inv`` is given); returns
    (t, tri, u, v)."""
    if nodes.shape[0] % 8:
        raise ValueError("skip_nodes: expected 8 octant blocks of records")
    _check("skip_nodes", nodes, torch.float32, (None, 8))
    if _check_leaves(leaves, nodes.device):
        raise ValueError("skip kernel: exact leaves only (n_leaves, block, 9)")
    _check_rays(origin, direction, t_lane, nodes.device)
    inst = _check_inst(inst_inv, mb_bits, nodes.device)
    n = origin.shape[0]
    t, tri, u, v = _hit_outputs(n, origin.device)
    rc = lib().vkpt_skip_closest_hit(
        nodes.data_ptr(), nodes.shape[0] // 8, leaves.data_ptr(),
        leaves.shape[1], inst, mb_bits, origin.data_ptr(),
        direction.data_ptr(), t_lane.data_ptr(), n, t.data_ptr(),
        tri.data_ptr(), u.data_ptr(), v.data_ptr(), _stream(origin.device))
    if rc != 0:
        raise RuntimeError(f"skip_closest_hit launch failed: CUDA error {rc}")
    return t, tri, u, v


def wide_closest_hit(tiles, leaves, origin, direction, t_lane):
    """Launch the 8-wide tile closest-hit kernel; returns
    (t, tri, u, v)."""
    if tiles.shape[0] % 8:
        raise ValueError("wide_nodes: expected 8 octant blocks of tiles")
    _check("wide_nodes", tiles, torch.float32, (None, 8, 8))
    if _check_leaves(leaves, tiles.device):
        raise ValueError("wide kernel: exact leaves only (n_leaves, block, 9)")
    _check_rays(origin, direction, t_lane, tiles.device)
    n = origin.shape[0]
    t, tri, u, v = _hit_outputs(n, origin.device)
    rc = lib().vkpt_wide_closest_hit(
        tiles.data_ptr(), tiles.shape[0] // 8, leaves.data_ptr(),
        leaves.shape[1], origin.data_ptr(), direction.data_ptr(),
        t_lane.data_ptr(), n, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), _stream(origin.device))
    if rc != 0:
        raise RuntimeError(f"wide_closest_hit launch failed: CUDA error {rc}")
    return t, tri, u, v
