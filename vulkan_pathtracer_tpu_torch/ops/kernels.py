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

from vulkan_pathtracer_tpu_torch.ops import mxu_mt

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


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The C launchers' argument types (csrc/*.cu): pointers and the stream
# as c_void_p, sizes as c_int / c_int64; each returns an int.
SIGNATURES = {
    "vkpt_quad_closest_hit": [_P, _P, _P, _I, _I, _P, _P, _P, _I64, _P, _P,
                              _P, _P, _P, _P],
    "vkpt_oct_closest_hit": [_P, _P, _P, _I, _P, _P, _P, _I64, _P, _P, _P,
                             _P, _P, _P],
    "vkpt_quad_any_hit": [_P, _P, _P, _I, _I, _P, _P, _P, _I64, _P, _P, _P],
    "vkpt_quad_stats": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _I64, _P, _P,
                        _P, _P, _P, _P, _P, _P],
    "vkpt_stack_stats_count": [],
    "vkpt_pair_closest_hit": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                              _I64, _P, _P, _P, _P, _P, _P],
    "vkpt_pair_any_hit": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _I64,
                          _P, _P, _P],
    "vkpt_pair_stats": [_I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                        _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    "vkpt_frontier_closest_hit": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _I64,
                                  _P, _P, _P, _P, _P, _P],
    "vkpt_frontier_any_hit": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _I64, _P,
                              _P, _P],
    "vkpt_frontier_stats": [_I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _I64, _P,
                            _P, _P, _P, _P, _P, _P, _P],
    "vkpt_skip_closest_hit": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I64, _P,
                              _P, _P, _P, _P, _P],
    "vkpt_skip_stats": [_I, _P, _I, _P, _I, _P, _I, _P, _P, _P, _I64, _P, _P,
                        _P, _P, _P, _P, _P, _P],
    "vkpt_wide_closest_hit": [_P, _I, _P, _I, _P, _P, _P, _I64, _P, _P, _P,
                              _P, _P, _P],
    "vkpt_wide_stats": [_P, _I, _P, _I, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
                        _P, _P],
}


def bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the launchers ``handle``
    exports (a library built from some of csrc/ binds those only)."""
    for name, argtypes in SIGNATURES.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(build()))
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
    the leaf table is a coefficient table (mxu_mt.COLS columns), else
    0."""
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
    """Exact leaf blocks (n_leaves, block, 9) -> 0, zero-free coefficient
    rows (n_leaves, block, 20) -> 1 (ops/mxu_mt.py)."""
    if leaves.dim() != 3 or leaves.shape[2] not in (9, mxu_mt.COLS):
        raise ValueError(f"leaves: expected (n_leaves, block, 9) or "
                         f"coefficients (n_leaves, block, {mxu_mt.COLS})")
    _check("leaves", leaves, torch.float32,
           (None, leaves.shape[1], leaves.shape[2]))
    if leaves.device != device:
        raise ValueError(f"leaves lie on {leaves.device}, tables on {device}")
    return int(leaves.shape[2] == mxu_mt.COLS)


def _check_feat(inst_feat, inst, coef: int, device):
    """The (I, 40) feature transforms a two-level scene's coefficient
    leaves need (ops/mxu_mt.py), or None."""
    if not (coef and inst is not None):
        return None
    if inst_feat is None:
        raise ValueError("coefficient leaves of a two-level scene need "
                         "inst_feat (I, 40)")
    _check("inst_feat", inst_feat, torch.float32, (None, mxu_mt.FEAT_COLS))
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


def _hit_outputs(n: int, device):
    t = torch.empty(n, dtype=torch.float32, device=device)
    tri = torch.empty(n, dtype=torch.int32, device=device)
    return t, tri, torch.empty_like(t), torch.empty_like(t)


def _ptrs(*tensors):
    return [x.data_ptr() for x in tensors]


_BATCHES = {}  # (device, stream) -> the stack kernels' batch counter


def _batches(n: int, device, stream: int) -> torch.Tensor:
    """The counter from which the persistent warps of the stack kernels
    take their 32-ray batches: one per device and stream, zeroed by the
    launcher on that stream before each launch (so the launches that
    share it run one after another)."""
    if n > 2 ** 31 - 64:
        raise ValueError(f"{n} rays: the stack kernels take fewer than 2^31")
    key = (torch.device(device), stream)
    if key not in _BATCHES:
        _BATCHES[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _BATCHES[key]


def _launch(name: str, device, fn, *args, batches: int = None) -> None:
    """Call launcher ``fn`` with ``args`` on the current stream of
    ``device``, with that device current (the launchers size persistent
    grids by the current device); ``batches`` = the ray count of a stack
    kernel, whose batch counter for that stream goes before the stream.
    Raises on a launch the runtime refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        extra = (() if batches is None else
                 (_batches(batches, device, stream).data_ptr(),))
        rc = fn(*args, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def quad_closest_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the quad closest-hit kernel (coefficient leaves when
    ``leaves`` is a coefficient table); returns (t, tri, u, v)."""
    coef = _check_tables(box, link, leaves)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _launch("quad_closest_hit", origin.device, lib().vkpt_quad_closest_hit,
            box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
            leaves.shape[1], coef, *_ptrs(origin, direction, t_lane), n,
            *_ptrs(*out), batches=n)
    return out


def oct_closest_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the oct closest-hit kernel (exact leaves); returns
    (t, tri, u, v)."""
    _check_tables(box, link, leaves, width=8, coef_ok=False)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _launch("oct_closest_hit", origin.device, lib().vkpt_oct_closest_hit,
            box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
            leaves.shape[1], *_ptrs(origin, direction, t_lane), n,
            *_ptrs(*out), batches=n)
    return out


def quad_any_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the quad any-hit kernel (coefficient leaves when ``leaves``
    is a coefficient table); returns an (N,) bool tensor."""
    coef = _check_tables(box, link, leaves)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    hit = torch.empty(n, dtype=torch.uint8, device=origin.device)
    _launch("quad_any_hit", origin.device, lib().vkpt_quad_any_hit,
            box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
            leaves.shape[1], coef, *_ptrs(origin, direction, t_lane), n,
            hit.data_ptr(), batches=n)
    return hit.bool()


# Counters of the stack kernels' statistics build (csrc/stack_walk.cuh,
# the kSt* enum), then a 65-bin histogram of each ray's deepest stack
# (0..63 entries, 64 or more).  inner_0 .. inner_2: the frontier closest
# hit's visited nodes with 0, 1, 2 or more hit internal children;
# tri_tested .. tri_v: coefficient leaves' triangles tested and those
# failing at det <= 0, at u' < 0 and at the v' window; share_1 ..
# share_32: leaf visits by the number of the warp's lanes that test the
# same table row with them.
STACK_STATS = ("node_warps", "node_lanes", "leaf_warps", "leaf_lanes",
               "rays", "warps", "batch_rounds", "deepest", "leaf_visits",
               "instance_changes", "inner_0", "inner_1", "inner_2",
               "tri_tested", "tri_back", "tri_u", "tri_v",
               *(f"share_{k}" for k in range(1, 33)))


def _stats(name, fn, any_hit, tables, origin, direction, t_lane):
    """Run statistics launcher ``fn`` (arguments: the any-hit flag,
    ``tables``, the rays, the outputs, the counters and the batch
    counter) and return (its hit outputs, the list of counters)."""
    n = origin.shape[0]
    dev = origin.device
    out = _hit_outputs(n, dev)
    hit = torch.empty(n, dtype=torch.uint8, device=dev)
    st = torch.zeros(lib().vkpt_stack_stats_count(), dtype=torch.int64,
                     device=dev)
    _launch(name, dev, fn, int(any_hit), *tables,
            *_ptrs(origin, direction, t_lane), n, *_ptrs(*out),
            hit.data_ptr(), st.data_ptr(), batches=n)
    return (hit.bool() if any_hit else out), st.cpu().tolist()


def quad_stats(any_hit: bool, box, link, leaves, origin, direction, t_lane):
    """Run the statistics build of a quad kernel (the kernels' own
    designs, exact or coefficient leaves) and return (its hit outputs,
    the list of counters: STACK_STATS, then the depth histogram)."""
    coef = _check_tables(box, link, leaves)
    _check_rays(origin, direction, t_lane, box.device)
    return _stats("quad_stats", lib().vkpt_quad_stats, any_hit,
                  (box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
                   leaves.shape[1], coef), origin, direction, t_lane)


def pair_stats(any_hit: bool, box, link, leaves, origin, direction, t_lane,
               inst_inv=None, mb_bits: int = 0, inst_feat=None):
    """Run the statistics build of a pair kernel (the kernels' own
    designs, exact or coefficient leaves, flat or two-level; the
    arguments of pair_closest_hit) and return (its hit outputs, the list
    of counters: STACK_STATS, then the depth histogram)."""
    coef = _check_tables(box, link, leaves, width=2)
    _check_rays(origin, direction, t_lane, box.device)
    inst = _check_inst(inst_inv, mb_bits, box.device)
    feat = _check_feat(inst_feat, inst, coef, box.device)
    return _stats("pair_stats", lib().vkpt_pair_stats, any_hit,
                  (box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
                   leaves.shape[1], coef, inst, feat, mb_bits), origin,
                  direction, t_lane)


SHARE_BINS = ((1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32))


def summarize_stack_stats(counters) -> dict:
    """SIMT efficiency (active lanes / 32, averaged over warp iterations)
    of the node steps and of the entries into a node's leaves, node
    steps per ray against node-step rounds per warp batch (the tail),
    leaf visits per ray and the share of them whose instance differs
    from the lane's previous leaf visit, the shares of visited nodes
    with 0, 1 and 2 or more hit internal children (the frontier closest
    hit; 0 elsewhere), the coefficient leaves' triangles tested per leaf
    visit and the shares of them that fail at det <= 0, at u' < 0 and at
    the v' window, the shares of leaf visits whose table row 1, 2, 3-4,
    5-8, 9-16 and 17-32 of the warp's lanes test together, and the stack
    depth reached by each ray (mean, 99th percentile, deepest, share
    above 8 and 24 entries), from the counters of the statistics
    build."""
    c = dict(zip(STACK_STATS, counters))
    hist = list(counters[len(STACK_STATS):])
    rays, total = max(c["rays"], 1), max(sum(hist), 1)
    share = max(sum(c[f"share_{k}"] for k in range(1, 33)), 1)
    inner = c["inner_0"] + c["inner_1"] + c["inner_2"]
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
        "leaf_visits_per_ray": c["leaf_visits"] / rays,
        "instance_change_share": (c["instance_changes"]
                                  / max(c["leaf_visits"], 1)),
        **{f"inner_{k}_share": c[f"inner_{k}"] / max(inner, 1)
           for k in range(3)},
        "tri_per_visit": c["tri_tested"] / max(c["leaf_visits"], 1),
        **{f"{k}_share": c[k] / max(c["tri_tested"], 1)
           for k in ("tri_back", "tri_u", "tri_v")},
        **{f"row_shared_by_{lo}-{hi}": sum(
            c[f"share_{k}"] for k in range(lo, hi + 1)) / share
           for lo, hi in SHARE_BINS},
        "depth_mean": sum(k * x for k, x in enumerate(hist)) / total,
        "depth_p99": p99, "deepest": c["deepest"],
        "depth_over_8": sum(hist[9:]) / total,
        "depth_over_24": sum(hist[25:]) / total,
    }


def pair_closest_hit(box, link, leaves, origin, direction, t_lane,
                     inst_inv=None, mb_bits: int = 0, inst_feat=None):
    """Launch the pair closest-hit kernel (instanced when ``inst_inv`` is
    given; coefficient leaves when ``leaves`` is a coefficient table, with
    ``inst_feat`` on a two-level scene); returns (t, tri, u, v)."""
    coef = _check_tables(box, link, leaves, width=2)
    _check_rays(origin, direction, t_lane, box.device)
    inst = _check_inst(inst_inv, mb_bits, box.device)
    feat = _check_feat(inst_feat, inst, coef, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _launch("pair_closest_hit", origin.device, lib().vkpt_pair_closest_hit,
            box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
            leaves.shape[1], coef, inst, feat, mb_bits,
            *_ptrs(origin, direction, t_lane), n, *_ptrs(*out), batches=n)
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
    _launch("pair_any_hit", origin.device, lib().vkpt_pair_any_hit,
            box.data_ptr(), link.data_ptr(), leaves.data_ptr(),
            leaves.shape[1], coef, inst, feat, mb_bits,
            *_ptrs(origin, direction, t_lane), n, hit.data_ptr(), batches=n)
    return hit.bool()


def _frontier_width(box) -> int:
    width = box.shape[1] if box.dim() == 3 else 0
    if width not in (16, 32):
        raise ValueError(f"frontier_box: expected (Nw, 16 or 32, 6), got "
                         f"{tuple(box.shape)}")
    return width


def frontier_closest_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the frontier closest-hit kernel (width 16 or 32 from the
    table; coefficient leaves when ``leaves`` is a coefficient table); returns
    (t, tri, u, v)."""
    width = _frontier_width(box)
    coef = _check_tables(box, link, leaves, width=width)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _launch("frontier_closest_hit", origin.device,
            lib().vkpt_frontier_closest_hit, box.data_ptr(), link.data_ptr(),
            width, leaves.data_ptr(), leaves.shape[1], coef,
            *_ptrs(origin, direction, t_lane), n, *_ptrs(*out), batches=n)
    return out


def frontier_any_hit(box, link, leaves, origin, direction, t_lane):
    """Launch the frontier any-hit kernel; returns an (N,) bool tensor."""
    width = _frontier_width(box)
    coef = _check_tables(box, link, leaves, width=width)
    _check_rays(origin, direction, t_lane, box.device)
    n = origin.shape[0]
    hit = torch.empty(n, dtype=torch.uint8, device=origin.device)
    _launch("frontier_any_hit", origin.device, lib().vkpt_frontier_any_hit,
            box.data_ptr(), link.data_ptr(), width, leaves.data_ptr(),
            leaves.shape[1], coef, *_ptrs(origin, direction, t_lane), n,
            hit.data_ptr(), batches=n)
    return hit.bool()


def frontier_stats(any_hit: bool, box, link, leaves, origin, direction,
                   t_lane):
    """Run the statistics build of a frontier kernel (its own design,
    exact or coefficient leaves) and return (its hit outputs, the list
    of counters: STACK_STATS, then the depth histogram)."""
    width = _frontier_width(box)
    coef = _check_tables(box, link, leaves, width=width)
    _check_rays(origin, direction, t_lane, box.device)
    return _stats("frontier_stats", lib().vkpt_frontier_stats, any_hit,
                  (box.data_ptr(), link.data_ptr(), width, leaves.data_ptr(),
                   leaves.shape[1], coef), origin, direction, t_lane)


def _check_skip(nodes, leaves, origin, direction, t_lane, inst_inv,
                mb_bits):
    """The skip kernel's tables and rays; returns the instance table's
    pointer (None for a flat scene)."""
    if nodes.shape[0] % 8:
        raise ValueError("skip_nodes: expected 8 octant blocks of records")
    _check("skip_nodes", nodes, torch.float32, (None, 8))
    if _check_leaves(leaves, nodes.device):
        raise ValueError("skip kernel: exact leaves only (n_leaves, block, 9)")
    _check_rays(origin, direction, t_lane, nodes.device)
    return _check_inst(inst_inv, mb_bits, nodes.device)


def skip_closest_hit(nodes, leaves, origin, direction, t_lane,
                     inst_inv=None, mb_bits: int = 0):
    """Launch the skip-record closest-hit kernel over the 8 octant
    preorders (instanced when ``inst_inv`` is given); returns
    (t, tri, u, v)."""
    inst = _check_skip(nodes, leaves, origin, direction, t_lane, inst_inv,
                       mb_bits)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _launch("skip_closest_hit", origin.device, lib().vkpt_skip_closest_hit,
            nodes.data_ptr(), nodes.shape[0] // 8, leaves.data_ptr(),
            leaves.shape[1], inst, mb_bits,
            *_ptrs(origin, direction, t_lane), n, *_ptrs(*out), batches=n)
    return out


def skip_stats(nodes, leaves, origin, direction, t_lane, inst_inv=None,
               mb_bits: int = 0):
    """Run the statistics build of the skip kernel (its own designs,
    flat or two-level) and return (its hit outputs, the list of
    counters: STACK_STATS, then the depth histogram, all at 0: the walk
    keeps no stack)."""
    inst = _check_skip(nodes, leaves, origin, direction, t_lane, inst_inv,
                       mb_bits)
    return _stats("skip_stats", lib().vkpt_skip_stats, False,
                  (nodes.data_ptr(), nodes.shape[0] // 8, leaves.data_ptr(),
                   leaves.shape[1], inst, mb_bits), origin, direction, t_lane)


def _check_wide(tiles, leaves, origin, direction, t_lane):
    if tiles.shape[0] % 8:
        raise ValueError("wide_nodes: expected 8 octant blocks of tiles")
    _check("wide_nodes", tiles, torch.float32, (None, 8, 8))
    if _check_leaves(leaves, tiles.device):
        raise ValueError("wide kernel: exact leaves only (n_leaves, block, 9)")
    _check_rays(origin, direction, t_lane, tiles.device)


def wide_stats(tiles, leaves, origin, direction, t_lane):
    """Run the statistics build of the wide kernel (its own design) and
    return (its hit outputs, the list of counters: STACK_STATS, then the
    depth histogram, all at 0: the walk keeps no stack)."""
    _check_wide(tiles, leaves, origin, direction, t_lane)
    n = origin.shape[0]
    dev = origin.device
    out = _hit_outputs(n, dev)
    st = torch.zeros(lib().vkpt_stack_stats_count(), dtype=torch.int64,
                     device=dev)
    _launch("wide_stats", dev, lib().vkpt_wide_stats, tiles.data_ptr(),
            tiles.shape[0] // 8, leaves.data_ptr(), leaves.shape[1],
            *_ptrs(origin, direction, t_lane), n, *_ptrs(*out), st.data_ptr(),
            batches=n)
    return out, st.cpu().tolist()


def wide_closest_hit(tiles, leaves, origin, direction, t_lane):
    """Launch the 8-wide tile closest-hit kernel; returns
    (t, tri, u, v)."""
    _check_wide(tiles, leaves, origin, direction, t_lane)
    n = origin.shape[0]
    out = _hit_outputs(n, origin.device)
    _launch("wide_closest_hit", origin.device, lib().vkpt_wide_closest_hit,
            tiles.data_ptr(), tiles.shape[0] // 8, leaves.data_ptr(),
            leaves.shape[1], *_ptrs(origin, direction, t_lane), n,
            *_ptrs(*out), batches=n)
    return out
