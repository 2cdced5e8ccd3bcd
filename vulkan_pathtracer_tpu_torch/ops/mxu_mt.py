"""Coefficient leaf test (``VKPT_MT=mxu``): Möller–Trumbore as a product
of a per-triangle coefficient table with 10 ray features.

Counterpart of ``vulkan_pathtracer_tpu/ops/mxu_mt.py``.  Per triangle,
precomputed coefficients make the det-scaled MT quantities linear in
the ray's feature vector r = [d, m, o, 1], m = o x d:

    det     = d . (e2 x e1)
    u * det = m . e2 + d . (v0 x e2)
    v * det = -(m . e1) + d . (e1 x v0)
    t * det = o . (e1 x e2) - v0 . (e1 x e2)

so a leaf visit is a dot product per sum, a det-scaled hit test, and
one division per candidate.  On the TPU the products ran on the MXU
over JAX's full (10, 4 * block) rows; here they are f32 sums in one
fixed order (feature by feature, each product rounded, then added) on
CUDA cores — TF32 would keep 10 mantissa bits, about the one-pass bf16
product the JAX package measured as changing the hit set.  The tier is
RELAXED parity: rounding differs from the exact kernels, so hits
within about an ulp of an edge or of the t window may flip
(tests/test_mxu_mt.py budgets 0.2% of rays).

Zero-free rows.  Of JAX's 40 coefficients per triangle (4 sums x 10
features) only 19 can be non-zero: det on d (3), u' and v' on d and m
(6 each), t' on o and 1 (4); the other 21 are exactly zero for every
triangle.  The port stores and sums only the 19 (``ROW_TERMS``), in
the order det, u', v', t', so a test that stops early reads only the
front of the row.  Dropping an exactly-zero product changes a sum only
where the sum is itself zero, and then only in the sign of that zero:
t, the triangle and the hit masks are those of the 40-term sums, and u
or v of an accepted hit may read -0 where the 40-term sums give +0.
The kernels (csrc/traverse.cuh ``coef_block``) stay bitwise equal to
the plain versions here, and these stay within the relaxed parity of
tests/test_torch_mxu.py against JAX.

Tables (port-native layout):

- ``tri_coefs (n_leaves, block, 20) f32``: per triangle the 19
  non-zero coefficients of ``ROW_TERMS`` and a zero, 80 bytes (five
  float4); bitwise JAX's non-zero entries of ``(n_leaves, 10, 4 *
  block)``.  Padded (zero-edge) triangle slots have all-zero
  coefficients: det = 0, never a hit.
- ``inst_feat (I, 40) f32`` (two-level scenes): the 40 entries of the
  world->object feature transform A (10, 16) of each instance that can
  be non-zero (``FEAT_TERMS``), feats_obj = A @ pad16(feats)
  (instance_feature_maps); every det-linear sum is then scaled by the
  instance's det_sign, so mirrored instances cull as the exact kernels
  do.

The plain versions here perform the CUDA leaf visit's operations in
the same order; they are vectorized and do not stop early, which
changes no outcome (only the statistics count the test's exits).
"""

from __future__ import annotations

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.ops.intersect import TMIN

N_FEAT = 10
# The compact row: each sum (0 det, 1 u', 2 v', 3 t') with the features
# of its non-zero coefficients, in row order; then one zero.
ROW_TERMS = ((0, (0, 1, 2)), (1, (0, 1, 2, 3, 4, 5)),
             (2, (0, 1, 2, 3, 4, 5)), (3, (6, 7, 8, 9)))
COLS = 20
# The transform A's entries that can be non-zero: for each feature row
# of A, its columns, in order (rows 0-2 and 6-8 are W on d and o, with
# the translation w in column 9; rows 3-5 the moment's [w]x W and
# cofactor blocks; row 9 the constant 1).
FEAT_TERMS = tuple((i, (0, 1, 2)) for i in range(3)) + tuple(
    (i, (0, 1, 2, 3, 4, 5)) for i in range(3, 6)) + tuple(
    (i, (6, 7, 8, 9)) for i in range(6, 9)) + ((9, (9,)),)
FEAT_COLS = 40


def _flat_index(terms, width):
    """Flat indices (row * width + column) of ``terms``, in order."""
    return np.array([r * width + c for r, cols in terms for c in cols])


COEF_INDEX = _flat_index(ROW_TERMS, N_FEAT)   # into a (4, 10) triangle
FEAT_INDEX = _flat_index(FEAT_TERMS, 16)      # into a (10, 16) A


def build_mt_coef_rows(leaves: np.ndarray) -> np.ndarray:
    """(n_leaves, block, 9) [v0 | e1 | e2] -> (n_leaves, block, 20) f32
    zero-free coefficient rows (mxu_mt.build_mt_coef_rows' non-zero
    entries: the same float64 cross products rounded once to f32)."""
    n, block = leaves.shape[0], leaves.shape[1]
    t = leaves.astype(np.float64)
    v0, e1, e2 = t[:, :, 0:3], t[:, :, 3:6], t[:, :, 6:9]
    nrm = np.cross(e1, e2)
    C = np.zeros((n, block, COLS), np.float32)
    C[:, :, 0:3] = np.cross(e2, e1)
    C[:, :, 3:6] = np.cross(v0, e2)
    C[:, :, 6:9] = e2
    C[:, :, 9:12] = np.cross(e1, v0)
    C[:, :, 12:15] = -e1
    C[:, :, 15:18] = nrm
    C[:, :, 18] = -(v0 * nrm).sum(-1)
    return C


def coef_rows(leaves: torch.Tensor) -> torch.Tensor:
    """build_mt_coef_rows on the leaves' device: (n_leaves, block, 9) f32
    -> (n_leaves, block, 20) f32, the same float64 products, differences
    and sums in NumPy's order (each cross product term a1 * b2 - a2 * b1,
    the sum ((+0 + p0) + p1) + p2: NumPy's reduction starts from +0, so
    three -0 products sum to +0), rounded once, so the rows are bitwise the
    host bake's of the same leaves (the JAX package's device twin,
    mxu_mt.build_mt_coef_rows_device, computes them in f32)."""
    t = leaves.double()
    v0, e1, e2 = t[..., 0:3], t[..., 3:6], t[..., 6:9]

    def cross(a, b):
        return torch.stack(
            [a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
             a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
             a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)

    nrm = cross(e1, e2)
    p = v0 * nrm
    d = -(((p[..., 0] + 0.0) + p[..., 1]) + p[..., 2])
    return torch.cat([cross(e2, e1), cross(v0, e2), e2, cross(e1, v0), -e1,
                      nrm, d.unsqueeze(-1), torch.zeros_like(d).unsqueeze(-1)],
                     dim=-1).float().contiguous()


def coef_rows_from_jax(tri_coefs: np.ndarray, block: int) -> np.ndarray:
    """JAX's (n_leaves, 10, >= 4 * block) coefficient rows as the port's
    (n_leaves, block, 20) zero-free rows; raises if an entry outside
    ROW_TERMS is non-zero."""
    n = tri_coefs.shape[0]
    c = tri_coefs[:, :, : 4 * block].reshape(n, N_FEAT, 4, block)
    full = np.ascontiguousarray(c.transpose(0, 3, 2, 1)).reshape(
        n, block, 4 * N_FEAT)
    rest = np.delete(full, COEF_INDEX, axis=2)
    if rest.any():
        raise ValueError("coefficient rows: non-zero entries outside the "
                         "19 of a Möller–Trumbore row")
    out = np.zeros((n, block, COLS), np.float32)
    out[:, :, :len(COEF_INDEX)] = full[:, :, COEF_INDEX]
    return out


def feature_maps_from_jax(inst_feat: np.ndarray) -> np.ndarray:
    """JAX's (I, 10, 16) feature transforms as the port's (I, 40)
    non-zero entries; raises if an entry outside FEAT_TERMS is
    non-zero."""
    flat = np.asarray(inst_feat, np.float32).reshape(-1, 160)
    if np.delete(flat, FEAT_INDEX, axis=1).any():
        raise ValueError("feature transforms: non-zero entries outside the "
                         "40 of A")
    return np.ascontiguousarray(flat[:, FEAT_INDEX])


def instance_feature_maps(inst_inv: torch.Tensor) -> torch.Tensor:
    """(I, 16) rows [W row-major | w | det_sign | pad] -> (I, 40) f32: the
    entries FEAT_TERMS of the feature transforms A with feats_obj = A @
    pad16(feats_world) (mxu_mt.instance_feature_maps): d' = W d, m' =
    cof(W) m + [w]x W d, o' = W o + w, in f32 with each product rounded
    before its sum (the values of the JAX package's NumPy bake), on the
    rows' device."""
    x = inst_inv.float()
    n = x.shape[0]
    W = x[:, 0:9].reshape(n, 3, 3)
    w = x[:, 9:12]

    def cross(a, b):
        return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)

    c0, c1, c2 = W[:, :, 0], W[:, :, 1], W[:, :, 2]
    cof = torch.stack([cross(c1, c2), cross(c2, c0), cross(c0, c1)], dim=2)
    # [w]x W with each row's two non-zero products summed in order.
    skew_w = torch.stack([
        -w[:, 2:3] * W[:, 1] + w[:, 1:2] * W[:, 2],
        w[:, 2:3] * W[:, 0] + -w[:, 0:1] * W[:, 2],
        -w[:, 1:2] * W[:, 0] + w[:, 0:1] * W[:, 1]], dim=1)
    return torch.cat([W.reshape(n, 9),
                      torch.cat([skew_w, cof], dim=2).reshape(n, 18),
                      torch.cat([W, w[:, :, None]], dim=2).reshape(n, 12),
                      torch.ones((n, 1), dtype=torch.float32,
                                 device=x.device)], dim=1)


# -- plain versions of the leaf test (csrc/traverse.cuh coef_block) ----------

def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(M, 10) [d, m, o, 1] with m = o x d (mxu_mt.packet_features)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    return torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz,
                        torch.ones_like(ox)], dim=1)


def _sums(coef: torch.Tensor, feats: torch.Tensor, terms):
    """One sum per entry (row, features) of ``terms``: sum over its
    features j of coef[..., c] * feats[..., j], c counting the
    coefficient columns from 0, each product rounded before it is added
    in order.  coef (..., n_cols), feats broadcastable to it."""
    out, c = [], 0
    for _, cols in terms:
        acc = coef[..., c] * feats[..., cols[0]]
        for k, j in enumerate(cols[1:], start=1):
            acc = acc + coef[..., c + k] * feats[..., j]
        out.append(acc)
        c += len(cols)
    return out


def object_features(inst_feat: torch.Tensor, feats: torch.Tensor):
    """feats_obj = A @ feats over A's non-zero entries, per ray:
    inst_feat (M, 40), feats (M, 10) -> (M, 10)."""
    return torch.stack(_sums(inst_feat, feats, FEAT_TERMS), dim=1)


def coef_sums(coefs: torch.Tensor, feats: torch.Tensor, det_sign=None):
    """(det, u', v', t') each (M, block): zero-free rows coefs (M, block,
    20) against feats (M, 10); ``det_sign`` (M,) scales all four
    (two-level)."""
    res = _sums(coefs, feats[:, None, :], ROW_TERMS)
    if det_sign is not None:
        res = [x * det_sign[:, None] for x in res]
    return tuple(res)


def _count_exits(exits, det, up, vp, tested=None):
    """Add to ``exits`` (a dict) the triangles tested (``tri_tested``) and
    those the test rejects at det <= 0 (``tri_back``), at u' < 0
    (``tri_u``) and at the v' window (``tri_v``), in that order; only
    the ``tested`` triangles count ((M, block) bool, default all)."""
    if tested is None:
        tested = torch.ones_like(det, dtype=torch.bool)
    front = det > 0.0
    u_ok = front & (up >= 0.0)
    exits["tri_tested"] += int(tested.sum())
    exits["tri_back"] += int((tested & ~front).sum())
    exits["tri_u"] += int((tested & front & ~u_ok).sum())
    exits["tri_v"] += int((tested & u_ok
                           & ~((vp >= 0.0) & (up + vp <= det))).sum())


def coef_leaf_mt(coefs, feats, det_sign=None, exits=None):
    """Closest-hit leaf test (mxu_mt.mt_coef_visit): per triangle
    (front & det-scaled barycentric window & t > TMIN, t, u, v), each
    (M, block), with t, u, v divided by det.  The caller adds t < lim and
    picks the smallest t, the first triangle on a tie.  ``exits``, a
    dict, counts the test's exits (_count_exits) over every triangle."""
    det, up, vp, tp = coef_sums(coefs, feats, det_sign)
    if exits is not None:
        _count_exits(exits, det, up, vp)
    front = det > 0.0
    inv = 1.0 / torch.where(front, det, torch.ones_like(det))
    t = tp * inv
    ok = (front & (up >= 0.0) & (vp >= 0.0) & (up + vp <= det)
          & (t > TMIN))
    return ok, t, up * inv, vp * inv


def coef_leaf_any(coefs, feats, t_lane, det_sign=None, exits=None):
    """Any-hit leaf test (mxu_mt.mt_coef_visit_anyhit), det-scaled with
    no division: (M,) bool, some triangle accepts inside (TMIN, t_lane).
    ``exits``, a dict, counts the test's exits (_count_exits) over the
    triangles up to the first accepted one, where the kernel stops."""
    det, up, vp, tp = coef_sums(coefs, feats, det_sign)
    acc = ((det > 0.0) & (up >= 0.0) & (vp >= 0.0) & (up + vp <= det)
           & (tp > TMIN * det) & (tp < t_lane[:, None] * det))
    if exits is not None:
        before = torch.cumsum(acc.to(torch.int32), dim=1) - acc.to(torch.int32)
        _count_exits(exits, det, up, vp, tested=before == 0)
    return acc.any(dim=1)
