"""Coefficient leaf test (``VKPT_MT=mxu``): Möller–Trumbore as a product
of a per-triangle coefficient table with 10 ray features.

Counterpart of ``vulkan_pathtracer_tpu/ops/mxu_mt.py``.  Per triangle,
precomputed coefficients make the det-scaled MT quantities linear in
the ray's feature vector r = [d, m, o, 1], m = o x d:

    det     = d . (e2 x e1)
    u * det = m . e2 + d . (v0 x e2)
    v * det = -(m . e1) + d . (e1 x v0)
    t * det = o . (e1 x e2) - v0 . (e1 x e2)

so a leaf visit is 4 * block dot products of length 10, a det-scaled
hit test, and one division for the winning candidate only.  On the TPU
the products ran on the MXU; here they are f32 sums in one fixed order
(feature 0 to 9, each product rounded, then added) on CUDA cores —
TF32 would keep 10 mantissa bits, about the one-pass bf16 product the
JAX package measured as changing the hit set.  The tier is RELAXED
parity: rounding differs from the exact kernels, so hits within about
an ulp of an edge or of the t window may flip (tests/test_mxu_mt.py
budgets 0.2% of rays).

Tables (port-native layout):

- ``tri_coefs (n_leaves, block, 40) f32``: per triangle the columns
  det, u', v', t' (groups of 10), each holding the coefficient of
  features 0..9 — JAX's ``(n_leaves, 10, 4 * block)`` transposed so a
  triangle's 160 bytes are contiguous.  Padded (zero-edge) triangle
  slots have all-zero coefficients: det = 0, never a hit.
- ``inst_feat (I, 10, 16) f32`` (two-level scenes): the world->object
  feature transform A of each instance, feats_obj = A @ pad16(feats)
  (instance_feature_maps); then every det-linear row is scaled by the
  instance's det_sign, so mirrored instances cull as the exact kernels
  do.

The plain versions here perform the CUDA leaf visit's operations
(csrc/traverse.cuh ``coef_leaf``) in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.ops.intersect import TMIN

N_FEAT = 10
COLS = 4 * N_FEAT   # det, u', v', t' of one triangle


def build_mt_coef_rows(leaves: np.ndarray) -> np.ndarray:
    """(n_leaves, block, 9) [v0 | e1 | e2] -> (n_leaves, block, 40) f32
    coefficients (mxu_mt.build_mt_coef_rows, the same float64 cross
    products rounded once to f32)."""
    n, block = leaves.shape[0], leaves.shape[1]
    t = leaves.astype(np.float64)
    v0, e1, e2 = t[:, :, 0:3], t[:, :, 3:6], t[:, :, 6:9]
    nrm = np.cross(e1, e2)
    C = np.zeros((n, block, 4, N_FEAT), np.float32)
    C[:, :, 0, 0:3] = np.cross(e2, e1)
    C[:, :, 1, 0:3] = np.cross(v0, e2)
    C[:, :, 1, 3:6] = e2
    C[:, :, 2, 0:3] = np.cross(e1, v0)
    C[:, :, 2, 3:6] = -e1
    C[:, :, 3, 6:9] = nrm
    C[:, :, 3, 9] = -(v0 * nrm).sum(-1)
    return C.reshape(n, block, COLS)


def coef_rows_from_jax(tri_coefs: np.ndarray, block: int) -> np.ndarray:
    """JAX's (n_leaves, 10, >= 4 * block) coefficient rows in the port's
    (n_leaves, block, 40) layout."""
    n = tri_coefs.shape[0]
    c = tri_coefs[:, :, : 4 * block].reshape(n, N_FEAT, 4, block)
    return np.ascontiguousarray(c.transpose(0, 3, 2, 1)).reshape(
        n, block, COLS).astype(np.float32)


def instance_feature_maps(inst_inv: torch.Tensor) -> torch.Tensor:
    """(I, 16) rows [W row-major | w | det_sign | pad] -> (I, 10, 16) f32
    feature transforms A with feats_obj = A @ pad16(feats_world)
    (mxu_mt.instance_feature_maps): d' = W d, m' = cof(W) m + [w]x W d,
    o' = W o + w, in f32 with each product rounded before its sum (the
    values of the JAX package's NumPy bake), on the rows' device."""
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
    A = torch.zeros((n, N_FEAT, 16), dtype=torch.float32, device=x.device)
    A[:, 0:3, 0:3] = W
    A[:, 3:6, 0:3] = skew_w
    A[:, 3:6, 3:6] = cof
    A[:, 6:9, 6:9] = W
    A[:, 6:9, 9] = w
    A[:, 9, 9] = 1.0
    return A


# -- plain versions of the leaf visit (csrc/traverse.cuh coef_leaf) -----------

def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(M, 10) [d, m, o, 1] with m = o x d (mxu_mt.packet_features)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    return torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz,
                        torch.ones_like(ox)], dim=1)


def _dot10(coef: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """sum_j coef[..., j] * feats[..., j], j = 0..9 in order, each
    product rounded before it is added.  coef (..., 10), feats
    broadcastable to it."""
    acc = coef[..., 0] * feats[..., 0]
    for j in range(1, N_FEAT):
        acc = acc + coef[..., j] * feats[..., j]
    return acc


def object_features(inst_feat: torch.Tensor, feats: torch.Tensor):
    """feats_obj = A @ feats over features 0..9 (the padded six are zero
    in both), per ray: inst_feat (M, 10, 16), feats (M, 10)."""
    return _dot10(inst_feat[:, :, :N_FEAT], feats[:, None, :])


def coef_sums(coefs: torch.Tensor, feats: torch.Tensor, det_sign=None):
    """(det, u', v', t') each (M, block): coefs (M, block, 40) against
    feats (M, 10); ``det_sign`` (M,) scales all four (two-level)."""
    m, block = coefs.shape[0], coefs.shape[1]
    res = _dot10(coefs.reshape(m, block, 4, N_FEAT), feats[:, None, None, :])
    if det_sign is not None:
        res = res * det_sign[:, None, None]
    return res[..., 0], res[..., 1], res[..., 2], res[..., 3]


def coef_leaf_mt(coefs, feats, det_sign=None):
    """Closest-hit leaf test (mxu_mt.mt_coef_visit): per triangle
    (front & det-scaled barycentric window & t > TMIN, t, u, v), each
    (M, block), with t, u, v divided by det.  The caller adds t < lim and
    picks the smallest t, the first triangle on a tie."""
    det, up, vp, tp = coef_sums(coefs, feats, det_sign)
    front = det > 0.0
    inv = 1.0 / torch.where(front, det, torch.ones_like(det))
    t = tp * inv
    ok = (front & (up >= 0.0) & (vp >= 0.0) & (up + vp <= det)
          & (t > TMIN))
    return ok, t, up * inv, vp * inv


def coef_leaf_any(coefs, feats, t_lane, det_sign=None):
    """Any-hit leaf test (mxu_mt.mt_coef_visit_anyhit), det-scaled with
    no division: (M,) bool, some triangle accepts inside (TMIN, t_lane)."""
    det, up, vp, tp = coef_sums(coefs, feats, det_sign)
    acc = ((det > 0.0) & (up >= 0.0) & (vp >= 0.0) & (up + vp <= det)
           & (tp > TMIN * det) & (tp < t_lane[:, None] * det))
    return acc.any(dim=1)
