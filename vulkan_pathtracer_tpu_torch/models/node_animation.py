"""glTF node animation evaluated on the device: the instances' world
transforms at a time, with no read of the device.

``NodeAnimator(graph, device)`` takes the loader's ``NodeGraph``
(models/gltf.py: rest TRS, parents, channels) and uploads it once: every
channel in one table, its key times (padded with +inf), values (padded
to 4 wide), the reciprocal of each key interval (0 after the last key
and for ``STEP``), and the positions its values take in the nodes' TRS
rows.  ``transforms(t)`` then returns the (I, 4, 4) f32 world transforms
of ``scene.instances`` at ``t`` seconds (glTF 2.0, "Animations"):

- each channel's bracketing keys by ``torch.searchsorted`` on its key
  times; before the first key the first value, after the last the last;
- ``STEP`` takes the earlier key's value; ``LINEAR`` interpolates
  translation and scale linearly and slerps the normalised rotation
  quaternions along the shorter arc (the specification's formula, a
  linear blend where the keys nearly coincide), then normalises;
- the values scattered into the nodes' rest TRS rows, each node's local
  matrix T R S (the rotation from the quaternion's products; a
  ``matrix`` node keeps its matrix), and the world matrices down the
  hierarchy one depth level at a time;
- everything in float64 on the device, rounded to f32 at the end.

A fixed sequence of launches, few enough that a CUDA graph of it
launches quickly (models/animation.SceneAnimation captures it): no
``.item()``, no host copy, no boolean mask.  ``moved`` counts the
instances whose node or an ancestor is animated.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models.gltf import ANIMATED_PATHS, NodeGraph

# Keys closer than this (cos of the angle between their quaternions)
# are blended linearly: sin(angle) would divide by about zero.
SLERP_LINEAR_DOT = 1.0 - 1e-9
# A node's TRS row: translation, rotation (xyzw), scale.
TRS_COLUMN = {"translation": 0, "rotation": 3, "scale": 7}
TRS_WIDTH = 10


def _normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def slerp(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(C, 4) unit quaternions between ``a`` and ``b`` (C, 4) at
    fractions ``s`` (C, 1), along the shorter arc."""
    a, b = _normalize(a), _normalize(b)
    d = (a * b).sum(dim=-1, keepdim=True)
    b = torch.where(d < 0, -b, b)
    d = d.abs()
    near = d > SLERP_LINEAR_DOT
    angle = torch.acos(d.clamp(max=1.0))
    sin = torch.where(near, torch.ones_like(angle), torch.sin(angle))
    wa = torch.where(near, 1.0 - s, torch.sin((1.0 - s) * angle) / sin)
    wb = torch.where(near, s, torch.sin(s * angle) / sin)
    return _normalize(wa * a + wb * b)


def _rotation_map() -> np.ndarray:
    """(16, 9): the rotation matrix of a unit quaternion q = xyzw, less
    the identity, from its products q_i q_j (row 4 i + j):
    R = I + 2 [[-(yy+zz), xy-zw, xz+yw], [xy+zw, -(xx+zz), yz-xw],
    [xz-yw, yz+xw, -(xx+yy)]]."""
    x, y, z, w = range(4)
    terms = [[(y, y, -1), (z, z, -1)], [(x, y, 1), (z, w, -1)],
             [(x, z, 1), (y, w, 1)], [(x, y, 1), (z, w, 1)],
             [(x, x, -1), (z, z, -1)], [(y, z, 1), (x, w, -1)],
             [(x, z, 1), (y, w, -1)], [(y, z, 1), (x, w, 1)],
             [(x, x, -1), (y, y, -1)]]
    out = np.zeros((16, 9))
    for entry, pairs in enumerate(terms):
        for i, j, sign in pairs:
            out[4 * i + j, entry] = 2.0 * sign
    return out


def trs_matrices(trs: torch.Tensor, consts: dict) -> torch.Tensor:
    """(N, 4, 4) local matrices T R S from TRS rows (N, 10):
    translation, rotation xyzw, scale; ``consts`` holds, on the device,
    ``_rotation_map()`` (``map``), the identity's 9 entries (``eye``) and
    the row (0, 0, 0, 1) (``bottom``, (1, 1, 4))."""
    q = trs[:, 3:7]
    n = trs.shape[0]
    rot = (q[:, :, None] * q[:, None, :]).reshape(n, 16) @ consts["map"]
    rot = (rot + consts["eye"]).view(n, 3, 3) * trs[:, None, 7:10]
    top = torch.cat([rot, trs[:, 0:3, None]], dim=2)
    return torch.cat([top, consts["bottom"].expand(n, 1, 4)], dim=1)


class NodeAnimator:
    """The device evaluator of a NodeGraph (module docstring)."""

    def __init__(self, graph: NodeGraph, device):
        self.device = torch.device(device)

        def up(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        n = len(graph.parents)
        rest = np.concatenate([graph.translation, graph.rotation,
                               graph.scale], axis=1)
        # The nodes' TRS rows, flat, and one spare slot for the 4th
        # value of a 3-wide channel.
        self.rest = up(np.append(rest.reshape(-1), 0.0))
        self.matrix = up(graph.matrix)
        self.has_matrix = up(graph.has_matrix, torch.bool)
        self.instance_node = up(graph.instance_node, torch.int64)
        self.consts = {"map": up(_rotation_map()),
                       "eye": up(np.eye(3).reshape(9)),
                       "bottom": up([[[0.0, 0.0, 0.0, 1.0]]])}
        chans = graph.channels
        c = len(chans)
        k = max((len(ch.times) for ch in chans), default=1)
        times = np.full((c, k), np.inf)
        values = np.zeros((c, k, 4))
        inv_gap = np.zeros((c, k))
        targets = np.full((c, 4), n * TRS_WIDTH, np.int64)
        for i, ch in enumerate(chans):
            m, width = len(ch.times), ANIMATED_PATHS[ch.path]
            times[i, :m] = ch.times
            values[i, :m, :width] = ch.values
            values[i, m:, :width] = ch.values[-1]
            if ch.interpolation == "LINEAR":
                inv_gap[i, :m - 1] = 1.0 / np.diff(ch.times.astype(
                    np.float64))
            col = ch.node * TRS_WIDTH + TRS_COLUMN[ch.path]
            targets[i, :width] = np.arange(col, col + width)
        self.times = up(times)
        self.values = up(values)
        self.inv_gap = up(inv_gap)
        self.targets = up(targets, torch.int64)
        self.last = up([[len(ch.times) - 1] for ch in chans], torch.int64)
        self.rotation = up([[ch.path == "rotation"] for ch in chans],
                           torch.bool)
        self.rows = torch.arange(c, device=self.device)
        # Depth levels below the roots: (nodes, their parents) per level.
        parents = graph.parents
        depth = np.zeros(n, np.int64)
        for i in range(n):
            p, d = parents[i], 0
            while p >= 0:
                p, d = parents[p], d + 1
            depth[i] = d
        self.levels = [(up(np.flatnonzero(depth == d), torch.int64),
                        up(parents[depth == d], torch.int64))
                       for d in range(1, int(depth.max(initial=0)) + 1)]
        animated = np.zeros(n, bool)
        animated[[ch.node for ch in chans]] = True
        moves = animated.copy()
        for i in range(n):
            p = parents[i]
            while p >= 0 and not moves[i]:
                moves[i] = animated[p]
                p = parents[p]
        self.moved = int(moves[graph.instance_node].sum())

    def sample(self, t) -> torch.Tensor:
        """(C, 4) f64 values of the channels at ``t`` (seconds, a float
        or a 0-d tensor on the device); a 3-wide channel's 4th is 0."""
        rows = self.times.shape[0]
        if isinstance(t, torch.Tensor):
            query = t.to(torch.float64).expand(rows, 1).contiguous()
        else:
            query = torch.full((rows, 1), float(t), dtype=torch.float64,
                               device=self.device)
        k = torch.searchsorted(self.times, query, right=True) - 1
        lo = k.clamp(min=0).minimum(self.last)
        hi = (k + 1).minimum(self.last)
        s = ((query - self.times.gather(1, lo))
             * self.inv_gap.gather(1, lo)).clamp(0.0, 1.0)
        a = self.values[self.rows, lo[:, 0]]
        b = self.values[self.rows, hi[:, 0]]
        return torch.where(self.rotation, slerp(a, b, s), a + (b - a) * s)

    def local_matrices(self, t) -> torch.Tensor:
        """(N, 4, 4) f64 local matrices of every node at ``t``."""
        trs = self.rest.clone()
        trs[self.targets] = self.sample(t)
        local = trs_matrices(trs[:-1].view(-1, TRS_WIDTH), self.consts)
        return torch.where(self.has_matrix[:, None, None], self.matrix,
                           local)

    def transforms(self, t) -> torch.Tensor:
        """(I, 4, 4) f32 world transforms of the instances at ``t``
        seconds (a float, or a 0-d device tensor, which a CUDA graph
        captures)."""
        world = self.local_matrices(t)
        for nodes, parents in self.levels:
            world[nodes] = world[parents] @ world[nodes]
        return world[self.instance_node].float()
