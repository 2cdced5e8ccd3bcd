"""The least bytes of one scene update, counted by the benchmark from
the scene's glTF: what any update of a two-level scene posed by its
node channels must move each frame, whatever the layout of its tables.

- each animation channel's two bracketing keys read: a key's time (f32)
  and its value (3 or 4 f32, by the output accessor's type);
- I world transforms written, one per mesh instance: a 3 x 4 f32 affine;
- I object-space root boxes read (6 f32 each), from which the TLAS's
  leaves follow;
- 2 I - 1 TLAS boxes written (6 f32 each): a binary tree over I leaves.

The least time of an update is those bytes over the card's bandwidth
(``peaks.json``, by the card's name).  The count leaves out what a
program adds beyond the least (inverse transforms, the instance
subtrees' boxes, skip records and pair rows): a share of 100% is not
reachable by an update that writes them.
"""

from __future__ import annotations

from ptbench import work
from ptbench.reference.gltf import _parse

F32 = 4
KEY_TIME_BYTES = F32
TRANSFORM_BYTES = 12 * F32
BOX_BYTES = 6 * F32
WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def instances(doc: dict) -> int:
    """Mesh nodes reachable from the scene's roots."""
    nodes = doc["nodes"]
    stack = list(doc["scenes"][doc.get("scene", 0)]["nodes"])
    count = 0
    while stack:
        node = nodes[stack.pop()]
        count += "mesh" in node
        stack.extend(node.get("children", []))
    return count


def least_bytes(scene_path: str):
    """The least bytes of one update of the scene at ``scene_path``, or
    None where the file has no animation."""
    with open(scene_path, "rb") as f:
        doc, _ = _parse(f.read())
    keys = 0
    for anim in doc.get("animations", []):
        for ch in anim["channels"]:
            out = anim["samplers"][ch["sampler"]]["output"]
            width = WIDTH[doc["accessors"][out]["type"]]
            keys += 2 * (KEY_TIME_BYTES + width * F32)
    if not keys:
        return None
    n = instances(doc)
    return keys + n * TRANSFORM_BYTES + n * BOX_BYTES + (2 * n - 1) * BOX_BYTES


def least_seconds(scene_path: str, card: str):
    """The least time of one update on ``card``, or None."""
    rates = work.peak(card)
    nbytes = least_bytes(scene_path)
    if rates is None or nbytes is None:
        return None
    return nbytes / rates[1]
