"""Render configuration.

The static half mirrors the reference's SPIR-V specialization
constants + CLI (``main.zig:29-67``, ``RayTracingPipeline.zig:286-320``):
``num_samples`` / ``num_bounces`` / resolution / divider are
*compile-time* parameters — changing them recompiles the render
function (the XLA analog of rebuilding the RT pipeline).  The traced
half (camera vectors, frame counter) mirrors the push-constant block.

Extensions beyond the reference (all default-off so defaults match it
exactly) are grouped at the bottom.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class RenderConfig:
    # ---- reference CLI surface (same names & defaults, main.zig:29-67) ----
    num_samples: int = 1            # --num-samples / -c
    num_bounces: int = 2            # --num-bounces / -b
    resolution_x: int = 1920        # --resolution-x / -x
    resolution_y: int = 1080        # --resolution-y / -y
    render_resolution_divider: int = 1  # --render-resolution-divider / -d
    enable_validation: bool = False     # --enable-validation / -v

    # ---- TPU-build extensions (north-star features, default off) ----------
    progressive: bool = False       # accumulate across frames
    russian_roulette: bool = False  # RR path termination after bounce 2
    rr_start_bounce: int = 2
    traversal: str = "auto"  # auto | bvh | brute | pallas (dense run
    # kernel) | pallas_packet (round-1 binary kernel) | pallas8 (wide)
    # Sort bounce rays by (octant, origin Morton) before traversal —
    # pure scheduling, per-ray results unchanged; 2-3x on bounces.
    sort_secondary: bool = True
    # True wavefront compaction: shrink the dispatch to live rays
    # between bounces (prefix-sum compaction; SURVEY.md §7 M3).
    compact_secondary: bool = False
    # Seed bounce-ray t_best with a hit from the previous bounce's
    # leaf block (valid-hit pre-pass; results unchanged). Wins in
    # interior scenes, loses slightly in open scenes — opt in.
    seed_secondary: bool = False
    ray_chunk: int = 1 << 19        # rays per dispatch chunk (0 = off)
    dtype: str = "float32"

    @property
    def render_width(self) -> int:
        return max(1, self.resolution_x // self.render_resolution_divider)

    @property
    def render_height(self) -> int:
        return max(1, self.resolution_y // self.render_resolution_divider)

    @property
    def aspect_ratio(self) -> float:
        # main.zig: camera aspect comes from the window extent.
        return self.resolution_x / self.resolution_y

    def static_key(self):
        """Everything that forces a recompile (the spec-constant set)."""
        return (
            self.num_samples,
            self.num_bounces,
            self.render_width,
            self.render_height,
            self.progressive,
            self.russian_roulette,
            self.rr_start_bounce,
            self.traversal,
            self.sort_secondary,
            self.ray_chunk,
            self.seed_secondary,
        )


# Measured leaf-size policy (round-4 plan7-10): leaf-28 split rows
# (ops/pallas_pair._leaf_rows_per_block) win on production scenes —
# isolated secondaries 538->505 ms, headline 5.68->5.76 Mrays/s,
# convergence 2.70->3.03 spp/s, exact — but LOSE ~11% below ~10k tris
# (Cornell 252->284 ms, sphere-9.2k 244->275; shallow trees can't pay
# for the doubled per-leaf scalar chain), with columns-56k neutral.
# Cut at 50k.  Instanced scenes stay at 14 regardless (fly-through
# 1.85 vs 1.98 fps measured) — callers on that path pass leaf sizes
# explicitly and do not consult this.
LEAF28_MIN_TRIS = 50_000


def default_max_leaf(triangle_count: int) -> int:
    """Size-keyed BVH leaf size (app + bench default; VKPT_LEAF overrides)."""
    return 28 if triangle_count >= LEAF28_MIN_TRIS else 14
