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

from dataclasses import dataclass
from typing import Optional

FRONTIER_WIDTH = 16   # pallas_frontier.py:93, the default collapse width
# Kernel names of VKPT_KERNEL_{PRIMARY,SECONDARY}.  The JAX package's
# *_hbm and vgate variants differ only in TPU placement (leaf table
# streamed from HBM) or gating (vreg-granular leaf MT, exact), so they
# name the same kernel here; ``packet`` is the skip kernel.
KERNEL_ALIASES = {"quad": "quad", "pair": "pair", "oct": "oct",
                  "frontier": "frontier", "packet": "packet",
                  "quad_hbm": "quad", "oct_hbm": "oct",
                  "frontier_hbm": "frontier", "vgate": "quad",
                  "vgate_hbm": "quad"}
ANYHIT_KERNELS = ("frontier",)   # None: quad (pair on two-level scenes)
MT_MODES = ("exact", "mxu")
# The coefficient product of VKPT_MXU_PRECISION (mxu_mt.mxu_precision):
# "highest" sums f32 products; "default" is the one bf16 pass, both
# operands rounded to bf16 (JAX's "high" aliases "highest").
MXU_PRECISIONS = ("highest", "default")
FRONTIER_WIDTHS = (16, 32)
# The frontier bake's guard band by VKPT_FRONTIER_PRECISION
# (pallas_frontier._guard): 2^-7 for the one-pass bf16 node product,
# 2^-12 for the f32-exact ones; VKPT_FRONTIER_GUARD overrides it.
FRONTIER_GUARDS = {"default": 2.0 ** -7, "high": 2.0 ** -12,
                   "highest": 2.0 ** -12}
FRONTIER_GUARD = FRONTIER_GUARDS["default"]


@dataclass(frozen=True)
class Tiers:
    """The kernel choice of one frame (RenderConfig.tiers)."""
    traversal: str = "auto"
    kernel_primary: Optional[str] = None
    kernel_secondary: Optional[str] = None
    anyhit_kernel: Optional[str] = None
    mt: str = "exact"
    mxu_precision: str = "highest"

    @classmethod
    def of(cls, config) -> "Tiers":
        """The tier fields of a render configuration; one without them
        (the JAX package's RenderConfig) has the defaults."""
        return cls(**{f: getattr(config, f, getattr(cls, f))
                      for f in ("traversal", "kernel_primary",
                                "kernel_secondary", "anyhit_kernel", "mt",
                                "mxu_precision")})

    def validate(self) -> None:
        """Raise ValueError on a name the dispatch does not know."""
        for what, name in (("kernel_primary", self.kernel_primary),
                           ("kernel_secondary", self.kernel_secondary)):
            if name is not None and name not in KERNEL_ALIASES:
                raise ValueError(f"{what}: unknown kernel {name!r} "
                                 f"({' | '.join(KERNEL_ALIASES)})")
        if (self.anyhit_kernel is not None
                and self.anyhit_kernel not in ANYHIT_KERNELS):
            raise ValueError(f"anyhit_kernel: unknown kernel "
                             f"{self.anyhit_kernel!r} (frontier, or unset)")
        if self.mt not in MT_MODES:
            raise ValueError(f"mt: {self.mt!r} is not exact | mxu")
        if self.mxu_precision not in MXU_PRECISIONS:
            raise ValueError(f"mxu_precision: {self.mxu_precision!r} is not "
                             f"highest | default")


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

    # ---- kernel tiers of --traversal auto|pallas (render/wavefront.py) ---
    # The JAX package reads these from its VKPT_* variables deep in the
    # dispatch; the port's CLI reads those variables once
    # (app/main.tier_fields_from_env) and everything else takes the
    # fields.  None = JAX's default: primary pair at leaf <= 14, quad
    # above; secondary quad; last bounce quad any hit.
    kernel_primary: Optional[str] = None    # VKPT_KERNEL_PRIMARY
    kernel_secondary: Optional[str] = None  # VKPT_KERNEL_SECONDARY
    anyhit_kernel: Optional[str] = None     # VKPT_ANYHIT_KERNEL (frontier)
    mt: str = "exact"                       # VKPT_MT: exact | mxu
    # VKPT_MXU_PRECISION: the coefficient table's product, f32
    # ("highest") or one bf16 pass ("default"); the bake makes the table
    # in it, and the kernels follow the table's dtype.
    mxu_precision: str = "highest"
    max_leaf: Optional[int] = None          # VKPT_LEAF (None: size policy)
    frontier_width: int = FRONTIER_WIDTH    # VKPT_FRONTIER_WIDTH: 16 | 32
    # The frontier bake's guard band (VKPT_FRONTIER_GUARD, else by
    # VKPT_FRONTIER_PRECISION); the scene keeps the one it was baked with.
    frontier_guard: float = FRONTIER_GUARD
    presplit: float = 0.0                   # VKPT_PRESPLIT (flat bake)

    @property
    def tiers(self) -> "Tiers":
        """The closest-hit / any-hit choice the wavefront dispatches on."""
        return Tiers.of(self)

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
