"""Render configuration.

The reference (sunjay/portrayer) exposes its knobs through env vars
(``SAMPLES`` — src/render.rs:107-113, ``KD_DEPTH`` — src/kdtree/kdscene.rs:36,
``KD_MESH_DEPTH`` — src/kdtree/kdmesh.rs:51) and cargo features
(``kdtree``/``flat_scene`` — Cargo.toml:29-36).  Here the same knobs live in a
single dataclass that is threaded through the renderer, plus controls of
the device pipeline (dtype, tile shape, wavefront queue capacity, sweep).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax.numpy as jnp

# Mirrors EPSILON in the reference (src/math.rs:15).  Used for t-range starts
# and containment slack in primitive tests (local/unit-object space).
EPSILON = 1e-5

# Gamma used for encode/decode (src/math.rs:20).
GAMMA = 2.2

# Maximum ray recursion depth (src/material.rs:12).
MAX_RECURSION_DEPTH = 10

# Indices of refraction (src/material.rs:15-23).
AIR_REFRACTION_INDEX = 1.00
WATER_REFRACTION_INDEX = 1.33
WINDOW_GLASS_REFRACTION_INDEX = 1.51
OPTICAL_GLASS_REFRACTION_INDEX = 1.92
DIAMOND_REFRACTION_INDEX = 2.42

# Scene intersection sweeps (RenderConfig.accel).
ACCELS = ("flat", "beam")


def _env_samples(default: int = 100) -> int:
    """SAMPLES env var semantics of the reference: positive int or default."""
    val = os.environ.get("SAMPLES")
    if val is not None:
        try:
            parsed = int(val)
            if parsed > 0:
                return parsed
        except ValueError:
            pass
    return default


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Controls sampling, precision and the wavefront execution shape."""

    # Samples per pixel (jittered).  Default matches the reference default of
    # 100; the SAMPLES env var overrides it, like src/render.rs:107-113.
    samples: Optional[int] = None

    # Maximum recursion depth for reflect/refract rays.
    max_depth: int = MAX_RECURSION_DEPTH

    # Compute dtype for the ray pipeline.  float32 is the production choice;
    # float64 is available (on CPU) for high-precision verification runs
    # against the f64 reference (SURVEY §7(d)) — it requires JAX's x64 mode
    # (run under `with jax.enable_x64(True):` or set JAX_ENABLE_X64=1),
    # which __post_init__ enforces so the mode can never silently truncate
    # back to f32.
    dtype: jnp.dtype = jnp.float32

    # Absolute epsilon for t-range starts (parity with the reference).
    epsilon: float = EPSILON

    # Additional *relative* epsilon applied to secondary/shadow ray starts to
    # keep float32 robust on large scenes:  t_min = max(epsilon, eps_rel*|o|).
    # The reference runs in f64 and does not need this.  Set to 0 for exact
    # parity semantics.
    eps_rel: float = 3e-4

    # Self-intersection guard: a secondary ray re-testing the surface it
    # spawned from uses this epsilon in the *local units* of that node
    # (t_min_self = self_eps_local / |d_local|).  This is the float32-robust
    # replacement for the f64 reference's flat EPSILON: near-tangent rays on
    # heavily scaled primitives have sqrt(f32_eps)-amplified uncertainty.
    # 0 restores strict reference semantics.
    self_eps_local: float = 2e-3

    # Pixels per render tile (height, width).  Each launched wavefront batch
    # covers tile pixels x spp_chunk samples.
    tile: Tuple[int, int] = (128, 128)

    # Max rays per wavefront launch; spp are chunked so that
    # tile_px * spp_chunk <= max_rays_per_launch.
    max_rays_per_launch: int = 131072

    # Capacity of the bounce queue as a multiple of the primary ray count.
    # Whitted recursion can branch 2x per bounce (reflect+refract); children
    # are kept by descending throughput when the queue overflows.  None
    # (default) auto-sizes: 4x when the scene has refractive materials
    # (each round emits 2 children and both branches carry energy — the
    # reference never drops a child, src/material.rs:216-317), else 1x
    # (reflect-only rounds emit at most one live child per parent).
    queue_factor: Optional[float] = None

    # Per-round bounce-queue capacity schedule: round r's queue holds
    # queue_caps[r-1] x primary-rays lanes (the last entry repeats for
    # deeper rounds).  Live-ray counts decay fast on most scenes (castle:
    # 6.5% after round 1, <2% after round 2 — measured), so a shrinking
    # schedule cuts bounce-round cost by the capacity ratio; overflow
    # falls back to the highest-throughput-survives policy.  None = flat
    # queue_factor capacity every round (exact reference-parity default).
    # Scene specs carry measured hints (scenes.SceneSpec.queue_caps).
    queue_caps: Optional[Tuple[float, ...]] = None

    # Rays with throughput below this are killed early (0 = strict parity).
    min_throughput: float = 0.0

    # Node-chunk size for the intersection sweep (controls peak memory:
    # rays_per_launch x node_chunk temporaries).
    node_chunk: int = 512

    # Triangle-pair chunk size for mesh intersection sweeps.
    tri_chunk: int = 512

    # RNG seed for jitter/glossy/area-light sampling.  Renders are fully
    # deterministic given (seed, config) — unlike the reference's thread_rng
    # (SURVEY §4 nondeterminism caveat).
    seed: int = 0

    # Soft-visibility silhouette gradients: when > 0, each hit's
    # contribution is scaled by sigmoid(margin/width - 3) where margin is a
    # differentiable distance-to-silhouette (ops/intersect.HitDetail.margin)
    # and this value is the width in local units; the complementary energy
    # goes to the background.  The render becomes (nearly) continuous in
    # scene parameters, so visibility discontinuities produce usable
    # gradients (SURVEY §7 step 10) at the cost of a thin translucent band
    # inside silhouettes.  0 (default) = exact reference semantics.
    soft_visibility: float = 0.0

    # Debug: render every mesh as its AABB cube instead of its triangles —
    # the reference's `render_bounding_volumes` cargo feature
    # (src/primitive/mesh.rs:170-176).  Applied when the renderer is given
    # a Scene (not pre-flattened tables).
    render_bounding_volumes: bool = False

    # Scene intersection sweep: "flat" (brute-force XLA sweep over every
    # primitive — the plain reference) or "beam" (the ordered warp-beam
    # XLA sweep of ops/beam.py, the analogue of the reference's kdtree
    # cargo feature; scenes under beam_min_prims primitives run the flat
    # sweep).  Both are differentiable.  The default is the faster of the
    # two end to end on an H100 (PERF.md).
    accel: str = "beam"

    # Adaptive bounce-round capacity variants: each round lax.switches
    # into the smallest queue head-slice (capacity//div, block-aligned)
    # that holds the live count (live lanes are compacted to the front).
    # (1,) disables the downshift (every round at full capacity).
    queue_slice_divs: Tuple[int, ...] = (16, 4, 1)

    # Bounce rounds at or above this lane count run under jax.checkpoint
    # (backward replays shading instead of keeping the shading temps as
    # residuals).  0 (default) = every round.  The default was chosen on
    # an earlier accelerator, whose padded layout of [R,3] arrays made
    # residuals the memory limit; it is not measured on the GPU yet.
    remat_min_lanes: int = 0

    # Python-unroll the uniform-capacity bounce-round tail instead of
    # sharing one lax.scan body: ~(max_depth)x the compile time, but the
    # backward avoids the scan's per-iteration residual mechanics.
    unroll_tail: bool = False

    # Beam-sweep parameters: rays per warp, number of front-to-back t
    # segments, candidate chunk size, and the minimum primitive count below
    # which the brute-force sweep is used instead.
    warp_size: int = 256
    n_segments: int = 16
    beam_chunk: int = 64
    beam_min_prims: int = 192

    def __post_init__(self):
        if self.dtype == jnp.float64:
            import jax

            if not jax.config.jax_enable_x64:
                raise ValueError(
                    "RenderConfig(dtype=float64) needs JAX x64 mode or the "
                    "arrays silently truncate to float32: wrap the run in "
                    "`with jax.enable_x64(True):` (or set JAX_ENABLE_X64=1)."
                )
        if self.accel not in ACCELS:
            raise ValueError(
                f"unknown accel {self.accel!r}; expected one of {ACCELS}")
        if self.queue_caps is not None and len(self.queue_caps) == 0:
            raise ValueError("queue_caps must be None or non-empty")

    def resolved_samples(self) -> int:
        return self.samples if self.samples is not None else _env_samples()


DEFAULT_CONFIG = RenderConfig()
