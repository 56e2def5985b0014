"""Numerical-safety checks — the device-side answer to the reference's
race/panic story (SURVEY §5): the reference leans on Rust ownership and
rayon's panic_fuse (src/render.rs:36,130); an XLA pipeline is SPMD-pure, so
the failure modes that remain are numerical (NaN/Inf radiance, divergent
normals).  `checked_trace` runs the wavefront loop under jax.checkify and
reports float errors with their source location; `assert_image_finite` is
a cheap post-hoc guard for production renders."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from .config import RenderConfig
from .ops.trace import trace


def checked_trace(key, o, d, pix, bg, n_pixels, st, cfg: RenderConfig):
    """Run trace() under checkify float checks (NaN/Inf anywhere in the
    bounce loop).  Returns (err, acc); call err.throw() to raise.

    Uses the flat sweep: checkify cannot instrument the beam path's
    dynamic-trip while_loop.
    """
    import dataclasses

    if cfg.accel != "flat":
        cfg = dataclasses.replace(cfg, accel="flat")

    def run(key, o, d, pix, bg, st):
        return trace(key, o, d, pix, bg, n_pixels, st, cfg)

    checked = checkify.checkify(run, errors=checkify.float_checks)
    return checked(key, o, d, pix, bg, st)


def queue_overflow_fraction(
    scene_or_tables, camera, size, background, cfg: RenderConfig,
    max_rays: int = 65536,
):
    """Fraction of primary throughput terminated by bounce-queue overflow
    (TraceStats.dropped_w) on a FULL-FRAME strided subsample of the view.

    This is the loud-failure gate for stale per-scene queue_caps hints
    (the round-4 castle bug: caps measured on a crop silently dropped 20%
    of full-frame energy to background).  Full-frame coverage matters —
    a crop can miss exactly the geometry (e.g. water) that keeps rays
    alive.  The self-golden generator asserts this stays ~0 for every
    scene it pins."""
    import numpy as np

    from .camera import Camera
    from .scene.flatten import flatten_scene, SceneTables

    if isinstance(scene_or_tables, SceneTables):
        st = scene_or_tables
    else:
        st = flatten_scene(scene_or_tables, dtype=cfg.dtype)
    w, h = size
    cam = Camera(camera, (w, h), dtype=cfg.dtype)
    stride = max(1, (w * h) // max_rays)
    flat = np.arange(0, w * h, stride)
    P_ = flat.shape[0]
    px = jnp.asarray(flat % w, cfg.dtype) + 0.5
    py = jnp.asarray(flat // w, cfg.dtype) + 0.5
    o, d = cam.rays_at(px, py)
    pix = jnp.arange(P_, dtype=jnp.int32)
    bg_uv = jnp.stack([px / w, py / h], axis=-1)
    bg = background(bg_uv).astype(cfg.dtype)
    _, stats = jax.jit(
        lambda k, o, d, pix, bg: trace(
            k, o, d, pix, bg, P_, st, cfg, with_stats=True)
    )(jax.random.PRNGKey(cfg.seed), o, d, pix, bg)
    return float(stats.dropped_w)


def assert_image_finite(img, context: str = "render"):
    """Raise with a diagnostic if an image contains NaN/Inf texels."""
    import numpy as np

    arr = np.asarray(img)
    bad = ~np.isfinite(arr)
    if bad.any():
        first = np.unravel_index(int(np.argmax(bad)), arr.shape)
        raise FloatingPointError(
            f"{context}: {int(bad.sum())} non-finite values; first at "
            f"index {tuple(int(i) for i in first)}"
        )
    return img
