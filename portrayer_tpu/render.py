"""Render driver — tiled, sample-chunked wavefront rendering
(the analogue of src/render.rs).

Per pixel the reference computes: background gradient at integer pixel uv
(render.rs:31-34), SAMPLES jittered camera rays traced recursively
(render.rs:36-43), mean, gamma encode c^(1/2.2), clamp01, u8 truncation
(render.rs:45-50,143-147).  Here the image is processed in static-shape
pixel tiles x sample chunks; each launch traces tile_px*spp_chunk rays
through the wavefront loop and scatter-adds radiance per pixel.  Tiles give
bounded memory, natural multi-chip sharding, and incremental re-render of
slices (the reference's Image::slice_mut checkpointing, render.rs:211-213).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .config import RenderConfig, GAMMA
from .camera import Camera, CameraSettings
from .scene.node import Scene
from .scene.flatten import flatten_scene, SceneTables
from .ops.trace import trace
from .reporter import Reporter, NullProgress


def default_background(uv):
    """Flat black background (callers usually pass a gradient fn)."""
    return jnp.zeros(uv.shape[:-1] + (3,), uv.dtype)


def _tile_chunk(
    key, st: SceneTables, eye, view_to_world, x0, y0, sample_offset,
    *, cfg: RenderConfig, background, tile_h: int, tile_w: int, spp: int,
    samples: int, width: float, height: float, aspect: float,
    fov_factor: float,
):
    """Trace one (tile x sample-chunk) wavefront; returns acc [P,3]."""
    dtype = cfg.dtype
    P = tile_h * tile_w
    R = P * spp

    row = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
    px = (col + x0).reshape(-1)  # [P] integer pixel x
    py = (row + y0).reshape(-1)

    # Background at integer-pixel uv (render.rs:31-34).
    bg_uv = jnp.stack(
        [px.astype(dtype) / width, py.astype(dtype) / height], axis=-1
    )
    bg = background(bg_uv).astype(dtype)  # [P,3]

    # Jittered sample positions (render.rs:38-39): x + U[0,1).  Drawn in
    # f32 regardless of cfg.dtype so the f64 verification mode samples the
    # SAME sub-pixel positions as f32 — the two renders then differ only
    # by arithmetic precision, never by sampling noise.
    jitter = jax.random.uniform(
        jax.random.fold_in(key, 0), (R, 2), jnp.float32).astype(dtype)
    xs = jnp.repeat(px.astype(dtype), spp) + jitter[:, 0]
    ys = jnp.repeat(py.astype(dtype), spp) + jitter[:, 1]
    pix_id = jnp.repeat(jnp.arange(P, dtype=jnp.int32), spp)
    # Samples beyond the requested count (chunk padding) carry zero weight.
    sample_ix = jax.lax.broadcasted_iota(jnp.int32, (P, spp), 1).reshape(-1)
    live = (sample_ix + sample_offset) < samples

    # Camera rays (camera.rs:48-84).
    ndc_x = xs / width
    ndc_y = ys / height
    view_x = (2.0 * ndc_x - 1.0) * aspect * fov_factor
    view_y = (1.0 - 2.0 * ndc_y) * fov_factor
    pixel_view = jnp.stack([view_x, view_y, -jnp.ones_like(view_x)], axis=-1)
    # Elementwise f32 rather than einsum — see the math3d note on reduced
    # dot precision.
    pixel_world = (
        jnp.sum(view_to_world[None, :, :3] * pixel_view[:, None, :], axis=-1)
        + view_to_world[:, 3]
    )
    delta = pixel_world - eye
    d = delta / jnp.sqrt(jnp.sum(delta * delta, axis=-1, keepdims=True))
    o = jnp.broadcast_to(eye, d.shape).astype(dtype)

    acc = trace(
        jax.random.fold_in(key, 1), o, d, pix_id, bg, P, st, cfg,
        w0=live.astype(dtype), spp_contiguous=spp,
    )
    return acc  # [P,3] radiance sums (divide by total spp at finalize)


# Live-progress plumbing: the whole image is ONE device dispatch (lax.map
# over tiles), so per-tile ticks surface through jax.debug.callback — the
# wavefront analogue of the reference's watcher-thread progress bar
# (src/reporter.rs:16-84).  A fixed slot id keeps the jit cache at two
# variants (with/without progress); the slot maps to the live reporter.
_PROGRESS_SLOT = {}


def _progress_tick(_):
    r = _PROGRESS_SLOT.get(0)
    if r is not None:
        r.tick()


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "background", "tile_h", "tile_w", "spp", "n_chunks",
        "samples", "width", "height", "aspect", "fov_factor", "grid",
        "as_u8", "progress",
    ),
)
def _render_image(
    key, st: SceneTables, eye, view_to_world,
    *, cfg: RenderConfig, background, tile_h: int, tile_w: int, spp: int,
    n_chunks: int, samples: int, width: float, height: float,
    aspect: float, fov_factor: float, grid, as_u8: bool = False,
    progress: bool = False,
):
    """Render every tile in `grid` (static tuple of (x0, y0) origins) in a
    single device dispatch: lax.map over tiles, fori_loop over sample
    chunks.  Returns [T, tile_h, tile_w, 3] mean radiance — or, with
    as_u8, the gamma-encoded u8 image tiles (render.rs:47-50,143-147
    computed on device; 4x less device->host transfer)."""
    dtype = cfg.dtype
    P = tile_h * tile_w
    origins = jnp.asarray(grid, jnp.int32)  # [T,2] (x0, y0)

    def tile_fn(tix):
        origin = origins[tix]
        # Key by tile *origin* so a slice re-render reproduces exactly the
        # same samples as a full render of the same tile.
        tkey = jax.random.fold_in(jax.random.fold_in(key, origin[0]), origin[1])

        def chunk_fn(ci, acc):
            ckey = jax.random.fold_in(tkey, ci)
            return acc + _tile_chunk(
                ckey, st, eye, view_to_world, origin[0], origin[1],
                ci * spp,
                cfg=cfg, background=background, tile_h=tile_h,
                tile_w=tile_w, spp=spp, samples=samples, width=width,
                height=height, aspect=aspect, fov_factor=fov_factor,
            )

        acc = jax.lax.fori_loop(0, n_chunks, chunk_fn, jnp.zeros((P, 3), dtype))
        if progress:
            jax.debug.callback(_progress_tick, tix, ordered=False)
        mean = (acc / samples).reshape(tile_h, tile_w, 3)
        if as_u8:
            enc = jnp.clip(
                jnp.maximum(mean, 0.0) ** (1.0 / GAMMA), 0.0, 1.0
            )
            return (enc * 255.0).astype(jnp.uint8)
        return mean

    return jax.lax.map(tile_fn, jnp.arange(len(grid)))


def render_linear(
    scene_or_tables,
    camera: CameraSettings,
    size: Tuple[int, int],
    background: Callable = default_background,
    cfg: RenderConfig = RenderConfig(),
    region: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
    reporter: Optional[Reporter] = None,
) -> np.ndarray:
    """Render and return the *linear* mean-radiance image [H,W,3] float.

    `region` = ((x1,y1),(x2,y2)) inclusive slice to render (others zero)."""
    return _render_common(
        scene_or_tables, camera, size, background, cfg, region, reporter,
        as_u8=False,
    )


def _frame_call(scene_or_tables, camera, size, background, cfg, region,
                as_u8: bool, progress: bool = False):
    """The static tile grid and the arguments of the one `_render_image`
    dispatch that renders `region` of the frame (the whole frame for
    None): returns (grid, tile_h, tile_w, args, kwargs)."""
    width, height = size
    if isinstance(scene_or_tables, SceneTables):
        st = scene_or_tables
    else:
        scene = scene_or_tables
        if cfg.render_bounding_volumes:
            from .scene.node import bounding_volume_scene

            scene = bounding_volume_scene(scene)
        st = flatten_scene(scene, dtype=cfg.dtype)

    cam = Camera(camera, (width, height), dtype=cfg.dtype)
    samples = cfg.resolved_samples()

    tile_h = min(cfg.tile[0], height)
    tile_w = min(cfg.tile[1], width)
    spp_chunk = max(1, min(samples, cfg.max_rays_per_launch // (tile_h * tile_w)))
    n_chunks = -(-samples // spp_chunk)

    if region is None:
        x_lo, y_lo, x_hi, y_hi = 0, 0, width - 1, height - 1
    else:
        (x_lo, y_lo), (x_hi, y_hi) = region

    n_ty = -(-height // tile_h)
    n_tx = -(-width // tile_w)

    # Static tile grid: only tiles intersecting the slice region.
    grid = []
    for ty in range(n_ty):
        for tx in range(n_tx):
            tx0, ty0 = tx * tile_w, ty * tile_h
            if tx0 > x_hi or ty0 > y_hi or tx0 + tile_w - 1 < x_lo or ty0 + tile_h - 1 < y_lo:
                continue
            grid.append((tx0, ty0))
    grid = tuple(grid)

    args = (jax.random.PRNGKey(cfg.seed), st, cam.eye, cam.view_to_world)
    kwargs = dict(
        cfg=cfg, background=background, tile_h=tile_h, tile_w=tile_w,
        spp=spp_chunk, n_chunks=n_chunks, samples=samples,
        width=cam.width, height=cam.height,
        aspect=cam.aspect, fov_factor=cam.fov_factor, grid=grid,
        as_u8=as_u8, progress=progress,
    )
    return grid, tile_h, tile_w, args, kwargs


def lower_frame(
    scene_or_tables,
    camera: CameraSettings,
    size: Tuple[int, int],
    background: Callable = default_background,
    cfg: RenderConfig = RenderConfig(),
    as_u8: bool = True,
):
    """The whole-frame program that render_u8 (as_u8) or render_linear
    dispatches, lowered but not run — for reading its compiled HLO."""
    *_, args, kwargs = _frame_call(
        scene_or_tables, camera, size, background, cfg, None, as_u8)
    return _render_image.lower(*args, **kwargs)


def _render_common(
    scene_or_tables, camera, size, background, cfg, region, reporter,
    as_u8: bool,
):
    width, height = size
    reporter = reporter or NullProgress(0)
    progress = not isinstance(reporter, NullProgress)
    grid, tile_h, tile_w, args, kwargs = _frame_call(
        scene_or_tables, camera, size, background, cfg, region, as_u8,
        progress)
    reporter.start(total=len(grid))
    if progress:
        _PROGRESS_SLOT[0] = reporter

    try:
        # One device dispatch for the whole image; one device->host
        # transfer.  Per-tile progress ticks arrive via debug callbacks
        # while the dispatch runs.
        tiles = _render_image(*args, **kwargs)
        out_dtype = np.uint8 if as_u8 else np.float64
        tiles = np.asarray(tiles, dtype=out_dtype)  # [T, th, tw, 3]
    finally:
        if progress:
            _PROGRESS_SLOT.pop(0, None)

    out = np.zeros((height, width, 3), dtype=out_dtype)
    for (tx0, ty0), tile in zip(grid, tiles):
        ylim = min(ty0 + tile_h, height)
        xlim = min(tx0 + tile_w, width)
        out[ty0:ylim, tx0:xlim] = tile[: ylim - ty0, : xlim - tx0]
    reporter.finish()
    return out


def render_u8(
    scene_or_tables,
    camera: CameraSettings,
    size: Tuple[int, int],
    background: Callable = default_background,
    cfg: RenderConfig = RenderConfig(),
    region: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
    reporter: Optional[Reporter] = None,
) -> np.ndarray:
    """Render straight to the gamma-encoded u8 image [H,W,3] (the
    reference's final pixel format, render.rs:143-147), finalized on
    device."""
    return _render_common(
        scene_or_tables, camera, size, background, cfg, region, reporter,
        as_u8=True,
    )


def finalize(linear: np.ndarray) -> np.ndarray:
    """Gamma-encode + clamp (render.rs:47-50). Returns float [H,W,3] 0..1."""
    return np.clip(np.maximum(linear, 0.0) ** (1.0 / GAMMA), 0.0, 1.0)


def to_u8(img01: np.ndarray) -> np.ndarray:
    """u8 quantization by truncation, like `(c * 255.0) as u8`
    (render.rs:143-147)."""
    return (img01 * 255.0).astype(np.uint8)


class Image:
    """Mirrors the reference's Image (src/render.rs:154-224): opens an
    existing PNG of matching size (slice re-render keeps the rest), renders
    scenes, saves PNGs."""

    def __init__(self, path, width: int, height: int):
        self.path = path
        self.width = width
        self.height = height
        self.buffer = np.zeros((height, width, 3), dtype=np.uint8)
        if path is not None and os.path.exists(path):
            from PIL import Image as PILImage

            img = PILImage.open(path).convert("RGB")
            if img.size == (width, height):
                self.buffer = np.asarray(img, dtype=np.uint8).copy()

    def render(
        self, scene: Scene, camera: CameraSettings,
        background: Callable = default_background,
        cfg: RenderConfig = RenderConfig(),
        region=None, reporter: Optional[Reporter] = None,
    ):
        u8 = render_u8(
            scene, camera, (self.width, self.height), background, cfg,
            region=region, reporter=reporter,
        )
        if region is None:
            self.buffer = u8
        else:
            (x1, y1), (x2, y2) = region
            self.buffer[y1:y2 + 1, x1:x2 + 1] = u8[y1:y2 + 1, x1:x2 + 1]
        return self

    def slice_render(self, top_left, bottom_right, *args, **kwargs):
        return self.render(*args, region=(top_left, bottom_right), **kwargs)

    def save(self):
        return self.save_as(self.path)

    def save_as(self, path):
        """Write the buffer as a PNG file (whatever the path's suffix):
        the native codec when it is built, else the stdlib encoder."""
        from . import native, png

        data = native.png_encode(self.buffer)
        if data is None:
            data = png.encode(self.buffer)
        with open(path, "wb") as f:
            f.write(data)
        return path
