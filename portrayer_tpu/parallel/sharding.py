"""Multi-card execution: rays sharded over a device mesh, scene replicated.

The reference parallelizes with a rayon work-stealing pool over pixels
(src/render.rs:127-150) in one shared-memory process.  The device
equivalent (SURVEY §2 parallelism table) is SPMD data parallelism over the
ray/sample grid: each card traces a shard of the rays against a replicated
scene table, accumulates a partial framebuffer, and a `psum` over the mesh
axis combines tiles — the only cross-card communication in the forward
pass.  The backward pass (differentiable rendering) reuses the same psum
for gradient all-reduce via shard_map's AD transpose.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..config import RenderConfig
from ..scene.flatten import SceneTables
from ..ops.trace import trace

RAY_AXIS = "rays"

# Scene/material arrays a differentiable render step takes gradients for.
# "inv" is the per-node world->local transform table — its gradients are the
# node-transform gradients of the north star (chain rule through the inverse
# is the caller's concern; the flat table *is* the device-side parameter).
DIFF_FIELDS = (
    "mat_diffuse", "mat_specular", "mat_reflectivity", "mat_shininess",
    "light_color", "light_pos", "ambient", "inv",
)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = RAY_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def trace_sharded(
    mesh: Mesh, key, o, d, pix, bg, n_pixels: int,
    st: SceneTables, cfg: RenderConfig, w0=None,
):
    """Trace rays [R,3] sharded over the mesh's ray axis.

    R must be divisible by the mesh size.  Returns the replicated
    framebuffer accumulation [n_pixels, 3] (sum over all rays)."""
    axis = mesh.axis_names[0]
    st_specs = jax.tree_util.tree_map(lambda _: P(), st)
    if w0 is None:
        w0 = jnp.ones((o.shape[0],), o.dtype)

    def fwd(key, o, d, pix, bg, w0, st):
        # Decorrelate per-shard sampling.
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        acc = trace(key, o, d, pix, bg, n_pixels, st, cfg, w0=w0)
        return jax.lax.psum(acc, axis)

    # Disable the replication/varying-axis checker: the wavefront loop's
    # scan carries start replicated and become per-shard varying, which the
    # static checker can't express without pcasts sprinkled everywhere.
    sharded = shard_map(
        fwd, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(), P(axis), st_specs),
        out_specs=P(), check_vma=False,
    )
    # Eager calls need a jit wrapper: the bounce rounds run under
    # jax.checkpoint, which shard_map cannot evaluate eagerly.  When
    # already inside a trace the wrapper is SKIPPED — the nested jit
    # becomes a closed_call boundary in the AD while-loops, which made
    # castle fwd+bwd ~3x slower on an earlier accelerator (not measured
    # on the GPU).
    if isinstance(key, jax.core.Tracer):
        return sharded(key, o, d, pix, bg, w0, st)
    return jax.jit(sharded)(key, o, d, pix, bg, w0, st)


def split_params(st: SceneTables, fields=DIFF_FIELDS) -> Tuple[dict, SceneTables]:
    """Split the differentiable arrays out of the scene tables."""
    params = {f: getattr(st, f) for f in fields}
    return params, st


def train_step(
    mesh: Mesh, key, o, d, pix, bg, n_pixels: int, spp: int, target,
    st: SceneTables, cfg: RenderConfig, fields=DIFF_FIELDS,
):
    """One differentiable render-and-fit step over the device mesh.

    loss = MSE(mean-radiance image, target); returns (loss, grads) where
    grads covers `fields` (default DIFF_FIELDS).  Gradients flow through
    the full wavefront bounce loop; the psum in trace_sharded transposes
    into the gradient all-reduce."""
    # Every accel mode is differentiable: the sweeps are stop_gradient-ed
    # selection oracles and hit_detail reattaches a differentiable t
    # (see ops/intersect.py), so training runs at accelerated-sweep speed.
    params, _ = split_params(st, fields)

    def loss_fn(params):
        st2 = st.replace(**params)
        acc = trace_sharded(mesh, key, o, d, pix, bg, n_pixels, st2, cfg)
        img = acc / spp
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


def render_tiles_sharded(
    mesh: Mesh, st: SceneTables, camera, size, background,
    cfg: RenderConfig, key=None,
):
    """Render a whole frame with rays data-parallel over the device mesh.

    The multi-card form of the reference's rayon pixel parallelism
    (src/render.rs:127-150): every card traces an equal shard of the
    (pixel x sample) ray grid against the replicated scene tables; one
    psum combines the per-card framebuffers.  Returns the linear
    mean-radiance image [H,W,3] (numpy).
    """
    width, height = size
    spp = cfg.resolved_samples()
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    o, d, pix, bg, w0 = frame_rays(
        camera, size, background, cfg, mesh.devices.size, key)
    acc = trace_sharded(
        mesh, jax.random.fold_in(key, 1), o, d, pix, bg, width * height,
        st, cfg, w0=w0,
    )
    img = np.asarray(acc, np.float64).reshape(height, width, 3) / spp
    return img


def frame_rays(camera, size, background, cfg: RenderConfig, n_dev: int, key):
    """The jittered (pixel x sample) primary rays of a whole frame, pixel
    major, padded with zero-throughput rays to a multiple of `n_dev`.

    Returns (o, d, pix, bg, w0), w0 the per-ray throughput (0 on
    padding).  The jitter is drawn from fold_in(key, 0)."""
    from ..camera import Camera

    width, height = size
    cam = Camera(camera, (width, height), dtype=cfg.dtype)
    spp = cfg.resolved_samples()
    P_ = width * height
    R = P_ * spp
    pad = (-R) % n_dev

    ys, xs = np.mgrid[0:height, 0:width]
    px = jnp.asarray(np.repeat(xs.reshape(-1), spp), cfg.dtype)
    py = jnp.asarray(np.repeat(ys.reshape(-1), spp), cfg.dtype)
    jitter = jax.random.uniform(jax.random.fold_in(key, 0), (R, 2), cfg.dtype)
    o, d = cam.rays_at(px + jitter[:, 0], py + jitter[:, 1])
    pix = jnp.asarray(np.repeat(np.arange(P_), spp), jnp.int32)

    # Background at integer-pixel uv (render.rs:31-34).
    uv_pix = jnp.asarray(
        np.stack([xs.reshape(-1) / width, ys.reshape(-1) / height], axis=-1),
        cfg.dtype,
    )
    bg = background(uv_pix).astype(cfg.dtype)

    if pad:  # padding rays carry zero throughput
        o = jnp.pad(o, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        pix = jnp.pad(pix, (0, pad))
    w0 = jnp.concatenate(
        [jnp.ones((R,), cfg.dtype), jnp.zeros((pad,), cfg.dtype)])
    return o, d, pix, bg, w0
