"""Multi-host runtime: process-per-host SPMD over a global device mesh.

The reference is a single shared-memory process (rayon threads over pixels,
src/render.rs:127-150).  Scaling past one host means one Python process per
host, `jax.distributed.initialize` to form the global runtime, and a mesh
spanning every card of the job: XLA hands the psum in `trace_sharded` to
NCCL (NVLink between the cards of a host, the network between hosts) — no
hand-written communication backend (SURVEY §5 "distributed communication
backend").

Design: rays are sharded over the single global mesh axis exactly as in the
single-host path (parallel/sharding.py); the scene tables are replicated on
every card; each process feeds only its addressable shard of the ray grid
(`make_global_rays`), and the replicated framebuffer psum means host 0 can
read the full image locally (`fetch_replicated`) — the "tile gather to host
0" of SURVEY §5 costs one device->host copy, no extra collective.

Single-process use degenerates gracefully: `initialize()` is a no-op when
unconfigured, the global mesh equals the local mesh, and everything below
runs on a CPU mesh for tests (tests/test_multichip.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import RAY_AXIS, trace_sharded


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or form) the multi-host runtime.  Returns True when a
    multi-process runtime is active after the call.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers can configure hosts
    without code changes.  A plain single-process run (nothing configured)
    is a no-op."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return jax.process_count() > 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def global_mesh(axis_name: str = RAY_AXIS) -> Mesh:
    """1-D mesh over every card in the job (all processes), in
    jax.devices() order.  The cards of one host are joined all to all by
    NVLink, so the mesh follows the algorithm alone: a blocked 1-D ray
    sharding whose only collective is the framebuffer psum."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def make_global_rays(mesh: Mesh, make_shard, R: int, feature_dims=(3, 3)):
    """Build globally-sharded ray arrays from per-process data.

    `make_shard(lo, hi) -> tuple of np arrays` produces this process's rows
    [lo, hi) for each ray feature (e.g. origins [n,3], dirs [n,3]); rows are
    blocked over the mesh axis.  Each process materializes only its
    addressable shard — the whole-frame ray grid never exists on one host.
    Returns a tuple of jax global arrays shaped [R, *feature_dims[i]].
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    assert R % n_dev == 0, "pad rays to a multiple of the mesh size"
    per = R // n_dev
    sharding = NamedSharding(mesh, P(axis))
    cache = {}

    def shard_rows(lo):
        if lo not in cache:
            cache[lo] = make_shard(lo, lo + per)
        return cache[lo]

    outs = []
    for fi in range(len(feature_dims)):
        dims = feature_dims[fi]
        shape = (R,) + (tuple(dims) if isinstance(dims, (tuple, list))
                        else ((dims,) if dims else ()))

        def cb(index, fi=fi):
            lo = index[0].start or 0
            return shard_rows(lo)[fi]

        outs.append(jax.make_array_from_callback(shape, sharding, cb))
    return tuple(outs)


def fetch_replicated(x) -> np.ndarray:
    """Read a fully-replicated global array on this host (host-0 gather:
    the psum already placed the full framebuffer on every card)."""
    return np.asarray(jax.device_get(x.addressable_data(0)))


def render_frame_distributed(
    mesh: Mesh, st, camera, size, background, cfg, key=None,
) -> np.ndarray:
    """Whole-frame render over a (possibly multi-host) mesh.

    Multi-host form of parallel.render_tiles_sharded: every process
    generates only its shard of the jittered (pixel x sample) ray grid,
    the traced framebuffer is psum-replicated, and each host reads the
    finished linear image locally (call on every process; use the result
    on process 0)."""
    from ..camera import Camera

    width, height = size
    cam = Camera(camera, (width, height), dtype=cfg.dtype)
    spp = cfg.resolved_samples()
    P_ = width * height
    R0 = P_ * spp
    n_dev = mesh.devices.size
    R = R0 + ((-R0) % n_dev)
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    axis = mesh.axis_names[0]

    def make_shard(lo, hi):
        ids = np.arange(lo, hi)
        pixn = (ids // spp).astype(np.int32)
        live = (ids < R0).astype(np.float64)
        px = (pixn % width).astype(np.float64)
        py = (pixn // width).astype(np.float64)
        # Deterministic shard-keyed jitter: reproducible given
        # (seed, spp, mesh size); shards draw independent counter-based
        # streams so no host ever materializes the full ray grid.
        jit_key = jax.random.fold_in(key, 0)
        sub = jax.random.uniform(
            jax.random.fold_in(jit_key, lo), (hi - lo, 2), jnp.float32)
        sub = np.asarray(sub, np.float64)
        o, d = cam.rays_at(
            jnp.asarray(px + sub[:, 0], cfg.dtype),
            jnp.asarray(py + sub[:, 1], cfg.dtype),
        )
        return (np.asarray(o), np.asarray(d), pixn,
                live.astype(np.asarray(o).dtype))

    o, d, pix, w0 = make_global_rays(
        mesh, make_shard, R, feature_dims=(3, 3, 0, 0))

    ys, xs = np.mgrid[0:height, 0:width]
    uv_pix = jnp.asarray(
        np.stack([xs.reshape(-1) / width, ys.reshape(-1) / height], axis=-1),
        cfg.dtype,
    )
    bg = background(uv_pix).astype(cfg.dtype)

    acc = jax.jit(
        lambda key, o, d, pix, bg, w0: trace_sharded(
            mesh, key, o, d, pix, bg, P_, st, cfg, w0=w0
        )
    )(jax.random.fold_in(key, 1), o, d, pix, bg, w0)
    img = fetch_replicated(acc).astype(np.float64)
    return img.reshape(height, width, 3) / spp
