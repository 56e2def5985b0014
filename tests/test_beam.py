"""Beam-sweep accelerator equivalence tests — the reference's
mesh_equivalence oracle pattern (kdmesh.rs:99-166): the accelerated path
must produce identical hits to the brute-force sweep.  Every scene here is
built without reference assets (registered asset-free scenes, or the
seeded procedural mesh of chip_smoke.py)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import scenes
from chip_smoke import MESH_CAMERA, MESH_SIZE, mesh_scene
from portrayer_tpu import (
    flatten_scene, RenderConfig, SceneNode, Geometry, Material,
    Sphere, Cube, Cylinder, Cone, Plane,
)
from portrayer_tpu.camera import Camera
from portrayer_tpu.ops.intersect import intersect_scene, occluded
from portrayer_tpu.ops.beam import intersect_scene_beam

FLAT = RenderConfig(accel="flat", node_chunk=256, tri_chunk=512)
BEAM = RenderConfig(accel="beam", warp_size=64, n_segments=8, beam_chunk=64)
# The fast sweep through intersect_scene's dispatch, on any scene size.
FAST = dataclasses.replace(BEAM, beam_min_prims=1)


def _mixed_scene():
    """The seeded procedural mesh among analytic primitives and a floor."""
    scene = mesh_scene(seed=0)
    grey = Material(diffuse=(0.6, 0.6, 0.6), specular=(0.2, 0.2, 0.2),
                    shininess=10.0)
    scene.root.with_children(
        [SceneNode(Geometry(prim(), grey)).scaled(0.8)
         .translated((3.0 * k - 4.5, 1.8, -1.0))
         for k, prim in enumerate((Sphere, Cube, Cylinder, Cone))]
        + [SceneNode(Geometry(Plane(), grey)).scaled(30.0)
           .translated((0.0, -1.5, 0.0))])
    return scene


def _case(name):
    """(tables, camera, size) of a registered scene or "mesh"/"mixed" —
    the seeded procedural mesh, alone or among analytic primitives."""
    if name in ("mesh", "mixed"):
        scene = mesh_scene(seed=0) if name == "mesh" else _mixed_scene()
        return flatten_scene(scene, dtype=jnp.float32), MESH_CAMERA, MESH_SIZE
    spec = scenes.load(name)
    return (flatten_scene(spec.scene, dtype=jnp.float32), spec.camera,
            spec.size)


def _rays(name, n_rays=512, seed=0, shadow_like=False):
    st, camera, (w, h) = _case(name)
    cam = Camera(camera, (w, h), dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    xs = jax.random.uniform(jax.random.fold_in(key, 0), (n_rays,)) * w
    ys = jax.random.uniform(jax.random.fold_in(key, 1), (n_rays,)) * h
    o, d = cam.rays_at(xs, ys)
    if shadow_like:
        # scatter origins into the scene, random directions (incoherent)
        hit = intersect_scene(o, d, 1e-5, jnp.inf, st, FLAT)
        t = jnp.where(hit.hit, hit.t, 1.0)
        o = o + t[:, None] * d * 0.7
        d = jax.random.normal(jax.random.fold_in(key, 2), (n_rays, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return st, o, d


def _assert_equivalent(brute, beam):
    np.testing.assert_array_equal(np.asarray(brute.hit), np.asarray(beam.hit))
    m = np.asarray(brute.hit)
    bt, et = np.asarray(brute.t)[m], np.asarray(beam.t)[m]
    # float reassociation differs between the two sweeps: t must agree to
    # ~1e-4 relative; winning node must agree except on near-ties.
    np.testing.assert_allclose(bt, et, rtol=1e-4, atol=1e-5)
    node_mismatch = np.asarray(brute.node)[m] != np.asarray(beam.node)[m]
    tie = np.abs(bt - et) <= 1e-4 * np.maximum(np.abs(bt), 1.0)
    assert np.all(~node_mismatch | tie)


def _compare(name, **kw):
    st, o, d = _rays(name, **kw)
    brute = intersect_scene(o, d, 1e-5, jnp.inf, st, FLAT)
    beam = intersect_scene_beam(o, d, 1e-5, jnp.inf, st, BEAM)
    _assert_equivalent(brute, beam)
    return brute


def test_beam_equivalence_big_scene_primary():
    _compare("big-scene")


def test_beam_equivalence_big_scene_scattered():
    _compare("big-scene", shadow_like=True)


def test_beam_equivalence_mesh_scene():
    brute = _compare("mesh")
    assert int(brute.hit.sum()) > 50  # the mesh fills part of the view
    assert (np.asarray(brute.tri)[np.asarray(brute.hit)] >= 0).all()


def test_beam_equivalence_mixed_scene():
    _compare("mixed")
    _compare("mixed", shadow_like=True)


@pytest.mark.parametrize("name", ["simple", "four-shapes", "torus-showcase",
                                  "mesh"])
def test_fast_sweep_matches_flat(name):
    """intersect_scene's dispatch to the fast sweep agrees with the flat
    reference (primary and scattered rays)."""
    for shadow_like in (False, True):
        st, o, d = _rays(name, n_rays=256, shadow_like=shadow_like)
        _assert_equivalent(intersect_scene(o, d, 1e-5, jnp.inf, st, FLAT),
                           intersect_scene(o, d, 1e-5, jnp.inf, st, FAST))


@pytest.mark.parametrize("name", ["big-scene", "mixed"])
def test_occluded_matches_flat(name):
    st, o, d = _rays(name, n_rays=256, shadow_like=True)
    flat = occluded(o, d, 1e-5, jnp.inf, st, FLAT)
    fast = occluded(o, d, 1e-5, jnp.inf, st, FAST)
    assert 0 < int(flat.sum()) < flat.shape[0]
    np.testing.assert_array_equal(np.asarray(flat), np.asarray(fast))


def test_beam_respects_active_and_tmax():
    st, o, d = _rays("simple", n_rays=256)
    active = jnp.asarray(np.arange(256) % 2 == 0)
    hit = intersect_scene(o, d, 1e-5, jnp.inf, st, FAST, active=active)
    assert not np.asarray(hit.hit)[1::2].any()
    assert np.asarray(hit.hit)[0::2].any()
    flat = intersect_scene(o, d, 1e-5, jnp.inf, st, FLAT)
    # t_max below every hit -> no hits.
    tmax = jnp.where(flat.hit, flat.t * 0.5, 1e-3)
    hit2 = intersect_scene(o, d, 1e-5, tmax, st, FAST)
    assert not np.asarray(hit2.hit).any()


def test_beam_render_matches_flat_render():
    from portrayer_tpu import render_linear

    scene = _mixed_scene()
    flat_cfg = dataclasses.replace(FLAT, samples=2, tile=(32, 32))
    beam_cfg = dataclasses.replace(FAST, samples=2, tile=(32, 32))
    a = render_linear(scene, MESH_CAMERA, (64, 36), cfg=flat_cfg)
    b = render_linear(scene, MESH_CAMERA, (64, 36), cfg=beam_cfg)
    assert a.max() > 0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
