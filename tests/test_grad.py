"""Differentiable-rendering tests: gradients through the wavefront loop
match central finite differences (BASELINE.md backward-correctness
criterion), for material, light, and transform-adjacent parameters."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from portrayer_tpu import (
    Scene, SceneNode, Geometry, Sphere, Plane, Material, Light,
    flatten_scene, RenderConfig,
)
from portrayer_tpu.ops.trace import trace

CFG = RenderConfig(node_chunk=8, accel="flat")
KEY = jax.random.PRNGKey(0)


def _scene():
    return Scene(
        root=SceneNode([
            SceneNode(Geometry(Sphere(), Material(
                diffuse=(0.6, 0.3, 0.2), specular=(0.4, 0.4, 0.4),
                shininess=20.0, reflectivity=0.3,
            ))).translated((0.0, 0.0, -3.0)),
            SceneNode(Geometry(Plane(), Material(diffuse=(0.4, 0.5, 0.6))))
                .scaled(20.0).translated((0.0, -1.5, 0.0)),
        ]),
        lights=[Light(position=(2.0, 4.0, 2.0), color=(0.8, 0.8, 0.8))],
        ambient=(0.2, 0.2, 0.2),
    )


def _rays(n=64):
    # a fan of rays covering sphere, plane, and background
    u = jnp.linspace(-0.4, 0.4, n)
    d = jnp.stack([u, -0.15 * jnp.ones_like(u), -jnp.ones_like(u)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.zeros((n, 3))
    return o, d


def _loss_fn(st, field):
    o, d = _rays()
    n = o.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), 0.3, jnp.float32)

    def loss(value):
        st2 = st.replace(**{field: value})
        acc = trace(KEY, o, d, pix, bg, n, st2, CFG)
        return jnp.sum(acc ** 2)

    return jax.jit(loss)


def _check_grad(field, eps=1e-2, rtol=0.08):
    st = flatten_scene(_scene(), dtype=jnp.float32)
    loss = _loss_fn(st, field)
    value = getattr(st, field)
    g = jax.grad(loss)(value)
    g = np.asarray(g)
    assert np.all(np.isfinite(g))

    # central differences on a few of the largest-gradient coordinates.
    # Coordinates with exactly-zero gradient are excluded: parameters sitting
    # on a structural branch boundary (e.g. reflectivity == 0, which gates
    # whether child rays exist at all — material.rs:216) are one-sided
    # non-differentiable, matching the reference's semantics.
    order = np.argsort(-np.abs(g).ravel())
    flat_idx = [fi for fi in order if abs(g.ravel()[fi]) > 1e-6][:6]
    checked = 0
    skipped = []
    for fi in flat_idx:
        idx = np.unravel_index(fi, g.shape)
        basis = jnp.zeros_like(value).at[idx].set(1.0)

        def fd_at(e):
            f_plus = float(loss(value + e * basis))
            f_minus = float(loss(value - e * basis))
            return (f_plus - f_minus) / (2 * e)

        fd = fd_at(eps)
        fd_half = fd_at(eps / 2)
        # Visibility is piecewise smooth: if a ray sits exactly on a
        # structural boundary (shadow edge, primitive silhouette, face tie),
        # the loss has a jump there and the central difference measures
        # jump/(2*eps), not a slope — it then *grows* as eps shrinks instead
        # of converging.  Skip such coordinates (the analytic gradient is the
        # slope of the smooth branch, which no FD straddling a jump can see).
        denom = max(abs(fd), abs(fd_half), 1e-6)
        if abs(fd_half - fd) / denom > 0.25:
            skipped.append((idx, fd, fd_half))
            continue
        an = g[idx]
        assert np.isclose(an, fd, rtol=rtol, atol=5e-3), (
            f"{field}{idx}: analytic {an} vs fd {fd}"
        )
        checked += 1
    if skipped:
        print(f"{field}: skipped FD-unstable coords "
              + ", ".join(f"{i} fd={a:.3g}/fd_half={b:.3g}"
                          for i, a, b in skipped))
    # A majority of the probed coordinates must be FD-stable — silently
    # skipping most of them would gut the regression power of this test.
    need = max(min(2, len(flat_idx) - 1), (len(flat_idx) + 1) // 2)
    assert checked >= need, (
        f"{field}: only {checked}/{len(flat_idx)} FD-stable coordinates "
        f"(skipped: {[i for i, _, _ in skipped]})"
    )


def test_grad_diffuse_matches_fd():
    _check_grad("mat_diffuse")


def test_grad_light_color_matches_fd():
    _check_grad("light_color")


def test_grad_specular_matches_fd():
    _check_grad("mat_specular")


def test_grad_light_pos_matches_fd():
    # light position: gradients through attenuation/shadow geometry
    _check_grad("light_pos", eps=3e-2, rtol=0.15)


def test_grad_reflectivity_matches_fd():
    _check_grad("mat_reflectivity", eps=5e-3, rtol=0.1)


def test_grad_transform_matches_fd():
    # node transforms (st.inv, the flat world->local table): gradients flow
    # through the reattached-t recompute + hit detail (north-star: transform
    # gradients; BASELINE.json).
    _check_grad("inv", eps=2e-3, rtol=0.15)


def _grads(cfg):
    st = flatten_scene(_scene(), dtype=jnp.float32)
    o, d = _rays()
    n = o.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), 0.3, jnp.float32)

    def loss(diffuse, inv):
        st2 = st.replace(mat_diffuse=diffuse, inv=inv)
        return jnp.sum(trace(KEY, o, d, pix, bg, n, st2, cfg) ** 2)

    return jax.grad(loss, argnums=(0, 1))(st.mat_diffuse, st.inv)


def test_grad_accelerated_sweeps_match_flat():
    # The stop_gradient-ed sweeps + reattached-t construction must give the
    # same gradients as differentiating the flat sweep directly (same
    # selection -> same piecewise-smooth branch).
    g_flat = _grads(dataclasses.replace(CFG, accel="flat"))
    g_beam = _grads(dataclasses.replace(CFG, accel="beam", beam_min_prims=1))
    for ga, gb in zip(g_flat, g_beam):
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gb),
                                   rtol=2e-4, atol=1e-5)


def test_silhouette_gradient_with_soft_visibility():
    """VERDICT r1 #6 / SURVEY §7 step 10: translating a sphere across ray
    positions must produce an FD-consistent gradient THROUGH the
    visibility discontinuity.  With cfg.soft_visibility the render is
    (nearly) continuous in the translation, so the analytic gradient of
    the soft renderer matches central differences at the silhouette —
    exactly the coordinates the hard-visibility tests must skip."""
    from portrayer_tpu import math3d as m3

    cfg = dataclasses.replace(CFG, soft_visibility=0.08)
    st = flatten_scene(_scene(), dtype=jnp.float32)
    # Rays aimed at the sphere's right silhouette (sphere at (0,0,-3),
    # radius 1 => edge near x/z ratio ~ 1/sqrt(8)).
    n = 32
    u = jnp.linspace(0.30, 0.38, n)
    d = jnp.stack([u, jnp.zeros_like(u), -jnp.ones_like(u)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.zeros((n, 3))
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), 0.3, jnp.float32)

    inv0 = st.inv

    def loss(dx):
        # Translate the sphere (node 0) by dx along +x: world->local
        # inverse composes with T(-dx).
        shift = jnp.zeros((3, 4), jnp.float32).at[0, 3].set(-dx)
        inv = inv0.at[0].add(shift)
        st2 = st.replace(inv=inv)
        acc = trace(KEY, o, d, pix, bg, n, st2, cfg)
        return jnp.sum(acc ** 2)

    loss = jax.jit(loss)
    g = float(jax.grad(loss)(0.0))
    eps = 2e-3
    fd = (float(loss(eps)) - float(loss(-eps))) / (2 * eps)
    fd_half = (float(loss(eps / 2)) - float(loss(-eps / 2))) / eps
    # FD must be stable (the hard renderer's FD here diverges as eps
    # shrinks) and the analytic gradient must match it.
    assert abs(fd_half - fd) / max(abs(fd), 1e-6) < 0.2, (fd, fd_half)
    assert g != 0.0
    assert np.isclose(g, fd, rtol=0.1), f"analytic {g} vs fd {fd}"


@pytest.mark.parametrize("prim,urange", [
    # Fans start deep enough inside the body that the sigmoid's smooth band
    # (alpha up to ~0.8) dominates the residual 5% hard-edge jump.
    ("cylinder", (0.148, 0.176)),   # body tangency at impact b = 0.5
    ("cone", (0.070, 0.092)),       # slanted-edge silhouette near y=0
    ("torus", (0.136, 0.155)),      # outer-equator silhouette (0.45/3)
])
def test_silhouette_gradient_curved_prims(prim, urange):
    """Round-2 verdict Missing #5: cfg.soft_visibility must give
    FD-consistent silhouette gradients for cylinder/cone/torus too (their
    margins were +inf = hard edges).  Same construction as the sphere
    test: translate the primitive across a fan of rays straddling its
    right silhouette and compare the analytic gradient with central
    differences."""
    from portrayer_tpu import Cylinder, Cone, Torus

    prim_obj = {
        "cylinder": Cylinder, "cone": Cone,
        "torus": lambda: Torus(center_radius=0.3, tube_radius=0.15),
    }[prim]()
    scene = Scene(
        root=SceneNode(Geometry(prim_obj, Material(
            diffuse=(0.7, 0.3, 0.2)))).translated((0.0, 0.0, -3.0)),
        lights=[Light(position=(2.0, 4.0, 2.0), color=(0.8, 0.8, 0.8))],
        ambient=(0.3, 0.3, 0.3),
    )
    cfg = dataclasses.replace(CFG, soft_visibility=0.05)
    st = flatten_scene(scene, dtype=jnp.float32)
    n = 48
    u = jnp.linspace(urange[0], urange[1], n)
    d = jnp.stack([u, jnp.zeros_like(u), -jnp.ones_like(u)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.zeros((n, 3))
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), 0.3, jnp.float32)
    inv0 = st.inv

    def loss(dx):
        shift = jnp.zeros((3, 4), jnp.float32).at[0, 3].set(-dx)
        st2 = st.replace(inv=inv0.at[0].add(shift))
        return jnp.sum(trace(KEY, o, d, pix, bg, n, st2, cfg) ** 2)

    loss = jax.jit(loss)
    g = float(jax.grad(loss)(0.0))
    eps = 2e-3
    fd = (float(loss(eps)) - float(loss(-eps))) / (2 * eps)
    fd_half = (float(loss(eps / 2)) - float(loss(-eps / 2))) / eps
    assert abs(fd_half - fd) / max(abs(fd), 1e-6) < 0.25, (fd, fd_half)
    assert g != 0.0
    assert np.isclose(g, fd, rtol=0.15), f"{prim}: analytic {g} vs fd {fd}"


def test_grad_unroll_tail_matches_scan():
    """The bench's fwd+bwd config (unroll_tail + one slice variant) is a
    pure scheduling change: gradients must match the default scan tail
    to float tolerance (same ops, different loop structure)."""
    st = flatten_scene(_scene(), dtype=jnp.float32)
    o, d = _rays()
    n = o.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), 0.3, jnp.float32)

    def grad_of(cfg):
        def loss(diffuse):
            acc = trace(KEY, o, d, pix, bg, n,
                        st.replace(mat_diffuse=diffuse), cfg)
            return jnp.sum(acc ** 2)
        return np.asarray(jax.jit(jax.grad(loss))(st.mat_diffuse))

    g_scan = grad_of(dataclasses.replace(CFG, queue_caps=(2.0,)))
    g_unroll = grad_of(dataclasses.replace(
        CFG, queue_caps=(2.0,), unroll_tail=True, queue_slice_divs=(16,)))
    assert np.all(np.isfinite(g_scan))
    np.testing.assert_allclose(g_unroll, g_scan, rtol=1e-5, atol=1e-7)
