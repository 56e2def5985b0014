"""Torus primitive + quartic solver.

The reference derived the torus quartic (src/primitive/torus.rs:20-110) but
left it unregistered with `normal: unimplemented!()`; here it is a complete,
registered primitive.  Tests pin the quartic against analytic expectations
and the torus against geometry the quartic must reproduce."""

import numpy as np
import pytest
import jax.numpy as jnp

from portrayer_tpu import (
    Scene, SceneNode, Geometry, Torus, Material, Light,
    flatten_scene, RenderConfig, math3d as m3,
)
from portrayer_tpu.ops.intersect import intersect_scene, hit_detail

CFG = RenderConfig(accel="flat", node_chunk=8)
MAT = Material(diffuse=(1, 0, 0))


def torus_scene(cr=1.0, tr=0.25, node=None):
    n = node or SceneNode(Geometry(Torus(cr, tr), MAT))
    return flatten_scene(
        Scene(root=n, lights=[Light()], ambient=(0.3, 0.3, 0.3)),
        dtype=jnp.float32,
    )


def cast(st, o, d, cfg=CFG):
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    hit = intersect_scene(o, d, 1e-5, jnp.inf, st, cfg)
    det = hit_detail(o, d, hit, st, cfg, 1e-5)
    return hit, det


class TestQuartic:
    def test_known_roots(self):
        # (t-1)(t-2)(t-3)(t-4) = t^4 -10t^3 +35t^2 -50t +24
        t, ok = m3.quartic_smallest_root_in_range(
            *map(jnp.float32, (1.0, -10.0, 35.0, -50.0, 24.0)),
            jnp.float32(0.0), jnp.float32(np.inf),
        )
        assert bool(ok) and np.isclose(float(t), 1.0, atol=1e-4)
        # range excludes the first two roots
        t, ok = m3.quartic_smallest_root_in_range(
            *map(jnp.float32, (1.0, -10.0, 35.0, -50.0, 24.0)),
            jnp.float32(2.5), jnp.float32(np.inf),
        )
        assert bool(ok) and np.isclose(float(t), 3.0, atol=1e-4)

    def test_no_real_roots(self):
        # (t^2+1)(t^2+4): no real roots
        t, ok = m3.quartic_smallest_root_in_range(
            *map(jnp.float32, (1.0, 0.0, 5.0, 0.0, 4.0)),
            jnp.float32(0.0), jnp.float32(np.inf),
        )
        assert not bool(ok)

    def test_random_vs_numpy(self):
        rng = np.random.default_rng(1)
        n = 512
        roots = np.sort(rng.uniform(0.1, 8.0, (n, 4)), axis=1)
        co = np.array([np.poly(r) for r in roots], np.float64)
        t, ok = m3.quartic_smallest_root_in_range(
            *(jnp.asarray(co[:, i], jnp.float32) for i in range(5)),
            jnp.zeros(n, jnp.float32), jnp.full(n, np.inf, jnp.float32),
        )
        assert np.asarray(ok).all()
        rel = np.abs(np.asarray(t) - roots[:, 0]) / roots[:, 0]
        # Near-double roots are ill-conditioned in float32 monomial form
        # (condition ~ 1/gap^2) — the bulk must be tight, the tail bounded.
        assert np.quantile(rel, 0.5) < 1e-5
        assert np.quantile(rel, 0.95) < 1e-3


class TestTorus:
    def test_hits_outer_and_inner(self):
        st = torus_scene(1.0, 0.25)
        # At y=0, x=1, the outer surface satisfies x^2+z^2=(c+a)^2 ->
        # z = 0.75, so a -z ray from z=5 hits at t = 4.25.  A -y ray over
        # the tube center hits the tube top (y=+a) at t = 4.75.  A ray
        # through the hole center misses.
        hit, det = cast(
            st,
            [[1.0, 0.0, 5.0], [1.0, 5.0, 0.0], [0.0, 5.0, 0.0]],
            [[0, 0, -1.0], [0, -1.0, 0], [0, -1.0, 0]],
        )
        assert bool(hit.hit[0])
        assert np.isclose(float(hit.t[0]), 4.25, atol=1e-3)
        assert bool(hit.hit[1])
        assert np.isclose(float(hit.t[1]), 4.75, atol=1e-3)
        assert not bool(hit.hit[2])

    def test_normal_outward(self):
        st = torus_scene(1.0, 0.25)
        hit, det = cast(st, [[1.0, 5.0, 0.0]], [[0, -1.0, 0]])
        n = np.asarray(det.normal[0])
        n = n / np.linalg.norm(n)
        # Hit at (1, 0.25, 0): tube center (1,0,0) -> normal +y.
        np.testing.assert_allclose(n, [0, 1, 0], atol=1e-3)

    def test_normal_matches_implicit_gradient(self):
        st = torus_scene(1.0, 0.3)
        rng = np.random.default_rng(0)
        o = np.stack([rng.uniform(-1.2, 1.2, 32), rng.uniform(-0.28, 0.28, 32),
                      np.full(32, 5.0)], axis=1)
        d = np.tile([0, 0, -1.0], (32, 1))
        hit, det = cast(st, o, d)
        mask = np.asarray(hit.hit)
        p = np.asarray(det.point)[mask]
        n = np.asarray(det.normal)[mask]
        # grad f, f = (c - sqrt(x^2+z^2))^2 + y^2 - a^2
        c, a = 1.0, 0.3
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        rxz = np.sqrt(x * x + z * z)
        g = np.stack([
            2 * x * (1 - c / rxz), 2 * y, 2 * z * (1 - c / rxz)
        ], axis=1)
        gn = g / np.linalg.norm(g, axis=1, keepdims=True)
        nn = n / np.linalg.norm(n, axis=1, keepdims=True)
        assert mask.sum() > 8
        np.testing.assert_allclose(nn, gn, atol=2e-3)

    def test_transformed_instance(self):
        node = SceneNode(Geometry(Torus(1.0, 0.25), MAT)) \
            .scaled(2.0).translated((0.0, 3.0, 0.0))
        st = torus_scene(node=node)
        # Tube top above (2, 3, 0) sits at y = 3 + 2*0.25 = 3.5.
        hit, det = cast(st, [[2.0, 8.0, 0.0]], [[0, -1.0, 0]])
        assert bool(hit.hit[0])
        assert np.isclose(float(hit.t[0]), 4.5, atol=1e-2)

    def test_pallas_matches_flat(self):
        """The fast sweep (beam, forced on) agrees with the flat sweep on
        the quartic."""
        st = torus_scene(1.0, 0.3)
        rng = np.random.default_rng(2)
        o = jnp.asarray(np.stack([
            rng.uniform(-2, 2, 256), rng.uniform(-2, 2, 256),
            np.full(256, 4.0)], axis=1), jnp.float32)
        d = jnp.asarray(np.tile([0, 0, -1.0], (256, 1)), jnp.float32)
        flat = intersect_scene(o, d, 1e-5, jnp.inf, st, CFG)
        pal = intersect_scene(
            o, d, 1e-5, jnp.inf, st,
            RenderConfig(accel="beam", beam_min_prims=1, warp_size=64),
        )
        agree = np.mean(np.asarray(flat.hit) == np.asarray(pal.hit))
        assert agree > 0.99  # grazing quartics may flip at silhouettes
        both = np.asarray(flat.hit) & np.asarray(pal.hit)
        np.testing.assert_allclose(
            np.asarray(pal.t)[both], np.asarray(flat.t)[both],
            rtol=1e-3, atol=1e-3,
        )
