"""Vectorized scene intersection — the data-parallel replacement for the
reference's recursive `RayCast`/`RayHit` dispatch (src/ray.rs:39-99).

Design (SURVEY §7): rays are SoA batches [R,3]; the scene is flat tables
grouped by primitive kind.  For each kind we sweep node chunks with a
`lax.scan`, computing candidate hit parameters for all (ray, node) pairs and
folding a running nearest hit.  Mesh triangles are swept as (instance,
triangle) pairs.  Hit *details* (normal, uv, tangent basis) are recomputed
for the single winning node per ray afterwards — cheap, and avoids
materializing per-pair detail.

All candidate functions implement the reference's exact selection semantics:
  * half-open t-range:  t_min <= t < t_max  (Range::contains)
  * quadratic prims take the *smallest root in range* then apply cap checks
    with no second-root fallback (e.g. cylinder body, cylinder.rs:50-61)
  * cube = fold over 6 faces with strictly-smaller replacement
    (cube.rs:70-82); cylinder = body/top/bottom (cylinder.rs:119-154);
    cone = body/bottom (cone.rs:28-187)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import math3d as m3
from ..config import RenderConfig
from ..scene.flatten import (
    SceneTables, SPHERE, PLANE, CUBE, CYLINDER, CONE, MESH, TORUS,
    node_record, tri_record, REC_PARAMS,
)

INF = jnp.inf


class Hit(NamedTuple):
    t: jnp.ndarray       # [R] hit parameter (inf when no hit)
    node: jnp.ndarray    # [R] int32 node id (-1 when no hit)
    tri: jnp.ndarray     # [R] int32 triangle id (-1 for analytic prims)
    hit: jnp.ndarray     # [R] bool


class HitDetail(NamedTuple):
    point: jnp.ndarray    # [R,3] world hit point
    normal: jnp.ndarray   # [R,3] world normal (NOT normalized, ray.rs:19-22)
    uv: jnp.ndarray       # [R,2]
    has_uv: jnp.ndarray   # [R] bool
    nmt: jnp.ndarray      # [R,3,3] normal-map transform (primitive-local —
                          # the reference never transforms it, scene.rs:96-98)
    has_nmt: jnp.ndarray  # [R] bool
    material: jnp.ndarray # [R] int32
    rec: jnp.ndarray      # [R,32] the hit node's fused shading record
                          # (flatten.py node_rec layout) — carries the
                          # material properties so shading needs no gathers
    margin: jnp.ndarray   # [R] differentiable silhouette margin in local
                          # units (>0 inside, ->0 at the silhouette, +inf
                          # where soft visibility is unsupported/off) —
                          # drives cfg.soft_visibility edge gradients


def _guarded_div(n, d, fill=INF):
    ok = d != 0.0
    return jnp.where(ok, n / jnp.where(ok, d, 1.0), fill)


def _finite(t):
    """Clamp inf/nan hit parameters to 0 before they enter point arithmetic
    (p = o + t*d).  The validity tests already reject out-of-range t, so the
    forward result is unchanged — but without this, reverse mode computes
    g_d = g_p * t = 0 * inf = NaN on miss lanes, and one NaN poisons the
    whole parameter gradient through the gather-backward scatter-add."""
    return jnp.where(jnp.isfinite(t), t, 0.0)


def _in_range(t, t_min, t_max):
    return (t >= t_min) & (t < t_max)


# ---------------------------------------------------------------------------
# Candidate-t functions.  o, d: [..., 3] local rays; t_min/t_max broadcastable
# [...].  Return t [...] with inf where invalid.
# ---------------------------------------------------------------------------

def sphere_candidate(o, d, t_min, t_max, eps, params=None):
    a = m3.dot(d, d)
    b = 2.0 * m3.dot(o, d)
    c = m3.dot(o, o) - 1.0
    t, ok = m3.smallest_root_in_range(a, b, c, t_min, t_max)
    return jnp.where(ok, t, INF)


def plane_candidate(o, d, t_min, t_max, eps, params=None):
    t = _guarded_div(-o[..., 1], d[..., 1])
    tc = _finite(t)
    p_x = o[..., 0] + tc * d[..., 0]
    p_z = o[..., 2] + tc * d[..., 2]
    r = 0.5 + eps
    ok = (
        _in_range(t, t_min, t_max)
        & (jnp.abs(p_x) <= r)
        & (jnp.abs(p_z) <= r)
    )
    return jnp.where(ok, t, INF)


# Cube faces: (point_axis, point_sign, normal) encoded per face, in the FACES
# table order of cube.rs:46-65 (right, left, top, bottom, near, far).
_CUBE_FACES = (
    (0, +0.5), (0, -0.5), (1, +0.5), (1, -0.5), (2, +0.5), (2, -0.5),
)


def _cube_face_fold(o, d, t_min, t_max, eps):
    """Returns (best_t, best_face) folding faces with strictly-smaller wins.

    The containment test skips the face's own axis: the solved point lies on
    that plane *by construction* (|p_axis| == 0.5 in exact arithmetic, so the
    reference's all-axes contains() always passes there, cube.rs:70-82).
    Checking it in f32 would spuriously reject hits on thin-scaled cubes:
    p_axis = o_axis + t*d_axis cancels two large values whose rounding error
    exceeds EPSILON once the local frame is magnified ~100x (e.g. the road
    slab in primitives.rs, scaled (2, 0.01, 4))."""
    r = 0.5 + eps
    best_t = jnp.full(o.shape[:-1], INF, o.dtype)
    best_face = jnp.full(o.shape[:-1], -1, jnp.int32)
    for fi, (axis, sign) in enumerate(_CUBE_FACES):
        # InfinitePlane through (sign on axis) with normal along axis*sign:
        # t = -(o - p).n / d.n  with n = sign * e_axis
        denom = d[..., axis] * jnp.sign(sign)
        numer = -(o[..., axis] - sign) * jnp.sign(sign)
        t = _guarded_div(numer, denom)
        p = o + _finite(t)[..., None] * d
        contains = jnp.ones(o.shape[:-1], bool)
        for ax in range(3):
            if ax != axis:
                contains = contains & (jnp.abs(p[..., ax]) <= r)
        ok = _in_range(t, t_min, t_max) & contains & (t < best_t)
        best_face = jnp.where(ok, fi, best_face)
        best_t = jnp.where(ok, t, best_t)
    return best_t, best_face


def cube_candidate(o, d, t_min, t_max, eps, params=None):
    t, _ = _cube_face_fold(o, d, t_min, t_max, eps)
    return t


def _cyl_parts(o, d, t_min, t_max):
    """Cylinder candidates (body, top cap, bottom cap); r=0.5, h=1."""
    R2 = 0.25
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    c = o[..., 0] ** 2 + o[..., 2] ** 2 - R2
    t_body, ok = m3.smallest_root_in_range(a, b, c, t_min, t_max)
    y = o[..., 1] + _finite(t_body) * d[..., 1]
    ok = ok & ~(y > 0.5) & ~(y < -0.5)
    t_body = jnp.where(ok, t_body, INF)

    def cap(h):
        t = _guarded_div(h - o[..., 1], d[..., 1])
        tc = _finite(t)
        px = o[..., 0] + tc * d[..., 0]
        pz = o[..., 2] + tc * d[..., 2]
        okc = _in_range(t, t_min, t_max) & ~(px * px + pz * pz > R2)
        return jnp.where(okc, t, INF)

    return t_body, cap(0.5), cap(-0.5)


def cylinder_candidate(o, d, t_min, t_max, eps, params=None):
    t_body, t_top, t_bot = _cyl_parts(o, d, t_min, t_max)
    # fold with strictly-smaller wins (cylinder.rs:119-154)
    t = t_body
    t = jnp.where(t_top < t, t_top, t)
    t = jnp.where(t_bot < t, t_bot, t)
    return t


def _cone_parts(o, d, t_min, t_max):
    """Cone candidates (body, bottom cap); r=0.5, h=1, apex at y=+0.5."""
    H = 1.0
    h2 = H * H
    r2 = 0.25
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = 4.0 * dy * dy * r2 - 4.0 * h2 * (dx * dx + dz * dz)
    b = -8.0 * h2 * (dx * ox + dz * oz) - 4.0 * r2 * (dy * H - 2.0 * dy * oy)
    c = -4.0 * h2 * (ox * ox + oz * oz) + r2 * (h2 - 4.0 * H * oy + 4.0 * oy * oy)
    t_body, ok = m3.smallest_root_in_range(a, b, c, t_min, t_max)
    y = oy + _finite(t_body) * dy
    ok = ok & ~(y > 0.5) & ~(y < -0.5)
    t_body = jnp.where(ok, t_body, INF)

    t_cap = _guarded_div(-0.5 - oy, dy)
    tcc = _finite(t_cap)
    px = ox + tcc * dx
    pz = oz + tcc * dz
    okc = _in_range(t_cap, t_min, t_max) & ~(px * px + pz * pz > r2)
    t_cap = jnp.where(okc, t_cap, INF)
    return t_body, t_cap


def cone_candidate(o, d, t_min, t_max, eps, params=None):
    t_body, t_cap = _cone_parts(o, d, t_min, t_max)
    t = t_body
    t = jnp.where(t_cap < t, t_cap, t)
    return t


def torus_coeffs(o, d, c_r, a_r):
    """Quartic coefficients for the torus (primitive/torus.rs:56-110):
    hole along y, center radius c_r, tube radius a_r."""
    dd = m3.dot(d, d)
    pp = m3.dot(o, o)
    dp = m3.dot(d, o)
    a2 = a_r * a_r
    c2 = c_r * c_r
    k = pp - (a2 + c2)
    A = dd * dd
    B = 4.0 * dd * dp
    C = 2.0 * dd * k + 4.0 * dp * dp + 4.0 * c2 * d[..., 1] * d[..., 1]
    D = 4.0 * k * dp + 8.0 * c2 * o[..., 1] * d[..., 1]
    E = k * k - 4.0 * c2 * (a2 - o[..., 1] * o[..., 1])
    return A, B, C, D, E


def torus_candidate(o, d, t_min, t_max, eps, params=None):
    c_r = params[..., 0]
    a_r = params[..., 1]
    A, B, C, D, E = torus_coeffs(o, d, c_r, a_r)
    t_min = jnp.broadcast_to(t_min, A.shape)
    t_max = jnp.broadcast_to(t_max, A.shape)
    t, ok = m3.quartic_smallest_root_in_range(A, B, C, D, E, t_min, t_max)
    t = jnp.where(ok, t, INF)

    # Differentiable reattach by implicit differentiation: reverse mode
    # through the Ferrari/trig solve NaNs (sqrt/acos at branch boundaries,
    # 0 * inf on miss lanes).  Instead detach the converged root and take
    # ONE Newton step with differentiable coefficients — the value is
    # unchanged (t0 already satisfies F(t0) ~ 0) and the derivative is the
    # implicit-function derivative dt/dtheta = -F_theta / F_t.
    t0 = jax.lax.stop_gradient(t)
    t0c = jnp.where(jnp.isfinite(t0), t0, 0.0)
    f = (((A * t0c + B) * t0c + C) * t0c + D) * t0c + E
    fp = ((4.0 * A * t0c + 3.0 * B) * t0c + 2.0 * C) * t0c + D
    t_imp = t0c - f / jnp.where(fp == 0.0, 1.0, fp)
    return jnp.where(jnp.isfinite(t0), t_imp, INF)


_ANALYTIC_CANDIDATES = {
    SPHERE: sphere_candidate,
    PLANE: plane_candidate,
    CUBE: cube_candidate,
    CYLINDER: cylinder_candidate,
    CONE: cone_candidate,
    TORUS: torus_candidate,
}


def triangle_candidate(o, d, a, b, c, t_min, t_max):
    """Shirley/Cramer triangle intersection (triangle.rs:39-80).

    o, d: [R,1,3] (or broadcastable); a, b, c: [C,3].  Returns t [R,C].
    Also returns (beta, gamma) for reuse by the detail pass.
    """
    e1 = a - b  # [C,3] — "abc" columns in Shirley's notation
    e2 = a - c
    A, B, C_ = e1[..., 0], e1[..., 1], e1[..., 2]
    D, E, F = e2[..., 0], e2[..., 1], e2[..., 2]
    G, H, I = d[..., 0], d[..., 1], d[..., 2]
    rhs = a - o  # [R,C,3]
    J, K, L = rhs[..., 0], rhs[..., 1], rhs[..., 2]

    ei_hf = E * I - H * F
    gf_di = G * F - D * I
    dh_eg = D * H - E * G
    M = A * ei_hf + B * gf_di + C_ * dh_eg

    ak_jb = A * K - J * B
    jc_al = J * C_ - A * L
    bl_ck = B * L - C_ * K

    t = _guarded_div(-(F * ak_jb + E * jc_al + D * bl_ck), M)
    gamma = _guarded_div(I * ak_jb + H * jc_al + G * bl_ck, M, 2.0)
    beta = _guarded_div(J * ei_hf + K * gf_di + L * dh_eg, M, 2.0)

    ok = (
        _in_range(t, t_min, t_max)
        & ~(gamma < 0.0) & ~(gamma > 1.0)
        & ~(beta < 0.0) & ~(beta > 1.0 - gamma)
    )
    return jnp.where(ok, t, INF), beta, gamma


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def _pad_reshape(x, chunk, fill=0):
    """Pad axis 0 to a multiple of `chunk` and reshape to [n_chunks, chunk, ...]."""
    n = x.shape[0]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, pad_width, constant_values=fill)
    return x.reshape((n_chunks, chunk) + x.shape[1:])


def _local_rays(inv34, o, d):
    """Transform rays [R,3] into the local frames of nodes [C,3,4] -> [R,C,3].

    Written as broadcasted mul+add (full f32) rather than einsum: an f32
    dot may run at reduced precision on the accelerator's matrix units
    (TF32 on the GPU), which shows up as shadow acne (see math3d).
    """
    rot = inv34[None, :, :, :3]                       # [1,C,3,3]
    lo = jnp.sum(rot * o[:, None, None, :], axis=-1) + inv34[None, :, :, 3]
    ld = jnp.sum(rot * d[:, None, None, :], axis=-1)
    return lo, ld


def intersect_scene(
    o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
    active=None, src_node=None, src_tri=None,
) -> Hit:
    """Nearest hit for a batch of world-space rays [R,3].

    t_min/t_max: [R] or scalar.  `active`: optional [R] bool — inactive rays
    report no hit (their lanes still compute).

    src_node/src_tri: optional [R] int32 — the surface each ray spawned from.
    When testing that same surface the t-range start is raised to
    ``self_eps_local / |d_local|`` (an epsilon in the node's local units),
    which suppresses float32 self-intersection acne on heavily scaled
    primitives without disturbing any other geometry.
    """
    # The beam sweep (the analogue of the reference's kdtree feature flag)
    # uses dynamic-trip while_loops, so its inputs are stop_gradient-ed: it
    # acts as a pure *selection* oracle (which node/tri is nearest).
    # Differentiability is restored downstream by hit_detail's reattached-t
    # recompute, so both sweeps support reverse-mode AD.
    if cfg.accel == "beam" and st.n_nodes + st.n_pairs >= cfg.beam_min_prims:
        from .beam import intersect_scene_beam

        return intersect_scene_beam(
            *jax.lax.stop_gradient((o, d, t_min, t_max, st)), cfg,
            active=active, src_node=src_node, src_tri=src_tri,
        )

    R = o.shape[0]
    dtype = o.dtype
    t_min = jnp.broadcast_to(jnp.asarray(t_min, dtype), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, dtype), (R,))

    best_t = jnp.full((R,), INF, dtype)
    best_node = jnp.full((R,), -1, jnp.int32)
    best_tri = jnp.full((R,), -1, jnp.int32)

    eps = cfg.epsilon
    use_src = src_node is not None and cfg.self_eps_local > 0.0

    def eff_t_min(ids, ld, is_src):
        """Per-(ray, node) t-range start [R,C]."""
        base = t_min[:, None]
        if not use_src:
            return base
        d_norm = m3.norm(ld, eps=1e-20)
        t_self = cfg.self_eps_local / jnp.maximum(d_norm, 1e-30)
        return jnp.where(is_src, jnp.maximum(base, t_self), base)

    # --- analytic groups ---
    for kind, start, count in st.groups:
        if kind == MESH or count == 0:
            continue
        cand_fn = _ANALYTIC_CANDIDATES[kind]
        idx = jnp.arange(start, start + count, dtype=jnp.int32)
        inv = st.inv[start:start + count]
        prm = st.prim_params[start:start + count]
        chunk = min(cfg.node_chunk, count)
        idx_c = _pad_reshape(idx, chunk, fill=-1)
        inv_c = _pad_reshape(inv, chunk)
        prm_c = _pad_reshape(prm, chunk)

        def body(carry, xs, cand_fn=cand_fn):
            bt, bn = carry
            ids, invs, prms = xs
            lo, ld = _local_rays(invs, o, d)
            is_src = (ids[None, :] == src_node[:, None]) if use_src else False
            t = cand_fn(lo, ld, eff_t_min(ids, ld, is_src), t_max[:, None], eps,
                        params=prms[None])
            t = jnp.where(ids[None, :] >= 0, t, INF)
            j = jnp.argmin(t, axis=1)
            tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
            better = tj < bt
            bn = jnp.where(better, ids[j], bn)
            bt = jnp.where(better, tj, bt)
            return (bt, bn), None

        (best_t, best_node), _ = jax.lax.scan(
            body, (best_t, best_node), (idx_c, inv_c, prm_c)
        )

    # --- mesh triangle pairs ---
    mesh_start, mesh_count = st.group(MESH)
    if mesh_count > 0 and st.n_pairs > 0:
        chunk = min(cfg.tri_chunk, st.n_pairs)
        pn_c = _pad_reshape(st.pair_node, chunk, fill=-1)
        pt_c = _pad_reshape(st.pair_tri, chunk, fill=0)

        def mesh_body(carry, xs):
            bt, bn, btri = carry
            p_node, p_tri = xs
            node_ix = jnp.maximum(p_node, 0)
            invs = st.inv[node_ix]                      # [C,3,4]
            a = st.tri_a[p_tri]                         # [C,3]
            b = st.tri_b[p_tri]
            c = st.tri_c[p_tri]
            lo, ld = _local_rays(invs, o, d)
            is_src = (
                (p_node[None, :] == src_node[:, None])
                & (p_tri[None, :] == src_tri[:, None])
            ) if use_src else False
            t, _, _ = triangle_candidate(
                lo, ld, a[None], b[None], c[None],
                eff_t_min(p_node, ld, is_src), t_max[:, None],
            )
            t = jnp.where(p_node[None, :] >= 0, t, INF)
            j = jnp.argmin(t, axis=1)
            tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
            better = tj < bt
            bn = jnp.where(better, p_node[j], bn)
            btri = jnp.where(better, p_tri[j], btri)
            bt = jnp.where(better, tj, bt)
            return (bt, bn, btri), None

        (best_t, best_node, best_tri), _ = jax.lax.scan(
            mesh_body, (best_t, best_node, best_tri), (pn_c, pt_c)
        )

    hit = jnp.isfinite(best_t)
    if active is not None:
        hit = hit & active
    return Hit(t=best_t, node=jnp.where(hit, best_node, -1),
               tri=jnp.where(hit, best_tri, -1), hit=hit)


def occluded(
    o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
    active=None, src_node=None, src_tri=None,
):
    """Any-hit query for shadow rays.  The reference casts the full nearest-hit
    query with an unbounded range (material.rs:174-179) — occlusion therefore
    counts objects even *beyond* the light, which we preserve."""
    return intersect_scene(
        o, d, t_min, t_max, st, cfg,
        active=active, src_node=src_node, src_tri=src_tri,
    ).hit


# ---------------------------------------------------------------------------
# Hit detail — recompute normal/uv/tangent for the winning node per ray.
# ---------------------------------------------------------------------------

def _sphere_detail(p, eps, dtype):
    """p: [R,3] local hit point on the unit sphere."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    u = (jnp.pi + jnp.arctan2(-z, x)) / (2.0 * jnp.pi)
    v = jnp.arccos(jnp.clip(y, -1.0, 1.0)) / jnp.pi
    uv = jnp.stack([u, v], axis=-1)
    normal = p
    # tangent basis (sphere.rs:72-96): to_top = normalize((0,1,0) - p)
    to_top = m3.normalize(jnp.stack([-x, 1.0 - y, -z], axis=-1), eps=1e-30)
    degenerate = (jnp.abs(to_top[..., 0]) < eps) & (jnp.abs(to_top[..., 2]) < eps)
    h_tan = m3.cross(to_top, normal)
    v_tan = m3.cross(normal, h_tan)
    # Special case: ±y pole -> right/normal/(back|forward). vek: back_rh=+z, forward_rh=-z
    pole_col2 = jnp.where(
        (y > 0.0)[..., None],
        jnp.array([0.0, 0.0, 1.0], dtype),
        jnp.array([0.0, 0.0, -1.0], dtype),
    )
    right = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype), p.shape)
    col0 = jnp.where(degenerate[..., None], right, h_tan)
    col2 = jnp.where(degenerate[..., None], pole_col2, v_tan)
    nmt = jnp.stack([col0, normal, col2], axis=-1)  # columns
    return normal, uv, jnp.ones(p.shape[:-1], bool), nmt, jnp.ones(p.shape[:-1], bool)


# Cube face UV data from cube.rs FACES: (axis, sign, uv_axis(u,v), uv_offset(u,v))
_CUBE_FACE_UV = (
    (0, +0.5, (-1.0, 1.0), (1.0 / 2.0, 1.0 / 3.0)),   # right
    (0, -0.5, (1.0, 1.0), (0.0, 1.0 / 3.0)),          # left
    (1, +0.5, (1.0, -1.0), (1.0 / 4.0, 0.0)),         # top
    (1, -0.5, (1.0, 1.0), (1.0 / 4.0, 2.0 / 3.0)),    # bottom
    (2, +0.5, (1.0, 1.0), (1.0 / 4.0, 1.0 / 3.0)),    # near
    (2, -0.5, (-1.0, 1.0), (3.0 / 4.0, 1.0 / 3.0)),   # far
)


def _cube_detail(o, d, t_min, t_max, p, eps, dtype):
    _, face = _cube_face_fold(o, d, t_min, t_max, eps)
    face = jnp.maximum(face, 0)
    R = p.shape[0]
    # Branchless 6-way select over static per-face constants instead of a
    # per-ray table gather.
    n = jnp.zeros((R, 3), dtype)
    u = jnp.zeros((R,), dtype)
    v = jnp.zeros((R,), dtype)
    for fi, (axis, sign, uvax, uvoff) in enumerate(_CUBE_FACE_UV):
        mask = face == fi
        nvec = [0.0, 0.0, 0.0]
        nvec[axis] = 1.0 if sign > 0 else -1.0
        n = jnp.where(mask[:, None], jnp.array(nvec, dtype), n)
        # face_uv: normal.x!=0 -> (z,y); normal.y!=0 -> (x,z); else (x,y)
        s0, s1 = (2, 1) if axis == 0 else ((0, 2) if axis == 1 else (0, 1))
        norm_u = p[..., s0] * uvax[0] + 0.5
        norm_v = 0.5 - p[..., s1] * uvax[1]
        u = jnp.where(mask, norm_u / 4.0 + uvoff[0], u)
        v = jnp.where(mask, norm_v / 3.0 + uvoff[1], v)
    uv = jnp.stack([u, v], axis=-1)
    # tangent basis (cube.rs:111-136): to_top = normalize((0,1,0)*L - p)
    to_top = m3.normalize(
        jnp.stack([-p[..., 0], 1.0 - p[..., 1], -p[..., 2]], axis=-1), eps=1e-30
    )
    degenerate = (jnp.abs(to_top[..., 0]) < eps) & (jnp.abs(to_top[..., 2]) < eps)
    h_tan = m3.cross(to_top, n)
    v_tan = m3.cross(n, h_tan)
    pole_col2 = jnp.where(
        (n[..., 1] > 0.0)[..., None],
        jnp.array([0.0, 0.0, 1.0], dtype),
        jnp.array([0.0, 0.0, -1.0], dtype),
    )
    right = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype), p.shape)
    col0 = jnp.where(degenerate[..., None], right, h_tan)
    col2 = jnp.where(degenerate[..., None], pole_col2, v_tan)
    nmt = jnp.stack([col0, n, col2], axis=-1)
    ones = jnp.ones((R,), bool)
    return n, uv, ones, nmt, ones


def _plane_detail(p, dtype):
    R = p.shape[0]
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], dtype), p.shape)
    uv = jnp.stack([p[..., 0] + 0.5, p[..., 2] + 0.5], axis=-1)
    nmt = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (R, 3, 3))
    ones = jnp.ones((R,), bool)
    return n, uv, ones, nmt, ones


def _cylinder_detail(o, d, t_min, t_max, p, dtype):
    t_body, t_top, t_bot = _cyl_parts(o, d, t_min, t_max)
    t = t_body
    part = jnp.zeros(t.shape, jnp.int32)
    part = jnp.where(t_top < t, 1, part)
    t = jnp.minimum(t, t_top)
    part = jnp.where(t_bot < t, 2, part)
    n_body = jnp.stack([p[..., 0], jnp.zeros_like(p[..., 1]), p[..., 2]], axis=-1)
    up = jnp.array([0.0, 1.0, 0.0], dtype)
    down = jnp.array([0.0, -1.0, 0.0], dtype)
    n = jnp.where((part == 0)[..., None], n_body,
                  jnp.where((part == 1)[..., None], up, down))
    R = p.shape[0]
    zeros = jnp.zeros((R,), bool)
    return n, jnp.zeros((R, 2), dtype), zeros, jnp.broadcast_to(jnp.eye(3, dtype=dtype), (R, 3, 3)), zeros


def _cone_detail(o, d, t_min, t_max, p, dtype):
    t_body, t_cap = _cone_parts(o, d, t_min, t_max)
    is_cap = t_cap < t_body
    # body normal (cone.rs:78-104)
    tip = jnp.array([0.0, 0.5, 0.0], dtype)
    tangent1 = tip - p
    across = jnp.stack([-2.0 * p[..., 0], jnp.zeros_like(p[..., 1]), -2.0 * p[..., 2]], axis=-1)
    tangent2 = m3.cross(tangent1, across)
    n_body = m3.cross(tangent1, tangent2)
    down = jnp.array([0.0, -1.0, 0.0], dtype)
    n = jnp.where(is_cap[..., None], down, n_body)
    R = p.shape[0]
    zeros = jnp.zeros((R,), bool)
    return n, jnp.zeros((R, 2), dtype), zeros, jnp.broadcast_to(jnp.eye(3, dtype=dtype), (R, 3, 3)), zeros


def _torus_detail(p, params, dtype):
    """Torus normal: hit point minus nearest tube-center point — the
    construction sketched (but left unimplemented) at torus.rs:112-125.
    No uv / normal-map transform (torus.rs:126-130: tex_coord None)."""
    c_r = params[..., 0]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rxz = jnp.sqrt(x * x + z * z)
    scale = c_r / jnp.maximum(rxz, 1e-30)
    tube_center = jnp.stack([x * scale, jnp.zeros_like(y), z * scale], axis=-1)
    n = p - tube_center
    R = p.shape[0]
    zeros = jnp.zeros((R,), bool)
    return (n, jnp.zeros((R, 2), dtype), zeros,
            jnp.broadcast_to(jnp.eye(3, dtype=dtype), (R, 3, 3)), zeros)


def _mesh_detail(lo, ld, trec, t_min, t_max, dtype):
    """Detail for mesh hits: recompute barycentrics on the winning triangle.

    All per-triangle data comes from ONE fused row gather (trec)."""
    a = trec[:, 0:3]
    b = trec[:, 3:6]
    c = trec[:, 6:9]
    _, beta, gamma = triangle_candidate(
        lo[:, None, :], ld[:, None, :], a[:, None, :], b[:, None, :], c[:, None, :],
        t_min[:, None], t_max[:, None],
    )
    beta = beta[:, 0]
    gamma = gamma[:, 0]
    alpha = 1.0 - beta - gamma

    smooth = trec[:, 24] > 0.5
    na, nb, nc = trec[:, 9:12], trec[:, 12:15], trec[:, 15:18]
    n_smooth = na * alpha[:, None] + nb * beta[:, None] + nc * gamma[:, None]
    n_flat = m3.cross(b - a, c - a)
    n = jnp.where(smooth[:, None], n_smooth, n_flat)

    has_uv = trec[:, 25] > 0.5
    uva, uvb, uvc = trec[:, 18:20], trec[:, 20:22], trec[:, 22:24]
    uv_i = uva * alpha[:, None] + uvb * beta[:, None] + uvc * gamma[:, None]
    # v-flip (triangle.rs:98)
    uv = jnp.stack([uv_i[..., 0], 1.0 - uv_i[..., 1]], axis=-1)

    # TBN (triangle.rs:103-138)
    edge1 = b - a
    edge2 = c - a
    duv1 = uvb - uva
    duv2 = uvc - uva
    tangent = duv2[..., 1:2] * edge1 - duv1[..., 1:2] * edge2
    bitangent = -duv2[..., 0:1] * edge1 + duv1[..., 0:1] * edge2
    coeff = duv1[..., 0] * duv2[..., 1] - duv2[..., 0] * duv1[..., 1]
    coeff_ok = coeff != 0.0
    coeff_safe = jnp.where(coeff_ok, coeff, 1.0)[..., None]
    tangent = m3.normalize(tangent / coeff_safe, eps=1e-30)
    bitangent = m3.normalize(bitangent / coeff_safe, eps=1e-30)
    n_unit = m3.normalize(n, eps=1e-30)
    nmt = jnp.stack([tangent, n_unit, bitangent], axis=-1)
    return n, uv, has_uv, nmt, has_uv


def _winner_candidate_t(lo, ld, ray_kind, rec, trec, t_min, t_max, eps,
                        present):
    """Per-ray candidate t of each ray's (already selected) winning
    primitive, recomputed in local space from the scene tables [R]-sized
    (hit_detail's differentiable reattach and winner_t)."""
    t_re = jnp.full(lo.shape[:-1], INF, lo.dtype)
    for kind in sorted(present):
        if kind == MESH:
            tk, _, _ = triangle_candidate(
                lo[:, None, :], ld[:, None, :],
                trec[:, None, 0:3], trec[:, None, 3:6], trec[:, None, 6:9],
                t_min[:, None], t_max[:, None],
            )
            tk = tk[:, 0]
        else:
            tk = _ANALYTIC_CANDIDATES[kind](
                lo, ld, t_min, t_max, eps, params=rec[:, REC_PARAMS]
            )
        t_re = jnp.where(ray_kind == kind, tk, t_re)
    return t_re


def winner_t(o, d, node, tri, st: SceneTables, cfg: RenderConfig,
             t_min, t_max=INF, src_node=None, src_tri=None):
    """Exact candidate t for per-ray winners (node, tri) — the selection's
    value recomputed from the tables; INF when the winner's root is lost to
    float asymmetry (callers keep a fallback)."""
    R = o.shape[0]
    dtype = o.dtype
    nix = jnp.maximum(node, 0)
    rec = node_record(st)[nix]
    inv = rec[:, 0:12].reshape(R, 3, 4)
    lo = m3.transform_point(inv, o)
    ld = m3.transform_dir(inv, d)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, dtype), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, dtype), (R,))
    if src_node is not None and cfg.self_eps_local > 0.0:
        is_src = node == src_node
        if src_tri is not None:
            is_src = is_src & (tri == src_tri)
        dn = m3.norm(ld, eps=1e-20)
        t_self = cfg.self_eps_local / jnp.maximum(dn, 1e-30)
        t_min = jnp.where(is_src, jnp.maximum(t_min, t_self), t_min)
    ray_kind = rec[:, 31].astype(jnp.int32)
    present = {k for (k, _, _) in st.groups}
    trec = None
    if MESH in present:
        trec = tri_record(st)[jnp.maximum(tri, 0)]
    return _winner_candidate_t(
        lo, ld, ray_kind, rec, trec, t_min, t_max, cfg.epsilon, present
    )


def _silhouette_margin(kind, lo, ld, p_local, trec, dtype, params=None):
    """Differentiable distance-to-silhouette proxy in local units.

    Positive inside the primitive's visible region, -> 0 at the silhouette.
    sphere: tangency; plane/cube: face-edge distance; mesh: barycentric
    edge distance.  cylinder/cone/torus: curved bodies use the grazing
    margin (n-hat . d-hat)^2 — a point is on a smooth silhouette exactly
    when the surface normal is perpendicular to the ray — combined (min)
    with rim-distance margins for caps/part edges, so cfg.soft_visibility
    yields usable edge gradients for every primitive kind (round-2
    verdict, Missing #5)."""
    R = lo.shape[0]

    def grazing(n):
        """(n-hat . d-hat)^2: smooth, in [0,1], -> 0 at the silhouette."""
        nd = m3.dot(n, ld)
        n2 = jnp.maximum(m3.dot(n, n), 1e-30)
        d2 = jnp.maximum(m3.dot(ld, ld), 1e-30)
        return nd * nd / (n2 * d2)

    if kind == SPHERE:
        # 1 - (distance of the ray line from the center)^2: 0 at tangency.
        cr = m3.cross(lo, ld)
        ld2 = jnp.maximum(m3.dot(ld, ld), 1e-30)
        return 1.0 - m3.dot(cr, cr) / ld2
    if kind == PLANE:
        return jnp.minimum(
            0.5 - jnp.abs(p_local[..., 0]), 0.5 - jnp.abs(p_local[..., 2])
        )
    if kind == CUBE:
        # Distance of the hit point to the winning face's edges: the face
        # axis carries |p| == 0.5 (the max); the margin is 0.5 minus the
        # second-largest coordinate magnitude.
        ap = jnp.abs(p_local)
        top = jnp.max(ap, axis=-1)
        second = jnp.sum(ap, axis=-1) - top - jnp.min(ap, axis=-1)
        return 0.5 - second
    if kind == CYLINDER:
        x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
        r2 = x * x + z * z
        R2 = 0.25
        is_cap = jnp.abs(y) > 0.5 - 1e-4
        m_cap = (R2 - r2) / R2                  # 0 at the cap rim
        n_body = jnp.stack([x, jnp.zeros_like(y), z], axis=-1)
        m_body = jnp.minimum(grazing(n_body), 2.0 * (0.5 - jnp.abs(y)))
        return jnp.where(is_cap, m_cap, m_body)
    if kind == CONE:
        x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
        r2 = x * x + z * z
        R2 = 0.25
        is_cap = y < -0.5 + 1e-4
        m_cap = (R2 - r2) / R2
        tip = jnp.array([0.0, 0.5, 0.0], dtype)
        tangent1 = tip - p_local
        across = jnp.stack(
            [-2.0 * x, jnp.zeros_like(y), -2.0 * z], axis=-1)
        n_body = m3.cross(tangent1, m3.cross(tangent1, across))
        m_body = jnp.minimum(grazing(n_body), 2.0 * (y + 0.5))
        return jnp.where(is_cap, m_cap, m_body)
    if kind == TORUS and params is not None:
        c_r = params[..., 0]
        x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
        rxz = jnp.sqrt(jnp.maximum(x * x + z * z, 1e-30))
        scale = c_r / rxz
        tube_center = jnp.stack(
            [x * scale, jnp.zeros_like(y), z * scale], axis=-1)
        return grazing(p_local - tube_center)
    if kind == MESH and trec is not None:
        a = trec[:, 0:3]
        b = trec[:, 3:6]
        c = trec[:, 6:9]
        _, beta, gamma = triangle_candidate(
            lo[:, None, :], ld[:, None, :],
            a[:, None, :], b[:, None, :], c[:, None, :],
            jnp.full((R, 1), -INF, dtype), jnp.full((R, 1), INF, dtype),
        )
        beta = beta[:, 0]
        gamma = gamma[:, 0]
        return jnp.minimum(jnp.minimum(beta, gamma), 1.0 - beta - gamma)
    return jnp.full((R,), INF, dtype)


def hit_detail(
    o, d, hit: Hit, st: SceneTables, cfg: RenderConfig, t_min,
    src_node=None, src_tri=None, reattach: bool = True,
) -> HitDetail:
    """Compute world hit point / normal / uv / tangent info for winners.

    With ``reattach`` (default), the winning primitive's hit parameter is
    recomputed differentiably from the scene tables and becomes the value
    used downstream: the sweep only *selects* (node, tri) and its t acts
    as a detached fallback when float asymmetry loses the recomputed root.
    This detached-selection / reattached-value construction makes the
    accelerated beam sweep differentiable at O(R) extra cost and spares
    reverse mode from transposing the brute-force [R x N] sweep in the
    flat path.
    """
    R = o.shape[0]
    dtype = o.dtype
    node = jnp.maximum(hit.node, 0)
    t = jnp.where(hit.hit, hit.t, 1.0)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, dtype), (R,))
    t_max = jnp.full((R,), INF, dtype)

    # Named residual: under the trace loop's checkpoint policy the winner
    # record gathers are SAVED (cheap [R,~32] rows) so the backward replay
    # reads them instead of re-gathering (see trace._REMAT_POLICY).
    from jax.ad_checkpoint import checkpoint_name

    rec = checkpoint_name(node_record(st)[node], "shade_tmp")
    # [R,34] — the ONLY per-node gather
    inv = rec[:, 0:12].reshape(R, 3, 4)
    # Normal matrix = transposed rotation of world->local (scene.rs:204:
    # invtrans.transposed() applied to w=0 vectors).
    nmat = jnp.swapaxes(inv[:, :, :3], 1, 2)
    lo = m3.transform_point(inv, o)
    ld = m3.transform_dir(inv, d)

    # Effective per-ray t-range start, mirroring the sweep's self-
    # intersection raise (so recomputes select the same root).
    if src_node is not None and cfg.self_eps_local > 0.0:
        is_src = hit.node == src_node
        if src_tri is not None:
            is_src = is_src & (hit.tri == src_tri)
        dn = m3.norm(ld, eps=1e-20)
        t_self = cfg.self_eps_local / jnp.maximum(dn, 1e-30)
        t_min = jnp.where(is_src, jnp.maximum(t_min, t_self), t_min)

    ray_kind = rec[:, 31].astype(jnp.int32)
    present = {k for (k, _, _) in st.groups}
    eps = cfg.epsilon
    trec = None
    if MESH in present:
        trec = checkpoint_name(
            tri_record(st)[jnp.maximum(hit.tri, 0)], "shade_tmp"
        )  # [R,26] one gather

    if reattach:
        t_re = _winner_candidate_t(
            lo, ld, ray_kind, rec, trec, t_min, t_max, eps, present
        )
        # The recompute is the value; the sweep's (possibly quantized) t is
        # the detached fallback when float asymmetry loses the root.
        t = jnp.where(
            hit.hit & jnp.isfinite(t_re), t_re, jax.lax.stop_gradient(t)
        )

    p_local = lo + t[:, None] * ld
    point = o + t[:, None] * d

    normal = jnp.zeros((R, 3), dtype)
    uv = jnp.zeros((R, 2), dtype)
    has_uv = jnp.zeros((R,), bool)
    nmt = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (R, 3, 3))
    has_nmt = jnp.zeros((R,), bool)
    margin = jnp.full((R,), INF, dtype)
    want_margin = cfg.soft_visibility > 0.0

    for kind in sorted(present):
        if kind == SPHERE:
            parts = _sphere_detail(p_local, eps, dtype)
        elif kind == PLANE:
            parts = _plane_detail(p_local, dtype)
        elif kind == CUBE:
            parts = _cube_detail(lo, ld, t_min, t_max, p_local, eps, dtype)
        elif kind == CYLINDER:
            parts = _cylinder_detail(lo, ld, t_min, t_max, p_local, dtype)
        elif kind == CONE:
            parts = _cone_detail(lo, ld, t_min, t_max, p_local, dtype)
        elif kind == MESH:
            parts = _mesh_detail(lo, ld, trec, t_min, t_max, dtype)
        elif kind == TORUS:
            parts = _torus_detail(p_local, rec[:, REC_PARAMS], dtype)
        mask = ray_kind == kind
        n_k, uv_k, huv_k, nmt_k, hnmt_k = parts
        normal = jnp.where(mask[:, None], n_k, normal)
        uv = jnp.where(mask[:, None], uv_k, uv)
        has_uv = jnp.where(mask, huv_k, has_uv)
        nmt = jnp.where(mask[:, None, None], nmt_k, nmt)
        has_nmt = jnp.where(mask, hnmt_k, has_nmt)
        if want_margin:
            m_k = _silhouette_margin(kind, lo, ld, p_local, trec, dtype,
                                     params=rec[:, REC_PARAMS])
            margin = jnp.where(mask, m_k, margin)

    # Local normal -> world (normal matrix = inv-transpose 3x3).
    normal_w = m3.matvec3(nmat, normal)
    material = rec[:, 24].astype(jnp.int32)
    return HitDetail(
        point=point, normal=normal_w, uv=uv, has_uv=has_uv,
        nmt=nmt, has_nmt=has_nmt,
        material=jnp.where(hit.hit, material, 0),
        rec=rec, margin=margin,
    )
