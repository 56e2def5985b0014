"""Ordered beam-sweep acceleration — the data-parallel replacement for the
reference's kd-tree (src/kdtree/*, SURVEY §7 step 9), written in plain XLA.

Why not a kd-tree walk: per-ray stack traversal is divergent control flow
and random gathers, which plain XLA array code cannot express per ray
(a per-ray traversal kernel is an open item, ROADMAP).  Instead:

  * Rays are grouped into *warps* (contiguous batches — coherent for
    primary and shadow rays).  Each warp carries interval bounds on its
    origins and directions.
  * For every (warp, primitive) pair, ONE conservative interval slab test
    computes the t-range in which the warp could possibly enter the
    primitive's world AABB.  Impossible pairs are culled (typically >98%
    on big scenes).
  * Each warp's surviving candidates are sorted by their conservative
    entry-t (one argsort per group), then swept front-to-back in fixed
    chunks by a dynamic-trip while_loop.  The loop stops as soon as every
    remaining candidate's entry-t exceeds the warp's current best hit —
    the early termination of ordered kd descent (kdtree/node.rs:132-199),
    captured at warp granularity with fully static shapes.

Equivalence with the brute-force sweep is the correctness oracle (the
reference's mesh_equivalence pattern, kdmesh.rs:99-166) — see
tests/test_beam.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..scene.flatten import SceneTables, MESH
from .intersect import (
    Hit, _ANALYTIC_CANDIDATES, triangle_candidate, INF,
)

BIGT = 3e38


def _pad_to(x, n, fill):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


def _warp_entry_t(omin, omax, dmin, dmax, amin, amax):
    """Conservative entry-t of warp reach into AABBs.

    omin/omax/dmin/dmax: [W,3] warp origin/direction interval bounds.
    amin/amax: [N,3] target AABBs.  Returns t_enter [W,N] — a valid lower
    bound on the t at which ANY warp ray can be inside the AABB — with
    +inf where overlap is impossible for t >= 0.

    Per axis, the warp's reachable interval at parameter t is
    [omin + t*dmin, omax + t*dmax] (t >= 0).  Overlap with [nmin, nmax]
    requires  dmin*t <= nmax - omin  and  dmax*t >= nmin - omax; each is a
    one-sided bound on t depending on the direction-bound's sign.
    """
    t_lo = jnp.zeros((omin.shape[0], amin.shape[0]), omin.dtype)
    t_hi = jnp.full((omin.shape[0], amin.shape[0]), BIGT, omin.dtype)
    for a in range(3):
        A = amax[None, :, a] - omin[:, None, a]       # [W,N]
        B = amin[None, :, a] - omax[:, None, a]
        dn = dmin[:, None, a]
        dx = dmax[:, None, a]
        # cond1: dn * t <= A
        hi1 = jnp.where(dn > 0, A / jnp.where(dn > 0, dn, 1.0), BIGT)
        lo1 = jnp.where(dn < 0, A / jnp.where(dn < 0, dn, 1.0), 0.0)
        empty1 = (dn == 0) & (A < 0)
        # cond2: dx * t >= B
        lo2 = jnp.where(dx > 0, B / jnp.where(dx > 0, dx, 1.0), 0.0)
        hi2 = jnp.where(dx < 0, B / jnp.where(dx < 0, dx, 1.0), BIGT)
        empty2 = (dx == 0) & (B > 0)
        t_lo = jnp.maximum(t_lo, jnp.maximum(lo1, lo2))
        t_hi = jnp.minimum(t_hi, jnp.minimum(hi1, hi2))
        t_hi = jnp.where(empty1 | empty2, -1.0, t_hi)
    possible = t_lo <= t_hi
    # Small conservative slack for f32 rounding.
    t_enter = jnp.maximum(t_lo - 1e-3 * (jnp.abs(t_lo) + 1.0), 0.0)
    return jnp.where(possible, t_enter, INF)


def intersect_scene_beam(
    o, d, t_min, t_max, st: SceneTables, cfg: RenderConfig,
    active=None, src_node=None, src_tri=None,
) -> Hit:
    """Beam-accelerated nearest hit; same contract as intersect_scene.

    Requires normalized ray directions (t == world distance), which the
    renderer guarantees.
    """
    R0 = o.shape[0]
    dtype = o.dtype
    w = cfg.warp_size
    W = -(-R0 // w)
    R = W * w

    t_min = jnp.broadcast_to(jnp.asarray(t_min, dtype), (R0,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, dtype), (R0,))
    if active is None:
        active = jnp.ones((R0,), bool)
    if src_node is None:
        src_node = jnp.full((R0,), -1, jnp.int32)
    if src_tri is None:
        src_tri = jnp.full((R0,), -1, jnp.int32)

    o_w = _pad_to(o, R, 0.0).reshape(W, w, 3)
    d_w = _pad_to(d, R, 1.0).reshape(W, w, 3)
    act_w = _pad_to(active, R, False).reshape(W, w)
    tmin_w = _pad_to(t_min, R, 1.0).reshape(W, w)
    tmax_w = _pad_to(t_max, R, 0.0).reshape(W, w)
    src_w = _pad_to(src_node, R, -1).reshape(W, w)
    srct_w = _pad_to(src_tri, R, -1).reshape(W, w)

    BIG = jnp.asarray(BIGT, dtype)
    omin = jnp.where(act_w[..., None], o_w, BIG).min(axis=1)     # [W,3]
    omax = jnp.where(act_w[..., None], o_w, -BIG).max(axis=1)
    dmin = jnp.where(act_w[..., None], d_w, BIG).min(axis=1)
    dmax = jnp.where(act_w[..., None], d_w, -BIG).max(axis=1)
    # Empty warps (no active lane): force impossible bounds.
    any_active = act_w.any(axis=1)
    omin = jnp.where(any_active[:, None], omin, BIG)
    omax = jnp.where(any_active[:, None], omax, -BIG)
    dmin = jnp.where(any_active[:, None], dmin, 0.0)
    dmax = jnp.where(any_active[:, None], dmax, 0.0)

    C = cfg.beam_chunk
    eps = cfg.epsilon
    use_src = cfg.self_eps_local > 0.0

    best_t = jnp.full((W, w), INF, dtype)
    best_node = jnp.full((W, w), -1, jnp.int32)
    best_tri = jnp.full((W, w), -1, jnp.int32)

    def eff_t_min(ld, is_src):
        base = tmin_w[:, :, None]
        if not use_src:
            return base
        d_norm = jnp.sqrt(jnp.sum(ld * ld, axis=-1))
        t_self = cfg.self_eps_local / jnp.maximum(d_norm, 1e-30)
        return jnp.where(is_src, jnp.maximum(base, t_self), base)

    def warp_ub(bt):
        lane_ub = jnp.minimum(bt, tmax_w)
        lane_ub = jnp.where(act_w, lane_ub, 0.0)
        return lane_ub.max(axis=1)                               # [W]

    def ordered_sweep(carry, t_enter, pick_tables, is_pairs):
        """Sweep candidates sorted by entry-t, chunked, with early exit.

        t_enter: [W, N] conservative entry-t (inf = culled).
        pick_tables(sorted_ids_chunk) -> candidate tensors for the chunk.
        """
        bt, bn, btr = carry
        Wn = t_enter.shape[1]
        n_pad = max(C, -(-Wn // C) * C)
        order = jnp.argsort(t_enter, axis=1)                     # [W,N]
        te_sorted = jnp.take_along_axis(t_enter, order, axis=1)
        order = jnp.pad(order, ((0, 0), (0, n_pad - Wn)))
        te_sorted = jnp.pad(
            te_sorted, ((0, 0), (0, n_pad - Wn)), constant_values=INF
        )

        n_chunks = n_pad // C

        def cond(state):
            ci, bt, bn, btr = state
            start_t = jax.lax.dynamic_slice(te_sorted, (0, ci * C), (W, 1))[:, 0]
            # isfinite: exhausted warps (start_t = inf) must stop even when
            # warp_ub is inf (all-miss warps) — inf <= inf is True.
            live = jnp.isfinite(start_t) & (start_t <= warp_ub(bt))
            return (ci < n_chunks) & jnp.any(live)

        def body(state):
            ci, bt, bn, btr = state
            ids = jax.lax.dynamic_slice(order, (0, ci * C), (W, C))   # [W,C]
            te = jax.lax.dynamic_slice(te_sorted, (0, ci * C), (W, C))
            valid = jnp.isfinite(te)
            t, node_ids, tri_ids = pick_tables(ids, valid)
            j = jnp.argmin(t, axis=2)                                 # [W,w]
            tj = jnp.take_along_axis(t, j[..., None], axis=2)[..., 0]
            better = tj < bt
            pick = lambda arr: jnp.take_along_axis(
                jnp.broadcast_to(arr[:, None, :], (W, w, C)), j[..., None], 2
            )[..., 0]
            bn = jnp.where(better, pick(node_ids), bn)
            if is_pairs:
                btr = jnp.where(better, pick(tri_ids), btr)
            bt = jnp.where(better, tj, bt)
            return ci + 1, bt, bn, btr

        _, bt, bn, btr = jax.lax.while_loop(
            cond, body, (jnp.int32(0), bt, bn, btr)
        )
        return bt, bn, btr

    carry = (best_t, best_node, best_tri)

    # --- analytic groups ---
    for kind, start, count in st.groups:
        if kind == MESH or count == 0:
            continue
        amin = st.aabb_min[start:start + count]
        amax = st.aabb_max[start:start + count]
        t_enter = _warp_entry_t(omin, omax, dmin, dmax, amin, amax)
        cand_fn = _ANALYTIC_CANDIDATES[kind]

        def pick_tables(ids, valid, start=start, cand_fn=cand_fn):
            gids = ids + start                                       # [W,C]
            inv = st.inv[gids]
            prm = st.prim_params[gids][:, None]                      # [W,1,C,2]
            rot = inv[:, None, :, :, :3]
            lo = jnp.sum(rot * o_w[:, :, None, None, :], -1) + inv[:, None, :, :, 3]
            ld = jnp.sum(rot * d_w[:, :, None, None, :], -1)
            is_src = gids[:, None, :] == src_w[:, :, None]
            t = cand_fn(lo, ld, eff_t_min(ld, is_src), tmax_w[:, :, None], eps,
                        params=prm)
            t = jnp.where(valid[:, None, :] & act_w[:, :, None], t, INF)
            return t, gids, None

        carry = ordered_sweep(carry, t_enter, pick_tables, is_pairs=False)

    # --- mesh triangle pairs ---
    if st.group(MESH)[1] > 0 and st.n_pairs > 0:
        t_enter = _warp_entry_t(
            omin, omax, dmin, dmax, st.pair_aabb_min, st.pair_aabb_max
        )

        def pick_pairs(ids, valid):
            node_ix = st.pair_node[ids]                              # [W,C]
            tri_ix = st.pair_tri[ids]
            inv = st.inv[node_ix]
            rot = inv[:, None, :, :, :3]
            lo = jnp.sum(rot * o_w[:, :, None, None, :], -1) + inv[:, None, :, :, 3]
            ld = jnp.sum(rot * d_w[:, :, None, None, :], -1)
            a = st.tri_a[tri_ix][:, None]
            b = st.tri_b[tri_ix][:, None]
            c = st.tri_c[tri_ix][:, None]
            is_src = (
                (node_ix[:, None, :] == src_w[:, :, None])
                & (tri_ix[:, None, :] == srct_w[:, :, None])
            )
            t, _, _ = triangle_candidate(
                lo, ld, a, b, c, eff_t_min(ld, is_src), tmax_w[:, :, None]
            )
            t = jnp.where(valid[:, None, :] & act_w[:, :, None], t, INF)
            return t, node_ix, tri_ix

        carry = ordered_sweep(carry, t_enter, pick_pairs, is_pairs=True)

    best_t, best_node, best_tri = carry
    bt = best_t.reshape(R)[:R0]
    bn = best_node.reshape(R)[:R0]
    btr = best_tri.reshape(R)[:R0]
    hit = jnp.isfinite(bt) & active
    return Hit(t=bt, node=jnp.where(hit, bn, -1),
               tri=jnp.where(hit, btr, -1), hit=hit)
