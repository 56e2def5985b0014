"""Wavefront bounce loop — the reference's depth-10 recursion
(Ray::color -> Material::hit_color -> Ray::color, src/ray.rs:139-148)
converted to iterative per-bounce queues (SURVEY §7 design inversion).

Round r intersects & shades every live ray, accumulates the local radiance
into a per-pixel framebuffer (segment scatter-add), and emits reflect/refract
children into the next round's queue.  Queues have static capacity
(`queue_factor` x primary rays); when a round would overflow, the
lowest-throughput children are terminated with a background-colour fallback
(exact for the reference's depth cut-off, which *also* returns the background
at depth > 10, material.rs:102-104).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from ..config import RenderConfig
from ..scene.flatten import SceneTables
from .intersect import intersect_scene, hit_detail, Hit
from .shade import shade_pre

# Each bounce round runs under jax.checkpoint saving ONLY the sweep
# oracles (nearest-hit ids + occlusion verdicts) and the named winner-record
# gathers ("shade_tmp"): the backward pass then replays shading and
# accumulation from (queue, hit) WITHOUT re-dispatching any sweep, and none
# of the other shading intermediates (det.nmt [R,3,3], per-light [L,R,3]
# contribs, ...) survive as residuals.  The policy was chosen on an earlier
# accelerator whose padded [R,3] layout made those residuals the memory
# limit; on the GPU it is not measured yet (PERF.md).
_REMAT_POLICY = jax.checkpoint_policies.save_only_these_names(
    "sweep_oracle", "shade_tmp")


def _oracle(x):
    """Mark a sweep output as a saved residual (see _REMAT_POLICY)."""
    return jax.tree.map(
        lambda a: checkpoint_name(a, "sweep_oracle"), x)


class _Queue(NamedTuple):
    o: jnp.ndarray        # [Q,3]
    d: jnp.ndarray        # [Q,3]
    w: jnp.ndarray        # [Q] throughput
    pix: jnp.ndarray      # [Q] int32 pixel index
    t_min: jnp.ndarray    # [Q] per-ray t-range start
    src_node: jnp.ndarray # [Q] int32 node the ray spawned from (-1 primary)
    src_tri: jnp.ndarray  # [Q] int32 triangle the ray spawned from
    sid: jnp.ndarray      # [Q] int32 sample id for counter-based RNG
    #                       (primary: lane index; children: 2*sid+{0,1}
    #                       — draws keyed per (round, site, sid) so
    #                       pixels are independent of queue capacity,
    #                       slicing and compaction order)


def _acc_add(acc, pix, x, spp_c: int):
    """acc[pix] += x.  When the queue is pixel-major with spp_c samples per
    pixel (primary rays), a reshape+sum replaces the scatter-add."""
    if spp_c:
        return acc + x.reshape(acc.shape[0], spp_c, x.shape[-1]).sum(axis=1)
    return acc.at[pix].add(x)


class TraceStats(NamedTuple):
    """Per-trace introspection (trace(..., with_stats=True)).

    live: [max_depth+1] int32 live-ray count entering each bounce round.
    dropped_w: scalar — total live throughput terminated by queue-capacity
    overflow across all rounds, as a FRACTION of the primary ray count.
    Stale scene queue_caps hints fail loudly through this counter: the
    castle overflow test (tests/test_render.py) and
    tools/gen_self_goldens.py assert it stays ~0 (full-frame, via
    debug.queue_overflow_fraction)."""
    live: jnp.ndarray
    dropped_w: jnp.ndarray


class _Shadow(NamedTuple):
    """Deferred per-round shadow batch (deferred lighting): shading is
    split into an occlusion-independent part and per-light contributions
    that wait for one batched any-hit launch over every light's rays
    (_apply_shadows) — L lights cost one sweep, not L."""
    o: jnp.ndarray         # [R,3] hit points
    dirs: jnp.ndarray      # [L,R,3]
    need: jnp.ndarray      # [L,R] lanes whose light contribution != 0
    lc: jnp.ndarray        # [L,R,3] throughput-weighted light contribs
    t_eps: jnp.ndarray     # [R]
    src_node: jnp.ndarray  # [R]
    src_tri: jnp.ndarray   # [R]
    pix: jnp.ndarray       # [R]


def _round_shade(
    q: _Queue, hit, acc, bg, st: SceneTables, cfg: RenderConfig, rkey,
    is_last, spp_c: int = 0,
):
    """Shade a round whose nearest hits are already computed.

    Accumulates the occlusion-independent radiance (ambient/texture base,
    miss background, soft-visibility complement, depth-cutoff background,
    material.rs:102-104) and returns (acc, children queue of size 2Q,
    deferred _Shadow batch)."""
    active = q.w > 0.0
    det = hit_detail(
        q.o, q.d, hit, st, cfg, q.t_min,
        src_node=q.src_node, src_tri=q.src_tri,
    )

    if spp_c:  # pixel-major primary queue: broadcast instead of gather
        Q = q.o.shape[0]
        bgc = jnp.broadcast_to(
            bg[:, None, :], (acc.shape[0], spp_c, 3)
        ).reshape(Q, 3)
    else:
        bgc = bg[q.pix]                               # [Q,3]
    miss_w = jnp.where(active & ~hit.hit, q.w, 0.0)

    shade_active = active & hit.hit
    pre, children = shade_pre(q.d, hit, det, st, cfg, rkey, shade_active,
                              sid=q.sid)
    t_eps = pre.t_eps

    w_hit = q.w
    soft_w = 0.0
    if cfg.soft_visibility > 0.0:
        # Soft silhouettes: scale this hit's energy by the differentiable
        # coverage alpha and route the complement to the background, making
        # visibility (nearly) continuous in scene parameters.  The -3 shift
        # puts the transition band *inside* the silhouette so the residual
        # jump at the true edge is sigmoid(-3) ~ 5%.
        alpha = jax.nn.sigmoid(det.margin / cfg.soft_visibility - 3.0)
        alpha = jnp.where(
            active & hit.hit & jnp.isfinite(det.margin), alpha, 1.0
        )
        w_hit = q.w * alpha
        soft_w = q.w - w_hit

    w_refl = w_hit * children.refl_mult
    w_refr = w_hit * children.refr_mult

    # One combined accumulation per round (one scatter instead of four):
    # background for misses + soft-silhouette complement + the ambient
    # base + the depth-limit cut-off where every child evaluates to the
    # background; per-light terms wait for the fused shadow verdicts.
    last = jnp.asarray(is_last)
    bg_w = miss_w + soft_w + jnp.where(last, w_refl + w_refr, 0.0)
    base = jnp.where(shade_active[..., None], pre.base, 0.0)
    acc = _acc_add(
        acc, q.pix, bg_w[:, None] * bgc + w_hit[:, None] * base, spp_c
    )
    w_refl = jnp.where(last, 0.0, w_refl)
    w_refr = jnp.where(last, 0.0, w_refr)

    lc = jnp.where(
        shade_active[None, :, None], w_hit[None, :, None] * pre.light_contrib,
        0.0,
    )
    shadow = _Shadow(
        o=det.point, dirs=pre.shadow_dir, need=pre.shadow_need, lc=lc,
        t_eps=t_eps, src_node=hit.node, src_tri=hit.tri, pix=q.pix,
    )

    child = _Queue(
        o=jnp.concatenate([children.origin, children.origin]),
        d=jnp.concatenate([children.refl_dir, children.refr_dir]),
        w=jnp.concatenate([w_refl, w_refr]),
        pix=jnp.concatenate([q.pix, q.pix]),
        t_min=jnp.concatenate([t_eps, t_eps]),
        src_node=jnp.concatenate([hit.node, hit.node]),
        src_tri=jnp.concatenate([hit.tri, hit.tri]),
        sid=jnp.concatenate([2 * q.sid, 2 * q.sid + 1]),
    )
    return acc, child, shadow


def _nearest(q: _Queue, st, cfg):
    """Nearest-hit launch for a queue (hit_detail's reattach recomputes
    the exact differentiable t)."""
    return _oracle(intersect_scene(
        q.o, q.d, q.t_min, jnp.inf, st, cfg, active=q.w > 0.0,
        src_node=q.src_node, src_tri=q.src_tri,
    ))


def _apply_shadows(shadow: _Shadow, acc, st, cfg, spp_c: int):
    """Resolve the deferred L-light occlusion batch (one any-hit launch)
    and accumulate the lit contributions.

    (A fused variant — shadow lanes riding in the next round's nearest
    launch with a per-lane shadow-mode flag — was slower on the castle on
    an earlier accelerator; it is not measured on the GPU.)"""
    from .intersect import occluded

    L = shadow.dirs.shape[0]
    R = shadow.o.shape[0]
    if L == 0:
        return acc
    tile = lambda x: jnp.tile(x, (L,) + (1,) * (x.ndim - 1))
    occ = _oracle(occluded(
        tile(shadow.o) if L > 1 else shadow.o,
        shadow.dirs.reshape(L * R, 3) if L > 1 else shadow.dirs[0],
        tile(shadow.t_eps) if L > 1 else shadow.t_eps,
        jnp.inf, st, cfg,
        active=shadow.need.reshape(L * R) if L > 1 else shadow.need[0],
        src_node=tile(shadow.src_node) if L > 1 else shadow.src_node,
        src_tri=tile(shadow.src_tri) if L > 1 else shadow.src_tri,
    ).reshape(L, R))
    light = jnp.sum(jnp.where(occ[..., None], 0.0, shadow.lc), axis=0)
    return _acc_add(acc, shadow.pix, light, spp_c)


def _compact(child: _Queue, capacity: int, acc, bg):
    """Fit a child queue into `capacity` slots.  If it already fits, pad.
    Otherwise keep the highest-throughput children and terminate the rest
    with a background-colour fallback (adds their would-be contribution as
    bg so energy isn't silently dropped).

    Returns (queue, acc, dropped_w): dropped_w is the total live
    throughput terminated by overflow this round — the loud-failure
    counter for stale per-scene queue_caps hints (a capacity measured on
    one camera can silently tint renders after a scene edit; callers
    assert the summed fraction stays tiny).

    Selection is ORDER-PRESERVING: survivors keep their queue order
    (children are emitted pixel-major), so the next round's ray blocks
    stay spatially coherent.  top_k's weight-sorted gather would scramble
    them and defeat the sweep's per-block culling."""
    n = child.w.shape[0]
    dropped = jnp.asarray(0.0, child.w.dtype)
    if n <= capacity:
        # Everything fits: keep live lanes only, compacted to the front
        # (dead sibling lanes are equivalent to padding, and leaving them
        # interleaved would stop any block of the next round from being
        # all-dead skippable).
        take = child.w > 0.0
    else:
        # Threshold = capacity-th largest weight; fill ties first-come so
        # at most `capacity` lanes are taken.  Dead lanes are never kept.
        # Live survivors compact CONTIGUOUSLY to the front in queue
        # order: coherent blocks at the head, skippable all-dead blocks
        # at the tail.
        kth = jax.lax.top_k(child.w, capacity)[0][-1]
        take_gt = child.w > kth
        quota = capacity - jnp.sum(take_gt.astype(jnp.int32))
        eq = child.w == kth
        eq_rank = jnp.cumsum(eq.astype(jnp.int32))
        take = (take_gt | (eq & (eq_rank <= quota))) & (child.w > 0.0)
        dropped_w = jnp.where(take, 0.0, child.w)
        acc = acc.at[child.pix].add(dropped_w[:, None] * bg[child.pix])
        dropped = jnp.sum(dropped_w)
    # Stable compaction: scatter row i to slot (#takes before i); dropped
    # rows land in a trash slot past the end.
    pos = jnp.cumsum(take.astype(jnp.int32)) - 1
    tgt = jnp.where(take, pos, capacity)
    place = lambda x, fill: (
        jnp.full((capacity + 1,) + x.shape[1:], fill, x.dtype)
        .at[tgt].set(x, mode="drop")[:capacity]
    )
    return _Queue(
        o=place(child.o, 0.0), d=place(child.d, 1.0),
        w=place(child.w, 0.0), pix=place(child.pix, 0),
        t_min=place(child.t_min, 1.0),
        src_node=place(child.src_node, -1),
        src_tri=place(child.src_tri, -1),
        sid=place(child.sid, 0),
    ), acc, dropped


def trace(
    key, o0, d0, pix0, bg, n_pixels: int, st: SceneTables, cfg: RenderConfig,
    w0=None, spp_contiguous: int = 0, with_stats: bool = False,
):
    """Trace primary rays through the scene.

    o0, d0: [R,3] primary rays; pix0: [R] pixel index; bg: [P,3] per-pixel
    background colour; w0: optional [R] initial throughput (0 = dead lane).
    spp_contiguous > 0 asserts pix0 == repeat(arange(P), spp) so the primary
    round can use reshape-sums instead of scatter-adds.
    Returns acc [P,3]: the sum of per-sample radiances scattered to their
    pixels (caller divides by spp).  with_stats=True returns (acc,
    TraceStats) — per-bounce live-ray counts plus the queue-overflow
    dropped-throughput fraction — the wavefront analogue of the
    reference's progress introspection (SURVEY §5).
    """
    R0 = o0.shape[0]
    dtype = o0.dtype
    acc = jnp.zeros((n_pixels, 3), dtype)

    q = _Queue(
        o=o0, d=d0,
        w=jnp.ones((R0,), dtype) if w0 is None else w0,
        pix=pix0,
        t_min=jnp.full((R0,), cfg.epsilon, dtype),
        src_node=jnp.full((R0,), -1, jnp.int32),
        src_tri=jnp.full((R0,), -1, jnp.int32),
        sid=jnp.arange(R0, dtype=jnp.int32),
    )

    # Scenes with no reflective material never spawn children — statically
    # collapse to a single round (big compile/runtime saving).
    max_depth = cfg.max_depth if st.any_reflective else 0

    # Per-round queue capacity schedule.  Whitted recursion branches 2x
    # per bounce but live-ray counts decay fast on typical scenes (castle:
    # 6.5% live after round 1, <2% after round 2), so flat full-capacity
    # queues waste nearly all sweep/prologue work on dead lanes.
    # cfg.queue_caps gives per-round capacity multiples of the primary ray
    # count (scene specs carry measured hints); the auto default keeps the
    # reference-exact policy (refractive scenes saturate 4x queues —
    # measured on transmission-refraction — everything else fits in 1x).
    caps = cfg.queue_caps
    if not caps:  # None or an (invalid) empty tuple both mean "auto"
        if cfg.queue_factor is not None:
            caps = (cfg.queue_factor,)
        else:
            caps = (4.0,) if st.any_refractive else (1.0,)
    caps = tuple(caps) + (caps[-1],) * max(0, max_depth - len(caps))
    cap_of = lambda r: max(int(round(R0 * caps[min(r, len(caps)) - 1])), 8)

    # Round 0 (primary rays), remat'd with sweep oracles saved (see
    # _REMAT_POLICY): backward replays shading from (queue, hit ids)
    # without re-dispatching sweeps or keeping shading temps as
    # residuals.
    n_live0 = jnp.sum(q.w > 0.0).astype(jnp.int32)
    rkey0 = jax.random.fold_in(key, 0)

    if max_depth == 0:
        @partial(jax.checkpoint, policy=_REMAT_POLICY, prevent_cse=False)
        def _round0_only(q, acc):
            hit = _nearest(q, st, cfg)
            acc, child, sh = _round_shade(
                q, hit, acc, bg, st, cfg, rkey0,
                is_last=True, spp_c=spp_contiguous,
            )
            return _apply_shadows(sh, acc, st, cfg, spp_contiguous)

        acc = _round0_only(q, acc)
        if with_stats:
            return acc, TraceStats(
                live=n_live0[None], dropped_w=jnp.asarray(0.0, dtype))
        return acc

    @partial(jax.checkpoint, policy=_REMAT_POLICY, prevent_cse=False)
    def _round0(q, acc):
        hit = _nearest(q, st, cfg)
        acc, child, sh = _round_shade(
            q, hit, acc, bg, st, cfg, rkey0,
            is_last=False, spp_c=spp_contiguous,
        )
        acc = _apply_shadows(sh, acc, st, cfg, spp_contiguous)
        return _compact(child, cap_of(1), acc, bg)

    q, acc, dropped = _round0(q, acc)
    stats = [n_live0[None]]

    def _zero_queue(cap):
        return _Queue(
            o=jnp.zeros((cap, 3), dtype), d=jnp.ones((cap, 3), dtype),
            w=jnp.zeros((cap,), dtype),
            pix=jnp.zeros((cap,), jnp.int32),
            t_min=jnp.ones((cap,), dtype),
            src_node=jnp.full((cap,), -1, jnp.int32),
            src_tri=jnp.full((cap,), -1, jnp.int32),
            sid=jnp.zeros((cap,), jnp.int32),
        )

    def round_r(q, acc, ridx, next_cap):
        """One bounce round: nearest launch, shade, any-hit shadow launch,
        compact children to `next_cap`.

        ADAPTIVE CAPACITY: queue capacities are safe upper bounds (stale
        hints overflow loudly via TraceStats.dropped_w), but the live
        count varies hugely with the view — a center crop keeps <7% of
        castle rays alive after round 1 while the full frame keeps ~50%
        (the water).  Live lanes are compacted to the queue FRONT, so
        when n_live fits in capacity//4 (or //16) the round runs a
        statically smaller variant on just that head slice — sweep,
        shade and compaction costs then track the actual live count, not
        the worst-case capacity.  lax.switch picks the variant at run
        time; every branch emits the same next_cap-shaped queue."""
        C = q.w.shape[0]
        n_live = jnp.sum(q.w > 0.0).astype(jnp.int32)

        def _run(q_s, acc):
            rkey = jax.random.fold_in(key, ridx)
            hit = _nearest(q_s, st, cfg)
            acc2, child, sh = _round_shade(
                q_s, hit, acc, bg, st, cfg, rkey,
                is_last=(ridx == max_depth),
            )
            acc2 = _apply_shadows(sh, acc2, st, cfg, 0)
            return _compact(child, next_cap, acc2, bg)

        # Remat only rounds big enough for their shading residuals to
        # matter (the lane-padded [k,3]/[k,3,3] temps): small sliced
        # rounds save everything — replaying them costs more backward
        # time than their residuals cost memory.
        _run_ckpt = partial(jax.checkpoint, policy=_REMAT_POLICY, prevent_cse=False)(_run)

        def at_size(k):
            run_fn = _run_ckpt if k >= cfg.remat_min_lanes else _run

            def run(args):
                q, acc = args
                q_s = _Queue(*(x[:k] for x in q))
                return run_fn(q_s, acc)
            return run

        def dead(args):
            q, acc = args
            return _zero_queue(next_cap), acc, jnp.asarray(0.0, acc.dtype)

        sizes = []
        # div 1 (full capacity) is always present: it is the correctness
        # fallback when the live count exceeds every smaller slice.
        for div in tuple(cfg.queue_slice_divs) + (1,):
            k = min(C, -(-C // div // 2048) * 2048)
            if k not in sizes:
                sizes.append(k)
        sizes.sort()
        branches = [dead] + [at_size(k) for k in sizes]
        ix = jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_live)
        sel = jnp.where(n_live > 0, 1 + ix, 0)
        q, acc, dropped = jax.lax.switch(sel, branches, (q, acc))
        return q, acc, n_live, dropped

    # Head rounds with changing capacities run as specialized Python
    # rounds (static shapes per round); the uniform-capacity tail shares
    # ONE lax.scan body (compiled once) with dynamic early exit —
    # unless cfg.unroll_tail trades compile time for removing the scan's
    # backward mechanics (per-iteration residual stacking/slicing).
    tail_start = max_depth
    while tail_start > 1 and cap_of(tail_start - 1) == cap_of(max_depth):
        tail_start -= 1
    if cfg.unroll_tail:
        tail_start = max_depth + 1

    for r in range(1, tail_start):
        q, acc, n_live, dr = round_r(q, acc, r, cap_of(r + 1))
        dropped = dropped + dr
        stats.append(n_live[None])

    if tail_start <= max_depth:
        def body(carry, ridx):
            q, acc, dropped = carry
            q, acc, n_live, dr = round_r(q, acc, ridx, cap_of(max_depth))
            return (q, acc, dropped + dr), n_live

        (q, acc, dropped), n_lives = jax.lax.scan(
            body, (q, acc, dropped), jnp.arange(tail_start, max_depth + 1)
        )
        stats.append(n_lives)

    if with_stats:
        return acc, TraceStats(
            live=jnp.concatenate(stats), dropped_w=dropped / R0)
    return acc
