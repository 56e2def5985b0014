"""Vectorized shading — the reference's Material::hit_color
(src/material.rs:91-320) as a batched kernel plus child-ray emission.

One invocation shades a whole wavefront of hits:
  * ambient + per-light [shadow-occluded Lambert diffuse + Blinn-Phong
    specular (4x shininess compensation, material.rs:196-204)] / attenuation
  * texture / procedural-texture diffuse override, uv_trans warp
  * normal-map shading normal override (nmt stays primitive-local, see
    intersect.HitDetail)
  * emits reflect/refract child rays with throughput multipliers derived from
    reflectivity and the Schlick/TIR dielectric logic (material.rs:216-317).
Recursion becomes queue emission: child contribution is
``throughput * traced_color``, which distributes over the reference's
``color += reflectivity * (R*reflected + (1-R)*refracted)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import math3d as m3
from ..config import RenderConfig
from ..scene.flatten import SceneTables
from .intersect import Hit, HitDetail, occluded


class Children(NamedTuple):
    origin: jnp.ndarray     # [R,3] (same for both children: the hit point)
    refl_dir: jnp.ndarray   # [R,3]
    refl_mult: jnp.ndarray  # [R] throughput multiplier
    refr_dir: jnp.ndarray   # [R,3]
    refr_mult: jnp.ndarray  # [R]


def _uniform(key, site: int, sid, n: int, dtype):
    """[R, n] uniforms keyed per (site, SAMPLE id): counter-based draws
    whose value per lane is independent of the batch shape, so the
    trace loop's adaptive queue slicing (processing the first k lanes of
    a compacted queue) and any capacity knob cannot shift pixels.  Drawn
    in f32 regardless of cfg.dtype: the f64 verification mode then
    samples the same glossy/area-light points as f32 (see render.py)."""
    from jax.ad_checkpoint import checkpoint_name

    k = jax.random.fold_in(key, site)
    ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k, sid)
    draw = jax.vmap(lambda kk: jax.random.uniform(kk, (n,), jnp.float32))
    # Named residual (trace._REMAT_POLICY): saving the [R,n] draws spares
    # the backward replay a per-lane threefry recompute.
    return checkpoint_name(draw(ks).astype(dtype), "shade_tmp")


def sample_atlas(data, meta, tex_ix, uv, srgb: bool = True):
    """Nearest-neighbour, euclid-wraparound atlas sampling
    (src/texture.rs:104-141): x = trunc(u*(w-1)) rem_euclid w.

    u8 texels decode arithmetically (c/255 then c^2.2 for sRGB,
    texture.rs:162-168) — a pow instead of a second [R,3]-indexed LUT
    gather, and the atlas stays at 1/12th the device memory of prebaked
    f32 texels."""
    m = meta[jnp.maximum(tex_ix, 0)]          # [R,3] (offset, w, h)
    off, w, h = m[..., 0], m[..., 1], m[..., 2]
    x = jnp.trunc(uv[..., 0] * (w - 1).astype(uv.dtype)).astype(jnp.int32)
    y = jnp.trunc(uv[..., 1] * (h - 1).astype(uv.dtype)).astype(jnp.int32)
    x = jnp.mod(x, jnp.maximum(w, 1))
    y = jnp.mod(y, jnp.maximum(h, 1))
    idx = off + y * w + x
    from jax.ad_checkpoint import checkpoint_name

    texel = data[idx].astype(uv.dtype) * (1.0 / 255.0)   # [R,3] in 0..1
    if srgb:
        texel = texel ** 2.2
    # Named residual (trace._REMAT_POLICY): the backward replay reads the
    # saved [R,3] texels instead of re-running the u8 atlas gather chain.
    return checkpoint_name(texel, "shade_tmp")


def _apply_uv_trans(uvt6, uv):
    """uv' = (uv_trans @ (u, v, 1)).xy  (material.rs:113-117).

    uvt6: [R,6] — the first two rows of the 3x3 uv transform, from the
    fused node record (flatten.py node_rec cols 25..30)."""
    u = uvt6[..., 0] * uv[..., 0] + uvt6[..., 1] * uv[..., 1] + uvt6[..., 2]
    v = uvt6[..., 3] * uv[..., 0] + uvt6[..., 4] * uv[..., 1] + uvt6[..., 5]
    return jnp.stack([u, v], axis=-1)


def _decode_normal_map(texel):
    """RGB -> RH tangent-space normal (texture.rs:192-221): decoded LH vector
    (2r-1, 2g-1, -(2b-1)) then (nx,ny,nz) -> (nx,-nz,-ny)."""
    nx = 2.0 * texel[..., 0] - 1.0
    ny = 2.0 * texel[..., 1] - 1.0
    nz = -(2.0 * texel[..., 2] - 1.0)
    return jnp.stack([nx, -nz, -ny], axis=-1)


class ShadePre(NamedTuple):
    """Occlusion-independent shading results (deferred lighting).

    The per-light contributions wait for the shadow-ray verdicts, which
    the trace loop batches into the NEXT round's nearest sweep — one
    accelerated launch per bounce round instead of two (the per-launch
    fixed cost dominates the small late-round queues)."""
    base: jnp.ndarray        # [R,3] ambient term (occlusion-independent)
    light_contrib: jnp.ndarray  # [L,R,3] per-light (diffuse+spec)/attn
    shadow_dir: jnp.ndarray  # [L,R,3] unit dirs to the (sampled) lights
    shadow_need: jnp.ndarray  # [L,R] bool — lanes whose contribution != 0
    t_eps: jnp.ndarray       # [R] secondary-ray start offsets


def shade_hits(
    d, hit: Hit, det: HitDetail, st: SceneTables, cfg: RenderConfig,
    key, active,
):
    """Returns (local_color [R,3], Children, t_eps) resolving occlusion
    inline (one occluded() launch).  The trace loop uses shade_pre +
    apply_lights instead to fuse the shadow query into the next round's
    sweep; this wrapper keeps the one-shot API for tests/tools."""
    pre, children = shade_pre(d, hit, det, st, cfg, key, active)
    R = d.shape[0]
    L = st.n_lights
    if L:
        if L == 1:
            occ = occluded(
                det.point, pre.shadow_dir[0], pre.t_eps, jnp.inf, st, cfg,
                active=active & pre.shadow_need[0],
                src_node=hit.node, src_tri=hit.tri,
            )[None]
        else:
            tile = lambda x: jnp.tile(x, (L,) + (1,) * (x.ndim - 1))
            occ = occluded(
                tile(det.point), pre.shadow_dir.reshape(L * R, 3),
                tile(pre.t_eps), jnp.inf, st, cfg,
                active=tile(active) & pre.shadow_need.reshape(L * R),
                src_node=tile(hit.node), src_tri=tile(hit.tri),
            ).reshape(L, R)
        color = apply_lights(pre, occ, active)
    else:
        color = jnp.where(active[..., None], pre.base, 0.0)
    return color, children, pre.t_eps


def apply_lights(pre: ShadePre, occ, active):
    """base + sum_l unoccluded * light_contrib_l, masked to active lanes."""
    color = pre.base
    for li in range(pre.light_contrib.shape[0]):
        lit = (~occ[li])[..., None].astype(color.dtype)
        color = color + lit * pre.light_contrib[li]
    return jnp.where(active[..., None], color, 0.0)


def shade_pre(
    d, hit: Hit, det: HitDetail, st: SceneTables, cfg: RenderConfig,
    key, active, sid=None,
):
    """Occlusion-independent shading: returns (ShadePre, Children).

    sid: optional [R] int32 per-SAMPLE ids for the glossy/area-light
    draws (counter-based: value per lane independent of batch shape —
    see _uniform).  None falls back to lane index."""
    R = d.shape[0]
    if sid is None:
        sid = jnp.arange(R, dtype=jnp.int32)
    dtype = d.dtype
    p = det.point

    # Material properties come with the hit detail's fused node record
    # (one gather total instead of nine — see flatten.py node_rec layout).
    rec = det.rec
    mat_diffuse = rec[:, 12:15]
    mat_specular = rec[:, 15:18]
    mat_shininess = rec[:, 18]
    mat_reflect = rec[:, 19]
    mat_glossy = rec[:, 20]
    mat_refr = rec[:, 21]
    mat_tex = rec[:, 22].astype(jnp.int32)
    mat_nm = rec[:, 23].astype(jnp.int32)

    view = -d
    uv = _apply_uv_trans(rec[:, 25:31], det.uv)

    # Shading normal: normal map override where available, else normalize.
    n_geom = m3.normalize(det.normal, eps=1e-30)
    if st.any_normal_map:
        use_nm = (mat_nm >= 0) & det.has_nmt & det.has_uv
        nm_texel = sample_atlas(st.nm_data, st.nm_meta, mat_nm, uv,
                                srgb=False)
        nm_vec = m3.normalize(_decode_normal_map(nm_texel), eps=1e-30)
        n_mapped = m3.matvec3(det.nmt, nm_vec)
        n = jnp.where(use_nm[..., None], n_mapped, n_geom)
    else:
        n = n_geom

    # Diffuse color: texture override (material.rs:137-143).
    diffuse_color = mat_diffuse
    if st.any_image_tex:
        img_texel = sample_atlas(st.tex_data, st.tex_meta, mat_tex, uv)
        diffuse_color = jnp.where((mat_tex >= 0)[..., None], img_texel, diffuse_color)
    for fi, fn in enumerate(st.fn_textures):
        fn_mask = mat_tex == -(fi + 2)
        diffuse_color = jnp.where(fn_mask[..., None], fn(uv).astype(dtype), diffuse_color)

    color = st.ambient[None, :] * diffuse_color

    # Secondary-ray start offset: EPSILON plus a relative term for f32
    # robustness on large scenes (reference is f64 with plain EPSILON).
    t_eps = jnp.maximum(
        jnp.asarray(cfg.epsilon, dtype),
        cfg.eps_rel * m3.norm(p, eps=1e-20),
    ) if cfg.eps_rel else jnp.full((R,), cfg.epsilon, dtype)

    if st.n_lights:
        # Per-light contributions, deferred: the shadow verdicts arrive
        # from a sweep the trace loop batches with the next round's
        # nearest query (one accelerated launch per round).
        dirs, contribs, needs = [], [], []
        # A shadow ray only matters when the light could contribute:
        # diffuse needs n.l > 0, specular needs a specular material AND
        # n.h > 0 (the reference adds specular even for lights behind the
        # surface, material.rs:196-204 — preserved; shininess == 0 makes
        # the Blinn term x^0 == 1 even for negative n.h, so those lanes
        # always need the test).  Lanes where both terms are zero skip
        # the occlusion sweep entirely (~30-50% of castle lanes), which
        # the sweep's per-ray cull turns into skipped chunks/blocks.
        spec_possible = jnp.max(mat_specular, axis=-1) > 0.0
        for li in range(st.n_lights):
            lpos = st.light_pos[li]
            lcol = st.light_color[li]
            c0, c1, c2 = st.light_falloff[li]
            if st.area_flags[li]:
                ab = _uniform(key, 1000 + 2 * li, sid, 2, dtype) * 2.0 - 1.0
                lpos = lpos + ab[:, :1] * st.light_area_a[li] \
                    + ab[:, 1:] * st.light_area_b[li]
            hit_to_light = lpos - p
            light_dist = m3.norm(hit_to_light, eps=1e-20)
            ldir = hit_to_light / jnp.maximum(light_dist, 1e-30)[..., None]
            dirs.append(ldir)
            attn = c0 + c1 * light_dist + c2 * light_dist * light_dist
            nl = jnp.maximum(m3.dot(n, ldir), 0.0)
            diffuse = diffuse_color * lcol[None, :] * nl[..., None]
            half = m3.normalize(view + ldir, eps=1e-30)
            nh_raw = m3.dot(n, half)
            # Reference semantics (material.rs:196-204): max(n.h, 0)^(4s)
            # is EXACTLY zero for n.h <= 0 when s > 0 (and 1 when s == 0).
            # The 1e-20 floor only guards pow(0, s) gradients; the explicit
            # zero keeps the term consistent with the shadow-need gate below
            # (a small-shininess 1e-20^(4s) residual would otherwise be
            # added unocclusion-tested on gated-off lanes).
            spec_on = (nh_raw > 0.0) | (mat_shininess == 0.0)
            nh = jnp.where(
                spec_on,
                jnp.maximum(nh_raw, 1e-20) ** (4.0 * mat_shininess),
                0.0,
            )
            specular = mat_specular * lcol[None, :] * nh[..., None]
            contribs.append((diffuse + specular) / attn[..., None])
            needs.append((nl > 0.0) | (spec_possible & spec_on))
        shadow_dir = jnp.stack(dirs)
        light_contrib = jnp.stack(contribs)
        shadow_need = jnp.stack(needs) & active[None]
    else:
        shadow_dir = jnp.zeros((0, R, 3), dtype)
        light_contrib = jnp.zeros((0, R, 3), dtype)
        shadow_need = jnp.zeros((0, R), bool)

    pre = ShadePre(
        base=color, light_contrib=light_contrib, shadow_dir=shadow_dir,
        shadow_need=shadow_need, t_eps=t_eps,
    )

    # ----- children ------------------------------------------------------
    if not st.any_reflective:
        zeros = jnp.zeros((R,), dtype)
        children = Children(
            origin=p, refl_dir=d, refl_mult=zeros, refr_dir=d, refr_mult=zeros
        )
        return pre, children

    dn = m3.dot(d, n)
    reflect_dir = d - 2.0 * dn[..., None] * n

    # Glossy perturbation (material.rs:221-239).
    if st.any_glossy:
        has_glossy = mat_glossy > 0.0
        aligned_z = (jnp.abs(reflect_dir[..., 0]) < cfg.epsilon) & (
            jnp.abs(reflect_dir[..., 1]) < cfg.epsilon
        )
        offset = reflect_dir + jnp.where(
            aligned_z[..., None],
            jnp.array([0.0, 0.1, 0.0], dtype),
            jnp.array([0.0, 0.0, 0.1], dtype),
        )
        u_basis = m3.cross(reflect_dir, offset)
        v_basis = m3.cross(reflect_dir, u_basis)
        uvc = _uniform(key, 2000, sid, 2, dtype)
        u_coord = (-0.5 + uvc[:, 0]) * mat_glossy
        v_coord = (-0.5 + uvc[:, 1]) * mat_glossy
        glossy_dir = (
            reflect_dir + u_coord[..., None] * u_basis + v_coord[..., None] * v_basis
        )
        reflect_dir = jnp.where(has_glossy[..., None], glossy_dir, reflect_dir)

    has_refl = mat_reflect > 0.0

    if st.any_refractive:
        is_dielectric = mat_refr > 0.0
        eta = jnp.where(is_dielectric, mat_refr, 1.0)
        entering = dn < 0.0
        # Entering (material.rs:253-264): refract(d, n, eta), eta_outside = 1.
        under_e = 1.0 - (1.0 - dn * dn) / (eta * eta)
        refr_e = (d - n * dn[..., None]) / eta[..., None] - n * m3.safe_sqrt(
            under_e
        )[..., None]
        cos_e = -dn
        # Exiting (material.rs:265-275): refract(d, -n, 1/eta) -> possible TIR.
        under_x = 1.0 - (1.0 - dn * dn) * (eta * eta)
        tir = under_x < 0.0
        refr_x = (d - n * dn[..., None]) * eta[..., None] + n * m3.safe_sqrt(
            under_x
        )[..., None]
        cos_x = m3.dot(refr_x, n)

        refr_dir = jnp.where(entering[..., None], refr_e, refr_x)
        cos_inc = jnp.where(entering, cos_e, cos_x)
        r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cos_inc) ** 5
        tir_exit = ~entering & tir

        refl_mult = jnp.where(
            is_dielectric,
            jnp.where(tir_exit, mat_reflect, mat_reflect * schlick),
            mat_reflect,
        )
        refr_mult = jnp.where(
            is_dielectric & ~tir_exit, mat_reflect * (1.0 - schlick), 0.0
        )
    else:
        refl_mult = mat_reflect
        refr_mult = jnp.zeros((R,), dtype)
        refr_dir = d

    refl_mult = jnp.where(has_refl & active, refl_mult, 0.0)
    refr_mult = jnp.where(has_refl & active, refr_mult, 0.0)

    children = Children(
        origin=p,
        refl_dir=m3.normalize(reflect_dir, eps=1e-30),
        refl_mult=refl_mult,
        refr_dir=m3.normalize(refr_dir, eps=1e-30),
        refr_mult=refr_mult,
    )
    return pre, children
