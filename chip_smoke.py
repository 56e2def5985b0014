#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the mesh phase only

One card, in order (each phase raises on failure, and any failure fails
the run):

1. device     — JAX's first device must be a GPU; prints its kind and
                `nvidia-smi`'s name and power limit of the card.
2. sweeps     — the beam sweep against the flat sweep (the plain
                reference), nearest hit and any-hit, on 65,536 rays strided
                over the whole big-scene frame and on a seeded ~1,800-
                triangle mesh instanced 4 times; primary and scattered rays.
3. goldens    — five asset-free scenes rendered on the card against the
                committed CPU self-goldens in tests/self_golden/.
4. frame      — big-scene at its published 1980x1020, samples=1, default
                sweep and tile, through Image.render and Image.save; compile
                and warm frame seconds, primary Mrays/s, peak device bytes.
5. fit        — 5 Adam steps of parallel.train_step on a 256x256 centre
                crop of big-scene (mat_diffuse and light_color; the start
                has every diffuse halved, the target is the scene's own
                render); the first step's gradients against the flat sweep.
6. precision  — `dot` ops in the compiled HLO of the frame and the fit
                step (an f32 dot may run in TF32 on the card; want 0).

--four-cards runs render_tiles_sharded of the full big-scene frame and one
train_step on a 4-card mesh, each against the same work on one device.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import scenes
from bench import crop_pixels
from portrayer_tpu import (
    Image, RenderConfig, finalize, flatten_scene, render_linear, render_u8,
    to_u8, compile_cache, native, png,
)
from portrayer_tpu import (
    Scene, SceneNode, Geometry, Mesh, MeshData, Shading, Material, Light,
    CameraSettings,
)
from portrayer_tpu.camera import Camera
from portrayer_tpu.ops.intersect import intersect_scene, occluded
from portrayer_tpu.ops.trace import trace
from portrayer_tpu.parallel import (
    frame_rays, make_mesh, render_tiles_sharded, train_step,
)
from portrayer_tpu.render import lower_frame

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
GOLDEN_DIR = os.path.join(REPO, "tests", "self_golden")

FRAME_SCENE = "big-scene"
# The self-golden scenes that build without reference assets (nonhier2,
# also pinned, loads monkey.obj).
GOLDEN_SCENES = ("simple", "four-shapes", "single-triangle", "big-scene",
                 "torus-showcase")
FIT_FIELDS = ("mat_diffuse", "light_color")

FLAT = RenderConfig(accel="flat")
BEAM = RenderConfig(accel="beam")

# Equivalence of two sweeps (tests/test_beam.py's rule, float32): hits
# match exactly; t agrees to T_RTOL/T_ATOL (the two sweeps fold the same
# candidate arithmetic in another order); a winning node may differ only
# on a near-tie, |dt| <= TIE_REL * max(|t|, 1).
T_RTOL, T_ATOL, TIE_REL = 1e-4, 1e-5, 1e-4
# Gradients of two sweeps (tests/test_grad.py's rule): the same selection
# gives the same piecewise-smooth branch, up to summation order.
G_RTOL, G_ATOL = 2e-4, 1e-5
# Self-goldens (tests/test_golden.py's rule): pixels off by more than
# 2/255 must be under this fraction of the image.
GOLDEN_FRAC = 1e-3
# Looser bounds on the card, with their reason.  torus-showcase: the
# torus's float32 quartic solve (Ferrari + Newton polish) and its
# reflected rays are sensitive to operation order, which XLA:GPU fuses
# differently from the CPU that made the PNG, so a few grazing and
# reflected rays at torus silhouettes land on the other side of an edge.
# Measured on an H100: 11 of 4,096 pixels (0.27%), max 11/255.
GOLDEN_FRAC_GPU = {"torus-showcase": 5e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: the device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    """Refuse anything but a GPU; print the device and the card's name and
    power limit.  Returns nvidia-smi's line for the first card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX's first device is {dev.platform!r}, not a GPU")
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    for ln in lines:
        log(ln)
    return lines[0]


# ---------------------------------------------------------------------------
# Phase 2: sweep equivalence at real width
# ---------------------------------------------------------------------------

def mesh_scene(seed: int, n_u: int = 45, n_v: int = 20,
               instances: int = 4) -> Scene:
    """A seeded procedural triangle mesh — a torus-like closed surface of
    2 * n_u * n_v triangles (1,800 by default, the size of the reference's
    castle.obj) with seeded radial noise — instanced `instances` times on
    a row."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    v = np.linspace(0.0, 2.0 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    tube = 0.35 * (1.0 + 0.25 * rng.uniform(-1.0, 1.0, uu.shape))
    ring = 1.0 + tube * np.cos(vv)
    pos = np.stack([ring * np.cos(uu), tube * np.sin(vv),
                    ring * np.sin(uu)], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = i * n_v + j
    b = ((i + 1) % n_u) * n_v + j
    c = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    d = i * n_v + (j + 1) % n_v
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([a, c, d], -1).reshape(-1, 3)])
    data = MeshData(positions=pos, triangles=tris)
    nodes = []
    for k in range(instances):
        mat = Material(diffuse=tuple(rng.uniform(0.2, 0.9, 3)),
                       specular=(0.3, 0.3, 0.3), shininess=25.0)
        angle = float(rng.uniform(0.0, np.pi))
        nodes.append(
            SceneNode(Geometry(Mesh(data, Shading.Flat), mat))
            .rotated_x(angle).translated((3.0 * k - 4.5, 0.0, 0.0)))
    return Scene(root=SceneNode(nodes),
                 lights=[Light(position=(0.0, 8.0, 8.0),
                               color=(0.9, 0.9, 0.9))],
                 ambient=(0.2, 0.2, 0.2))


MESH_CAMERA = CameraSettings(eye=(0.0, 2.0, 12.0), center=(0.0, 0.0, 0.0),
                             fovy=np.deg2rad(30.0))
MESH_SIZE = (640, 360)


def strided_rays(camera, size, n_rays: int):
    """n_rays primary rays through pixel centres strided over the frame."""
    w, h = size
    stride = max(1, (w * h) // n_rays)
    idx = np.arange(0, w * h, stride)[:n_rays]
    cam = Camera(camera, size, dtype=jnp.float32)
    return cam.rays_at(jnp.asarray(idx % w + 0.5, jnp.float32),
                       jnp.asarray(idx // w + 0.5, jnp.float32))


def scattered_rays(o, d, hit, seed: int):
    """Incoherent rays (tests/test_beam.py): origins pulled into the scene
    along the primary rays (`hit`: their flat-sweep hits), directions
    uniformly random."""
    t = jnp.where(hit.hit, hit.t, 1.0)
    o = o + t[:, None] * d * 0.7
    d = jax.random.normal(jax.random.PRNGKey(seed), o.shape)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def compare_hits(ref, got, label: str) -> dict:
    """Raise unless `got` matches `ref` under the float32 sweep rule."""
    ref_hit, got_hit = np.asarray(ref.hit), np.asarray(got.hit)
    n_diff = int((ref_hit != got_hit).sum())
    if n_diff:
        raise AssertionError(f"{label}: {n_diff} rays disagree on hit/miss")
    rt, gt = np.asarray(ref.t)[ref_hit], np.asarray(got.t)[ref_hit]
    np.testing.assert_allclose(gt, rt, rtol=T_RTOL, atol=T_ATOL,
                               err_msg=f"{label}: t")
    mism = np.asarray(ref.node)[ref_hit] != np.asarray(got.node)[ref_hit]
    tie = np.abs(rt - gt) <= TIE_REL * np.maximum(np.abs(rt), 1.0)
    if np.any(mism & ~tie):
        raise AssertionError(
            f"{label}: {int((mism & ~tie).sum())} node mismatches off a tie")
    rel = np.abs(gt - rt) / np.maximum(np.abs(rt), 1.0)
    return {"rays": int(ref_hit.size), "hits": int(ref_hit.sum()),
            "node_ties": int(mism.sum()),
            "max_rel_dt": float(rel.max()) if rel.size else 0.0}


def sweep_programs():
    """Jitted nearest-hit and any-hit queries, {"flat"|"beam": fn}."""
    near = {c.accel: jax.jit(lambda o, d, st, c=c: intersect_scene(
        o, d, 1e-5, jnp.inf, st, c)) for c in (FLAT, BEAM)}
    anyhit = {c.accel: jax.jit(lambda o, d, st, c=c: occluded(
        o, d, 1e-5, jnp.inf, st, c)) for c in (FLAT, BEAM)}
    return near, anyhit


def compare_sweeps(st, o, d, label: str, progs) -> object:
    """Nearest hit and any-hit of the beam sweep against the flat sweep;
    returns the flat sweep's nearest hits."""
    near, anyhit = progs
    ref = near["flat"](o, d, st)
    stats = compare_hits(ref, near["beam"](o, d, st), f"{label} nearest")
    occ_f = np.asarray(anyhit["flat"](o, d, st))
    occ_b = np.asarray(anyhit["beam"](o, d, st))
    n_diff = int((occ_f != occ_b).sum())
    if n_diff:
        raise AssertionError(f"{label} any-hit: {n_diff} rays disagree")
    log(f"sweeps {label}: beam == flat; nearest {stats}; any-hit "
        f"{int(occ_f.sum())}/{occ_f.size} occluded, 0 disagree")
    return ref


def phase_sweeps(n_rays: int = 65536, seed: int = 0) -> None:
    spec = scenes.load(FRAME_SCENE)
    cases = [
        (FRAME_SCENE, flatten_scene(spec.scene), spec.camera, spec.size),
        ("mesh-4x1800", flatten_scene(mesh_scene(seed)), MESH_CAMERA,
         MESH_SIZE),
    ]
    progs = sweep_programs()
    for name, st, camera, size in cases:
        if st.n_nodes + st.n_pairs < BEAM.beam_min_prims:
            raise AssertionError(f"{name} is below beam_min_prims")
        o, d = strided_rays(camera, size, n_rays)
        hit = compare_sweeps(st, o, d, f"{name} primary x{o.shape[0]}",
                             progs)
        o, d = scattered_rays(o, d, hit, seed)
        compare_sweeps(st, o, d, f"{name} scattered x{o.shape[0]}", progs)


# ---------------------------------------------------------------------------
# Phase 3: self-goldens rendered on the card
# ---------------------------------------------------------------------------

def phase_goldens(names=GOLDEN_SCENES, bounds=GOLDEN_FRAC_GPU) -> dict:
    from tools.gen_self_goldens import render_one

    fracs = {}
    for name in names:
        with open(os.path.join(GOLDEN_DIR, f"{name}.png"), "rb") as f:
            gold = png.decode(f.read()).astype(np.int16)
        t0 = time.perf_counter()
        ours = render_one(name).astype(np.int16)
        secs = time.perf_counter() - t0
        if ours.shape != gold.shape:
            raise AssertionError(f"{name}: {ours.shape} vs {gold.shape}")
        diff = np.abs(ours - gold)
        frac = float((diff > 2).any(axis=-1).mean())
        fracs[name] = frac
        bound = bounds.get(name, GOLDEN_FRAC)
        log(f"golden {name} {ours.shape[1]}x{ours.shape[0]}: "
            f"{frac:.6f} of pixels off by >2/255 (max {int(diff.max())}; "
            f"bound {bound}; {secs:.1f} s with compile)")
        if frac >= bound:
            raise AssertionError(f"{name}: {frac:.4%} of pixels differ")
    return fracs


# ---------------------------------------------------------------------------
# Phase 4: the full frame
# ---------------------------------------------------------------------------

def _bg_u8(spec, size) -> np.ndarray:
    w, h = size
    ys, xs = np.mgrid[0:h, 0:w]
    uv = jnp.asarray(np.stack([xs / w, ys / h], axis=-1), jnp.float32)
    return to_u8(finalize(np.asarray(spec.background(uv), np.float64)))


def phase_frame(size=None, card: str = "", reps: int = 3,
                out_dir: str = OUT_DIR) -> dict:
    spec = scenes.load(FRAME_SCENE)
    w, h = size or spec.size
    cfg = RenderConfig(samples=1)
    st = flatten_scene(spec.scene, dtype=cfg.dtype)

    t0 = time.perf_counter()
    first = render_u8(st, spec.camera, (w, h), spec.background, cfg)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render_u8(st, spec.camera, (w, h), spec.background, cfg)
        times.append(time.perf_counter() - t0)
    warm_s = float(np.median(times))

    lin = render_linear(st, spec.camera, (w, h), spec.background, cfg)
    if not np.isfinite(lin).all():
        raise AssertionError(
            f"frame: {int((~np.isfinite(lin)).any(-1).sum())} non-finite px")
    os.makedirs(out_dir, exist_ok=True)
    img = Image(os.path.join(out_dir, f"{FRAME_SCENE}.png"), w, h)
    img.render(spec.scene, spec.camera, spec.background, cfg)
    img.save()
    if not np.array_equal(img.buffer, first):
        raise AssertionError("frame: Image.render differs from render_u8")
    off_bg = float((np.abs(img.buffer.astype(np.int16)
                           - _bg_u8(spec, (w, h))) > 1).any(-1).mean())
    if off_bg < 0.01:
        raise AssertionError(f"frame: only {off_bg:.2%} of pixels are "
                             "not background")
    stats = jax.devices()[0].memory_stats() or {}
    out = {
        "size": f"{w}x{h}", "sweep": cfg.accel, "tile": list(cfg.tile),
        "first_call_s": first_s, "warm_frame_s": warm_s,
        "compile_s": first_s - warm_s,
        "primary_mrays_per_s": w * h / warm_s / 1e6,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "not_background_fraction": off_bg,
    }
    log(f"frame {FRAME_SCENE} [{card}]: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: fit steps
# ---------------------------------------------------------------------------

def fit_problem(res: int = 256):
    """big-scene's tile16-ordered res x res centre crop: (st, cfg, rays,
    target) with the target rendered from the scene's own parameters."""
    spec = scenes.load(FRAME_SCENE)
    cfg = RenderConfig(samples=1)
    st = flatten_scene(spec.scene, dtype=cfg.dtype)
    w, h = spec.size
    px, py = crop_pixels(spec.size, res)
    cam = Camera(spec.camera, spec.size, dtype=cfg.dtype)
    o, d = cam.rays_at(jnp.asarray(px + 0.5, cfg.dtype),
                       jnp.asarray(py + 0.5, cfg.dtype))
    P_ = px.shape[0]
    pix = jnp.arange(P_, dtype=jnp.int32)
    bg = spec.background(jnp.asarray(
        np.stack([px / w, py / h], axis=-1), cfg.dtype)).astype(cfg.dtype)
    key = jax.random.PRNGKey(0)
    target = jax.jit(lambda o, d, st: trace(
        key, o, d, pix, bg, P_, st, cfg, spp_contiguous=1))(o, d, st)
    return st, cfg, (key, o, d, pix, bg, P_), target


def fit_grads(mesh, st, cfg, rays, target, params):
    """(loss, grads) of one train_step at `params` on `mesh`."""
    key, o, d, pix, bg, P_ = rays
    fn = jax.jit(lambda params, o, d: train_step(
        mesh, key, o, d, pix, bg, P_, 1, target, st.replace(**params), cfg,
        fields=FIT_FIELDS))
    return fn(params, o, d)


def compare_grads(ga: dict, gb: dict, label: str) -> None:
    for name in FIT_FIELDS:
        np.testing.assert_allclose(
            np.asarray(gb[name]), np.asarray(ga[name]), rtol=G_RTOL,
            atol=G_ATOL, err_msg=f"{label}: {name}")
    log(f"grads {label}: agree (rtol {G_RTOL}, atol {G_ATOL})")


def phase_fit(res: int = 256, steps: int = 5, lr: float = 0.02) -> dict:
    import optax

    st, cfg, rays, target = fit_problem(res)
    key, o, d, pix, bg, P_ = rays
    mesh = make_mesh(1)
    opt = optax.adam(lr)
    params = {"mat_diffuse": st.mat_diffuse * 0.5,
              "light_color": st.light_color}
    # Replicated on the mesh, as the step returns them: the step then
    # compiles once, not again for its own outputs.
    params, opt_state = jax.device_put(
        (params, opt.init(params)), NamedSharding(mesh, PartitionSpec()))

    @jax.jit
    def step(params, opt_state, o, d):
        loss, grads = train_step(
            mesh, key, o, d, pix, bg, P_, 1, target, st.replace(**params),
            cfg, fields=FIT_FIELDS)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params0 = params
    losses, times, first_grads = [], [], None
    for i in range(steps + 1):
        t0 = time.perf_counter()
        params, opt_state, loss, grads = jax.block_until_ready(
            step(params, opt_state, o, d))
        times.append(time.perf_counter() - t0)
        loss = float(loss)
        if not np.isfinite(loss) or not all(
                np.isfinite(np.asarray(g)).all() for g in grads.values()):
            raise AssertionError(f"fit step {i + 1}: non-finite loss/grads")
        if first_grads is None:
            first_grads = grads
        losses.append(loss)
        log(f"fit step {i + 1}: loss {loss:.9g} ({times[-1]:.3f} s)"
            if i < steps else f"fit after {steps} steps: loss {loss:.9g}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"fit: losses not falling {losses}")

    other = RenderConfig(samples=1,
                         accel="flat" if cfg.accel == "beam" else "beam")
    _, other_grads = fit_grads(mesh, st, other, rays, target, params0)
    compare_grads(first_grads, other_grads,
                  f"fit step 1, {cfg.accel} vs {other.accel}")
    return {"losses": losses, "first_step_s": times[0],
            "warm_step_s": float(np.median(times[1:])),
            "step": step, "args": (params, opt_state, o, d)}


# ---------------------------------------------------------------------------
# Phase 6: precision
# ---------------------------------------------------------------------------

_DOT = re.compile(r"\bdot\(|__cublas|triton_gemm")


def count_dots(hlo_text: str) -> int:
    """Matrix products in compiled HLO: dot instructions and the cuBLAS or
    Triton GEMM calls XLA lowers them to."""
    return len(_DOT.findall(hlo_text))


def phase_precision(frame_size=None, fit=None) -> dict:
    spec = scenes.load(FRAME_SCENE)
    cfg = RenderConfig(samples=1)
    st = flatten_scene(spec.scene, dtype=cfg.dtype)
    counts = {"frame": count_dots(lower_frame(
        st, spec.camera, frame_size or spec.size, spec.background,
        cfg).compile().as_text())}
    if fit is not None:
        counts["fit_step"] = count_dots(
            fit["step"].lower(*fit["args"]).compile().as_text())
    log(f"precision: dot/cuBLAS ops in compiled HLO {counts}")
    if any(counts.values()):
        raise AssertionError(f"f32 dots in the compiled program: {counts}")
    return counts


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_four_cards(n_dev: int = 4, size=None, fit_res: int = 256,
                     tie_frac: float = 1e-4) -> dict:
    """render_tiles_sharded and train_step on an n_dev mesh against the
    same rays (and per-shard keys) traced on one device."""
    if len(jax.devices()) < n_dev:
        raise SystemExit(f"chip_smoke: needs {n_dev} devices, "
                         f"found {len(jax.devices())}")
    spec = scenes.load(FRAME_SCENE)
    w, h = size or spec.size
    cfg = RenderConfig(samples=1)
    st = flatten_scene(spec.scene, dtype=cfg.dtype)
    key = jax.random.PRNGKey(cfg.seed)
    mesh = make_mesh(n_dev)

    t0 = time.perf_counter()
    img_n = render_tiles_sharded(mesh, st, spec.camera, (w, h),
                                 spec.background, cfg, key=key)
    sharded_s = time.perf_counter() - t0

    o, d, pix, bg, w0 = frame_rays(spec.camera, (w, h), spec.background,
                                   cfg, n_dev, key)
    one = jax.jit(lambda k, o, d, pix, w0: trace(
        k, o, d, pix, bg, w * h, st, cfg, w0=w0))
    rs = o.shape[0] // n_dev
    k1 = jax.random.fold_in(key, 1)
    acc = jnp.zeros((w * h, 3), cfg.dtype)
    for i in range(n_dev):
        sl = slice(i * rs, (i + 1) * rs)
        acc = acc + one(jax.random.fold_in(k1, i), o[sl], d[sl], pix[sl],
                        w0[sl])
    img_1 = np.asarray(acc, np.float64).reshape(h, w, 3)
    if not np.isfinite(img_n).all():
        raise AssertionError("four cards: non-finite pixels")
    diff = np.abs(img_n - img_1).max(axis=-1)
    frac = float((diff > 1e-5 + 1e-5 * np.abs(img_1).max(-1)).mean())
    log(f"four-card frame {w}x{h} on {n_dev} devices ({sharded_s:.3f} s "
        f"incl. compile) vs one device: max |d| {diff.max():.3g}, "
        f"{frac:.6f} of pixels beyond rtol/atol 1e-5 (bound {tie_frac})")
    if frac > tie_frac:
        raise AssertionError(f"four cards: {frac:.4%} of pixels differ")

    st_f, cfg_f, rays, target = fit_problem(fit_res)
    params = {"mat_diffuse": st_f.mat_diffuse * 0.5,
              "light_color": st_f.light_color}
    loss_n, g_n = fit_grads(mesh, st_f, cfg_f, rays, target, params)
    loss_1, g_1 = fit_grads(make_mesh(1), st_f, cfg_f, rays, target, params)
    log(f"four-card train_step loss {float(loss_n):.9g} vs one device "
        f"{float(loss_1):.9g}")
    np.testing.assert_allclose(float(loss_n), float(loss_1), rtol=G_RTOL)
    compare_grads(g_1, g_n, f"train_step {n_dev} devices vs 1")
    return {"frame_max_abs_diff": float(diff.max()), "frame_frac": frac}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the procedural mesh and scattered rays")
    args = ap.parse_args(argv)

    card = phase_device()
    log(f"compile cache: {compile_cache.enable()}")
    log(f"native host library loaded: {native.available()}")
    if args.four_cards:
        phase_four_cards()
    else:
        phase_sweeps(seed=args.seed)
        phase_goldens()
        phase_frame(card=card)
        fit = phase_fit()
        log(f"fit [{card}]: first step {fit['first_step_s']:.3f} s "
            f"(compile included), warm step {fit['warm_step_s']:.4f} s")
        phase_precision(fit=fit)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
