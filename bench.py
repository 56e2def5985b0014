"""Benchmark: big-scene's frame, forward trace and fit step on the GPU.

    python bench.py [--accel beam,flat] [--reps 5]

Stages on big-scene (the reference's own benchmark scene), each timed for
every sweep in --accel (any failure fails the run):
  frame    the full published 1980x1020 frame, samples=1, through
           render_u8 (default tile); primary Mrays/s.
  fwd      trace() of a 256x256 tile16-ordered centre crop (each 16x16
           pixel tile contiguous, as render.py dispatches tiles).
  fwd_bwd  one parallel.train_step on that crop on a one-device mesh.
  scaling  weak scaling of trace_sharded over 1..N cards (only when JAX
           sees more than one GPU).
Sweeps are timed in turns (A B B A) after every program has compiled, and
each number is the median over the turns.  Prints the device, the card's
name and power limit, then one JSON line.  Exits non-zero without a GPU.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_MRAYS = 0.43  # reference big-scene primary throughput (BASELINE.md)
SCENE = "big-scene"
CROP = 256


def crop_pixels(size, res: int):
    """Integer pixel coordinates (px, py) of the res x res centre crop of a
    (width, height) frame, ordered tile by tile in 16x16 pixel tiles."""
    w, h = size
    x0, y0 = (w - res) // 2, (h - res) // 2
    ys, xs = np.mgrid[y0:y0 + res, x0:x0 + res]
    tile16 = lambda a: (a.reshape(res // 16, 16, res // 16, 16)
                        .transpose(0, 2, 1, 3).reshape(-1))
    return tile16(xs), tile16(ys)


def _block_time(fn, *args):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def _stage_programs(accel: str):
    """{stage: (callable, args, primary rays per call)} for one sweep."""
    import jax
    import jax.numpy as jnp
    import scenes
    from portrayer_tpu import RenderConfig, render_u8
    from portrayer_tpu.camera import Camera
    from portrayer_tpu.ops.trace import trace
    from portrayer_tpu.parallel import make_mesh, train_step
    from portrayer_tpu.scene.flatten import flatten_scene

    spec = scenes.load(SCENE)
    cfg = RenderConfig(samples=1, accel=accel, queue_caps=spec.queue_caps)
    st = flatten_scene(spec.scene, dtype=cfg.dtype)
    w, h = spec.size

    def frame():
        return render_u8(st, spec.camera, (w, h), spec.background, cfg)

    px, py = crop_pixels(spec.size, CROP)
    cam = Camera(spec.camera, spec.size, dtype=cfg.dtype)
    o, d = cam.rays_at(jnp.asarray(px + 0.5, cfg.dtype),
                       jnp.asarray(py + 0.5, cfg.dtype))
    P_ = px.shape[0]
    pix = jnp.arange(P_, dtype=jnp.int32)
    bg = jnp.zeros((P_, 3), cfg.dtype)
    key = jax.random.PRNGKey(0)
    fwd = jax.jit(lambda k, o, d: trace(
        k, o, d, pix, bg, P_, st, cfg, spp_contiguous=1))
    mesh = make_mesh(1)
    target = jnp.zeros((P_, 3), cfg.dtype)
    fwd_bwd = jax.jit(lambda k, o, d: train_step(
        mesh, k, o, d, pix, bg, P_, 1, target, st, cfg))
    return {"frame": (frame, (), w * h),
            "fwd": (fwd, (key, o, d), P_),
            "fwd_bwd": (fwd_bwd, (key, o, d), P_)}


def bench_stages(accels, reps: int) -> dict:
    """Compile every (stage, sweep) program, check it is finite, then time
    the sweeps in A B B A turns; returns per-stage per-sweep numbers."""
    import jax

    progs = {a: _stage_programs(a) for a in accels}
    out = {}
    for a, stages in progs.items():
        for stage, (fn, args, _) in stages.items():
            first_s = _block_time(fn, *args)
            for x in jax.tree_util.tree_leaves(fn(*args)):
                x = np.asarray(x)
                if x.dtype.kind == "f" and not np.isfinite(x).all():
                    raise AssertionError(f"{stage}/{a}: non-finite output")
            out.setdefault(stage, {})[a] = {"first_call_s": first_s,
                                            "times": []}
    turns = list(accels) + list(accels)[::-1]
    for a in turns:
        for stage, (fn, args, _) in progs[a].items():
            out[stage][a]["times"] += [_block_time(fn, *args)
                                       for _ in range(reps)]
    for stage, per in out.items():
        for a, rec in per.items():
            rays = progs[a][stage][2]
            t = float(np.median(rec["times"]))
            rec.update(median_s=t, spread_s=float(np.ptp(rec["times"])),
                       mrays_per_s=rays / t / 1e6)
            del rec["times"]
    return out


def bench_scaling(res=CROP, spp=1):
    """WEAK scaling: rays/s of trace_sharded over 1, 2, 4, ... cards with
    rays per card held constant (big-scene camera grid, scene
    replicated, the framebuffer psum the only collective)."""
    import jax
    import jax.numpy as jnp
    import scenes
    from portrayer_tpu import RenderConfig, flatten_scene
    from portrayer_tpu.camera import Camera
    from portrayer_tpu.parallel import make_mesh, trace_sharded

    n_avail = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8) if n <= n_avail]
    spec = scenes.load(SCENE)
    cfg = RenderConfig(samples=spp)
    st = flatten_scene(spec.scene, dtype=cfg.dtype)
    cam = Camera(spec.camera, spec.size, dtype=cfg.dtype)
    w, h = spec.size
    key = jax.random.PRNGKey(0)
    rows = []
    base = None
    for n in counts:
        P_ = res * res * n
        idx = np.arange(P_) * max(1, (w * h) // P_)
        px = jnp.asarray(np.repeat(idx % w, spp), cfg.dtype) + 0.5
        py = jnp.asarray(np.repeat(idx // w, spp), cfg.dtype) + 0.5
        o, d = cam.rays_at(px, py)
        pix = jnp.asarray(np.repeat(np.arange(P_), spp), jnp.int32)
        bg = jnp.zeros((P_, 3), cfg.dtype)
        mesh = make_mesh(n)
        fn = jax.jit(lambda k, o, d, mesh=mesh, P_=P_: trace_sharded(
            mesh, k, o, d, pix, bg, P_, st, cfg))
        _block_time(fn, key, o, d)
        t = float(np.median([_block_time(fn, key, o, d) for _ in range(5)]))
        rps = P_ * spp / t
        base = base or rps
        rows.append({"devices": n, "rays_per_s": rps,
                     "weak_scaling_eff": rps / (base * n)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--accel", default="beam,flat",
                    help="comma-separated sweeps to time")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls per stage per turn")
    args = ap.parse_args(argv)

    import jax
    from portrayer_tpu import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: JAX's first device is {dev.platform!r}, "
                         "not a GPU")
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    print(f"device: {device}", file=sys.stderr, flush=True)

    accels = [a for a in args.accel.split(",") if a]
    stages = bench_stages(accels, args.reps)
    frame = stages["frame"]
    best = min(frame, key=lambda a: frame[a]["median_s"])
    out = {
        "metric": f"{SCENE}_frame_primary_rays",
        "value": frame[best]["mrays_per_s"],
        "unit": "Mrays/s",
        "sweep": best,
        "vs_reference_cpu": frame[best]["mrays_per_s"] / BASELINE_MRAYS,
        "device": device,
        "stages": stages,
    }
    if len(jax.devices()) > 1:
        out["scaling"] = bench_scaling()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
