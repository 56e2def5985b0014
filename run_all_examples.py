#!/usr/bin/env python
"""Render every example scene (the reference's run-all-examples.sh +
Travis CI loop, .travis.yml:16-21): smoke renders at low sample count.

Usage:
    python run_all_examples.py [--samples N] [--scale F] [--out DIR]
                               [--only name1,name2] [--accel beam|flat]

Renders each scene at `scale` x native resolution and saves PNGs.
SAMPLES defaults to 2 like CI.
"""

import argparse
import json
import os
import time

import scenes
from portrayer_tpu import Image, RenderConfig, RenderProgress


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=int(os.environ.get("SAMPLES", 2)))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="render_out")
    ap.add_argument("--only", default=None)
    # Default: the library's default sweep (see RenderConfig.accel).
    ap.add_argument("--accel", default=RenderConfig.accel)
    ap.add_argument("--tile", type=int, default=128)
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    names = args.only.split(",") if args.only else scenes.names()

    results = {}
    for name in names:
        t0 = time.time()
        spec = scenes.load(name)
        w = max(16, int(spec.size[0] * args.scale))
        h = max(16, int(spec.size[1] * args.scale))
        cfg = RenderConfig(samples=args.samples, tile=(args.tile, args.tile),
                           accel=args.accel, queue_caps=spec.queue_caps)
        img = Image(os.path.join(args.out, f"{name}.png"), w, h)
        img.render(spec.scene, spec.camera, spec.background, cfg,
                   reporter=RenderProgress())
        img.save()
        dt = time.time() - t0
        rays = w * h * args.samples
        results[name] = {"secs": round(dt, 2), "Mrays/s": round(rays / dt / 1e6, 3)}
        print(f"{name:34s} {w}x{h}  {dt:8.2f}s  {rays/dt/1e6:7.3f} Mrays/s",
              flush=True)

    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
