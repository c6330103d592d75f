"""Per-config forward throughput table on one GPU: iteration-scanned
chunks via Renderer.step_many — 16-iter chunks for the primitive configs,
4-iter for mesh configs; best of `--reps` chunk epochs, each waited for
with jax.block_until_ready.

Usage: python tools/perf_table.py [--configs a,b,...] [--reps 3]
Prints the device line, then one JSON line per config with ms/iter and M
path-segments/s. Refuses to run where JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> (scene file, chunk size)
CONFIGS = {
    "sphere": ("scenes/sphere.txt", 16),
    "cornell": ("scenes/cornell.txt", 16),
    "cornell_glass": ("scenes/cornell_glass.txt", 16),
    "cornell_dof": ("scenes/cornell_dof.txt", 16),
    "cornell_glossy": ("scenes/cornell_glossy.txt", 16),
    "blob": ("scenes/mesh.txt", 4),
    "textured_env_proc": ("scenes/textured_env_proc.txt", 4),
    "textured_env": ("scenes/textured_env.txt", 4),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    from bench import device_line
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer
    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)

    print(json.dumps({"device": device_line()}), flush=True)
    enable_compile_cache()

    for name in args.configs.split(","):
        scene_path, chunk = CONFIGS[name]
        path = os.path.join(ROOT, scene_path)
        if not os.path.exists(path):
            print(json.dumps({"config": name, "skipped": "missing scene"}),
                  flush=True)
            continue
        scene = load_scene(path)
        w, h = scene.camera.resolution
        depth = scene.settings.trace_depth
        r = Renderer(scene)
        r.CHUNK = chunk
        r.step_many(chunk)          # compile + warm
        jax.block_until_ready(r.accum)
        dt = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r.step_many(chunk)
            jax.block_until_ready(r.accum)
            dt = min(dt, (time.perf_counter() - t0) / chunk)
        print(json.dumps({
            "config": name, "ms_per_iter": round(dt * 1000, 2),
            "msegs_per_s": round(w * h * depth / dt / 1e6, 1),
            "resolution": [w, h], "depth": depth, "chunk": chunk,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
