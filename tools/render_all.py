"""Render every benchmark config and save the images + one JSON line of
timing per config (the round's evidence pack).

Usage: python tools/render_all.py [--outdir renders] [--spp N] [--quick]
Run on the GPU (JAX's default platform); --quick caps iterations for smoke
runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = [
    ("scenes/cornell.txt", 500),
    ("scenes/cornell_glass.txt", 500),
    ("scenes/cornell_dof.txt", 500),
    ("scenes/mesh.txt", 200),
    ("scenes/textured_env_proc.txt", 50),
    ("scenes/dispersion.txt", 500),
    ("scenes/sdf.txt", 200),
    ("scenes/lights.txt", 200),
    ("scenes/manylights.txt", 400),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="renders")
    ap.add_argument("--spp", type=int, default=0,
                    help="override spp for every config")
    ap.add_argument("--quick", action="store_true",
                    help="cap at 8 spp (smoke run)")
    args = ap.parse_args()

    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    from project3_cuda_path_tracer_tpu import load_scene, Renderer

    os.makedirs(args.outdir, exist_ok=True)
    for scene_path, spp in CONFIGS:
        if args.spp:
            spp = args.spp
        if args.quick:
            spp = min(spp, 8)
        s = load_scene(scene_path)
        w, h = s.camera.resolution
        dep = s.settings.trace_depth
        name = os.path.splitext(os.path.basename(scene_path))[0]
        r = Renderer(s)
        t0 = time.perf_counter()
        r.step()
        r.accum.block_until_ready()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r.render(spp - 1)
        wall = time.perf_counter() - t0
        out = r.save(os.path.join(args.outdir, f"{name}_{spp}spp"))
        print(json.dumps({
            "scene": scene_path, "spp": spp, "resolution": [w, h],
            "depth": dep, "compile_s": round(compile_s, 1),
            "render_s": round(wall, 2),
            "ms_per_iter": round(wall / max(spp - 1, 1) * 1000, 2),
            "msegs_per_s": round(
                (spp - 1) * w * h * dep / max(wall, 1e-9) / 1e6, 1),
            "output": out,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
