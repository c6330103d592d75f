"""A/B experiment harness — the comparisons the reference scaffold
prescribes (material sort on/off: src/pathtrace.cu:366-367; stream
compaction on/off: src/pathtrace.cu:313-317; first-bounce cache on/off).

Usage:  python tools/ab_bench.py [scene] [--spp N] [--res N]
Prints one JSON line per variant with ms/iter and M path-segments/s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/cornell.txt")
    ap.add_argument("--spp", type=int, default=20)
    ap.add_argument("--res", type=int, default=0,
                    help="override square resolution")
    args = ap.parse_args()

    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer
    from project3_cuda_path_tracer_tpu.scene.types import RenderSettings

    base = load_scene(args.scene)
    if args.res:
        base.camera.resolution = (args.res, args.res)
        base.camera.derive()
    w, h = base.camera.resolution
    depth = base.settings.trace_depth

    variants = {
        "baseline": dict(),
        "material_sort": dict(sort_materials=True),
        "compact": dict(compact=True),
        "sort+compact": dict(sort_materials=True, compact=True),
        "no_antialias": dict(antialias=False),
        "first_bounce_cache": dict(antialias=False, first_bounce_cache=True),
    }

    for name, kw in variants.items():
        st = RenderSettings(**{**base.settings.__dict__, **kw})
        r = Renderer(base, settings=st)
        r.step()
        r.accum.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(args.spp):
            r.step()
        r.accum.block_until_ready()
        dt = (time.perf_counter() - t0) / args.spp
        print(json.dumps({
            "variant": name, "ms_per_iter": round(dt * 1000, 2),
            "msegs_per_s": round(w * h * depth / dt / 1e6, 1),
            "scene": args.scene, "resolution": [w, h], "depth": depth,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
