"""Scaling-efficiency harness (BASELINE target: >=80% linear rays/s scaling
across chips/hosts).

Runs the sharded renderer over submeshes of 1..K devices and reports
rays/s + efficiency vs linear. On a multi-GPU host this measures scaling
over NVLink; on the virtual CPU mesh it validates the harness and the SPMD
program only (all "devices" share one socket, so efficiency numbers are
not meaningful there — the harness prints the backend so the reader knows).

Usage: python tools/scaling_bench.py [scene] [--spp N] [--res N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_multiprocess(args) -> int:
    """Spawn an N-process jax.distributed job (tools/mp_worker.py, Gloo
    collectives on CPU) and report its steady-state throughput — the
    jax.distributed code path a multi-host launch takes."""
    import socket
    import subprocess
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(ROOT, "tools", "mp_worker.py")
    with tempfile.TemporaryDirectory() as out:
        procs = [
            subprocess.Popen(
                [sys.executable, worker, "--pid", str(i),
                 "--nproc", str(args.multiprocess), "--port", str(port),
                 "--outdir", out, "--scene", args.scene,
                 "--res", str(args.res or 256), "--spp", str(args.spp),
                 "--bench"])
            for i in range(args.multiprocess)
        ]
        rcs = [p.wait(timeout=1200) for p in procs]
    return 1 if any(rcs) else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/cornell.txt")
    ap.add_argument("--spp", type=int, default=10)
    ap.add_argument("--res", type=int, default=0)
    ap.add_argument("--multiprocess", type=int, default=0, metavar="N",
                    help="instead of submeshes, launch N jax.distributed "
                         "processes (CPU backend) and bench the global mesh")
    args = ap.parse_args()

    if args.multiprocess:
        return run_multiprocess(args)

    import jax
    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        make_mesh, ShardedRenderer)

    scene = load_scene(args.scene)
    if args.res:
        scene.camera.resolution = (args.res, args.res)
        scene.camera.derive()
    w, h = scene.camera.resolution
    depth = scene.settings.trace_depth

    total = len(jax.devices())
    sizes = [k for k in (1, 2, 4, 8, 16, 32) if k <= total and h % k == 0]

    base_rate = None
    for k in sizes:
        r = ShardedRenderer(scene, mesh=make_mesh(num_devices=k))
        r.step()
        r.accum.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(args.spp):
            r.step()
        r.accum.block_until_ready()
        dt = (time.perf_counter() - t0) / args.spp
        rate = w * h * depth / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * k)
        print(json.dumps({
            "devices": k, "backend": jax.default_backend(),
            "ms_per_iter": round(dt * 1000, 2),
            "msegs_per_s": round(rate / 1e6, 1),
            "scaling_efficiency_vs_1dev": round(eff, 3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
