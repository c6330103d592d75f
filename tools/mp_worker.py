"""Multi-process distributed render worker (SURVEY §5.8 backend, actually
exercised).

One OS process of an N-process `jax.distributed` job: initializes the
coordinator/worker connection, builds the GLOBAL data mesh spanning every
process's devices, renders the scene with ShardedRenderer (collectives ride
Gloo on the CPU backend), then writes its *addressable*
accumulator shards to --outdir as shard_<row0>.npy for host-side assembly.

Launched by tests/test_multiprocess.py (2-process correctness proof) and by
tools/scaling_bench.py --multiprocess N. The workers stay on the CPU
backend: N processes must never each open every GPU of the host (each
would reserve most of every card's memory). Run manually:

  python tools/mp_worker.py --pid 0 --nproc 2 --port 7890 --outdir /tmp/out &
  python tools/mp_worker.py --pid 1 --nproc 2 --port 7890 --outdir /tmp/out
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--scene", default="scenes/cornell.txt")
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--devices-per-proc", type=int, default=2,
                    help="virtual CPU devices per process")
    ap.add_argument("--bench", action="store_true",
                    help="time the steady-state steps; pid 0 prints JSON")
    args = ap.parse_args()

    # Backend env must be decided before jax initializes a backend.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%d" % args.devices_per_proc)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)

    import jax
    jax.config.update("jax_platforms", "cpu")
    # Must precede any backend-initializing call (jax.devices etc.).
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.nproc, process_id=args.pid)

    import numpy as np
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        make_mesh, ShardedRenderer)

    expect = args.nproc * args.devices_per_proc
    if len(jax.devices()) != expect:
        raise RuntimeError(f"global mesh has {len(jax.devices())} devices, "
                           f"expected {expect}")

    scene = load_scene(args.scene)
    scene.camera.resolution = (args.res, args.res)
    scene.camera.derive()
    scene.settings.trace_depth = args.depth

    r = ShardedRenderer(scene, mesh=make_mesh())
    r.render(args.spp, seed=args.seed)

    os.makedirs(args.outdir, exist_ok=True)
    for sh in r.accum.addressable_shards:
        row0 = sh.index[0].start or 0
        np.save(os.path.join(args.outdir, f"shard_{row0}.npy"),
                np.asarray(sh.data))

    if args.bench:
        t0 = time.perf_counter()
        r.render(args.spp)
        dt = (time.perf_counter() - t0) / args.spp
        if args.pid == 0:
            w, h = scene.camera.resolution
            print(json.dumps({
                "multiprocess": args.nproc,
                "devices": len(jax.devices()),
                "backend": jax.devices()[0].platform,
                "ms_per_iter": round(dt * 1e3, 3),
                "rays_per_s": round(w * h * args.depth / dt),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
