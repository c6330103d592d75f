"""Train-step benchmark: forward+backward path-segments/s on one GPU for
Cornell 800x800 depth 8 — one differentiable train step renders one full
iteration and backpropagates a pixel loss into material + camera
parameters (BASELINE.json north star).

The reference publishes no numbers (BASELINE.md: "published": {}).

Both bounce-loop schedules are timed — the unrolled-no-remat form and the
scan+save-"hits" form — and each is reported (``sched_unroll_ms`` /
``sched_scan_ms``); the faster one is the headline. Each epoch scans
TIMED_STEPS optimizer steps in one device program
(models/inverse.make_train_scan) and is timed through
``jax.block_until_ready``.

Prints the device line (platform, device kind, count, and the card's name
and power limit from nvidia-smi) and then ONE JSON result line. Exits
non-zero, printing no result, where JAX finds no GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

WIDTH = HEIGHT = 800
DEPTH = 8
TIMED_STEPS = 20


def device_line() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit; exits where there is no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"bench: no GPU (JAX platform "
                         f"{devs[0].platform!r}); refusing to run\n")
        raise SystemExit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": smi.stdout.strip().splitlines()}


def main() -> int:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render.integrator import TraceConfig
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, make_train_scan, make_seed_history)
    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)

    device = device_line()
    print(json.dumps({"device": device}), flush=True)
    enable_compile_cache()

    scene = load_scene("scenes/cornell.txt")
    assert scene.camera.resolution == (WIDTH, HEIGHT)

    gt = tuple(int(t) for t in np.asarray(scene.geoms.type))

    def cfg_for(schedule: str) -> TraceConfig:
        # "unroll": bounce loop unrolled, remat off (residual planes stay
        # plain live values; no scan stacking, no backward recompute).
        # "scan": lax.scan over bounces + remat_save="hits" — the
        # memory-robust schedule. Gradients are path-identical between
        # the two.
        return TraceConfig(width=WIDTH, height=HEIGHT, trace_depth=DEPTH,
                           antialias=True, geom_types=gt,
                           glossy=False, sky=False,
                           unroll=(schedule == "unroll"),
                           remat=(schedule == "scan"))

    key = jax.random.PRNGKey(0)
    target = jnp.zeros((HEIGHT, WIDTH, 3), jnp.float32)

    def measure(schedule: str) -> float:
        """Best-of-3 scanned-epoch seconds for one trace schedule, using
        the one-render history-residual step (models/inverse.py)."""
        cfg = cfg_for(schedule)
        opt, run = make_train_scan(scene.geoms, scene.meshes,
                                   scene.textures, cfg,
                                   num_steps=TIMED_STEPS, history=True)
        params = jax.tree_util.tree_map(      # copy: the step donates
            jnp.array, RenderParams(materials=scene.materials,
                                    cam=scene.camera.flat()))
        opt_state = opt.init(params)
        seed_hist = make_seed_history(scene.geoms, scene.meshes,
                                      scene.textures, cfg)
        hist = seed_hist(params, jax.random.fold_in(key, 999))
        # warmup/compile (one full scanned epoch)
        params, opt_state, hist, losses = jax.block_until_ready(
            run(params, opt_state, hist, key, target))
        dt = float("inf")
        for r in range(1, 4):
            t0 = time.perf_counter()
            params, opt_state, hist, losses = jax.block_until_ready(
                run(params, opt_state, hist, jax.random.fold_in(key, r),
                    target))
            dt = min(dt, time.perf_counter() - t0)
        if not np.isfinite(np.asarray(losses)).all():
            raise RuntimeError(f"{schedule}: non-finite loss")
        return dt

    dt_unroll = measure("unroll")
    dt_scan = measure("scan")
    schedule = "unroll" if dt_unroll <= dt_scan else "scan"
    dt = min(dt_unroll, dt_scan)
    segs_per_s = TIMED_STEPS * WIDTH * HEIGHT * DEPTH / dt

    print(json.dumps({
        "metric": "cornell_800x800_depth8_fwdbwd_path_segments_per_s",
        "value": segs_per_s,
        "unit": "rays/s",
        "device": device,
        "scanned_ms_per_step": dt * 1e3 / TIMED_STEPS,
        "schedule": schedule,
        "sched_unroll_ms": dt_unroll * 1e3 / TIMED_STEPS,
        "sched_scan_ms": dt_scan * 1e3 / TIMED_STEPS,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
