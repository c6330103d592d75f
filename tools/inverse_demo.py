"""Inverse-rendering demo: recover a perturbed wall albedo by gradient
descent through the renderer.

Renders a target Cornell image with the true materials, perturbs the white
walls' albedo, then fits it back with the unbiased two-sample MSE gradient
(models/inverse.py). Saves target / initial / recovered images and prints
one JSON line per log step.

Usage: python tools/inverse_demo.py [--res 64] [--steps 300] [--outdir renders]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--outdir", default="renders")
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--history", action="store_true",
                    help="use the one-render history-residual loss "
                         "(models/inverse.history_residual_grad_loss) "
                         "instead of the two-render unbiased loss — the "
                         "throughput train-step form; fits must "
                         "match")
    ap.add_argument("--polish", type=int, default=0,
                    help="with --history: run the LAST N steps with the "
                         "two-render unbiased loss (the round-5 "
                         "InverseRenderer.fit default, POLISH_STEPS=30) — "
                         "removes the history loss's one-adam-step "
                         "equilibrium shift at ~zero throughput cost")
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    import optax
    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render import integrator as integ
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, render_image, unbiased_mse_grad_loss)
    from project3_cuda_path_tracer_tpu.utils.image import write_png

    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (args.res, args.res)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    cfg = integ.TraceConfig(width=args.res, height=args.res,
                            trace_depth=args.depth, antialias=False,
                            geom_types=gt, glossy=False, sky=False)

    render = jax.jit(lambda p, k: render_image(
        p, s.geoms, s.meshes, s.textures, k, cfg))

    true_params = RenderParams(materials=s.materials, cam=s.camera.flat())
    keys = [jax.random.PRNGKey(i) for i in range(8)]
    target = jnp.mean(jnp.stack([render(true_params, k) for k in keys]), 0)

    bad = dataclasses.replace(
        s.materials, color=s.materials.color.at[1].set(
            jnp.array([0.2, 0.6, 0.3])))
    params = RenderParams(materials=bad, cam=true_params.cam)
    initial_img = render(params, keys[0])

    opt = optax.adam(args.lr)
    opt_state = opt.init(params)

    def _mask_grads(params, grads):
        return RenderParams(
            materials=dataclasses.replace(
                jax.tree_util.tree_map(jnp.zeros_like, params.materials),
                color=grads.materials.color),
            cam=jax.tree_util.tree_map(jnp.zeros_like, params.cam))

    @jax.jit
    def step(params, opt_state, key):
        loss_fn = lambda p: unbiased_mse_grad_loss(
            p, s.geoms, s.meshes, s.textures, key, cfg, target)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = _mask_grads(params, grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    from project3_cuda_path_tracer_tpu.models.inverse import (
        history_residual_grad_loss)

    @jax.jit
    def hstep(params, opt_state, hist, key):
        loss_fn = lambda p: history_residual_grad_loss(
            p, s.geoms, s.meshes, s.textures, key, cfg, target, hist)
        (loss, img), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads = _mask_grads(params, grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                jax.lax.stop_gradient(img), loss)

    key = jax.random.PRNGKey(11)
    hist = render(params, jax.random.PRNGKey(777)) if args.history else None
    tail = []
    polish_from = args.steps - (args.polish if args.history else 0)
    for i in range(args.steps):
        key, k = jax.random.split(key)
        if args.history and i < polish_from:
            params, opt_state, hist, loss = hstep(params, opt_state, hist, k)
        else:
            params, opt_state, loss = step(params, opt_state, k)
        # Polyak tail: with --polish, average the polished steps minus a
        # 15-step switch transient (the shifted history equilibrium
        # decays over ~1/(1-b1)=10 adam steps). NOTE (measured, round
        # 5): at lr 5e-2 the single-sample iterates RANDOM-WALK around
        # the optimum with ~0.15 std — recovered-value comparisons are
        # only meaningful over equal-length Polyak windows (use
        # --polish 135 to match the default 120-step window).
        tail_start = (args.steps - max(10, args.polish - 15)
                      if args.history and args.polish
                      else args.steps * 3 // 5)
        if i >= tail_start:
            tail.append(np.asarray(params.materials.color[1]))
        if i % 50 == 0 or i == args.steps - 1:
            print(json.dumps({
                "step": i, "loss": round(float(loss), 6),
                "albedo": [round(float(v), 4)
                           for v in params.materials.color[1]],
            }), flush=True)

    recovered = np.stack(tail).mean(0)
    print(json.dumps({
        "true_albedo": [0.98, 0.98, 0.98],
        "start_albedo": [0.2, 0.6, 0.3],
        "recovered_albedo": [round(float(v), 4) for v in recovered],
    }))

    os.makedirs(args.outdir, exist_ok=True)

    def save(name, img):
        arr = np.clip(np.asarray(img)[:, ::-1, :], 0, 1)
        write_png(os.path.join(args.outdir, name),
                  (arr * 255).astype(np.uint8))

    final_img = render(params, keys[0])
    save("inverse_target.png", target)
    save("inverse_initial.png", initial_img)
    save("inverse_recovered.png", final_img)
    print(f"saved target/initial/recovered to {args.outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
