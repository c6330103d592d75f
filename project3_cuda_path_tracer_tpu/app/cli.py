"""Headless CLI app driver.

Matches the reference's `cis565_path_tracer SCENEFILE.txt` semantics
(reference: src/main.cpp:33-76): positional scene file, progressive render to
the scene's ITERATIONS budget, save `{FILE}.{timestamp}.{N}samp.png`
(src/main.cpp:91-97) and exit. Headless by default (SURVEY §7 step 8 — the
interactive GL preview is replaced by periodic PNG snapshots).

Extensions over the reference CLI: --iterations/--depth overrides,
--sort/--compact/--no-antialias A/B toggles (the scaffold's intended
experiments, src/pathtrace.cu:313-317,366-367), --sharded multi-chip
rendering, --checkpoint-every + --resume, --hdr output, --metrics JSON lines,
--snapshot-every progressive previews (S-key analog, src/main.cpp:156-158).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="path_tracer",
        description="differentiable wavefront path tracer (JAX)")
    p.add_argument("scene", help="scene file (reference text format)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override the scene's ITERATIONS")
    p.add_argument("--depth", type=int, default=None,
                   help="override the scene's DEPTH (trace depth)")
    p.add_argument("--out", default=None,
                   help="output basename (default: scene FILE field)")
    p.add_argument("--outdir", default=".", help="output directory")
    p.add_argument("--hdr", action="store_true", help="write Radiance .hdr")
    p.add_argument("--no-antialias", action="store_true",
                   help="disable stochastic AA jitter")
    p.add_argument("--sort", action="store_true",
                   help="material-key sort paths before shading")
    p.add_argument("--compact", action="store_true",
                   help="compact terminated paths each bounce")
    p.add_argument("--russian-roulette", action="store_true",
                   help="unbiased stochastic termination from bounce 3")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (direct-light sampling): "
                        "unbiased variance reduction for diffuse scenes")
    p.add_argument("--stratified", action="store_true",
                   help="stratified sampling (per-pixel rotated "
                        "low-discrepancy camera/NEE/BSDF sequences)")
    p.add_argument("--no-bake", action="store_true",
                   help="keep scene tables as runtime arrays instead of "
                        "baking them into the compiled program as "
                        "constants (XLA folds them; disable when "
                        "mutating the scene between steps)")
    p.add_argument("--sampler", choices=("lattice", "sobol"),
                   default="lattice",
                   help="stratified-sampling implementation: lattice "
                        "(default; cheapest draws) or Owen-scrambled "
                        "sobol (best per-sample RMSE, costlier draws — "
                        "for traversal-dominated scenes)")
    p.add_argument("--nee-ris", type=int, default=0, metavar="M",
                   help="RIS direct lighting: resample one shadow ray "
                        "from M area-light candidates per bounce "
                        "(implies --nee; area-light scenes only; "
                        "unbiased)")
    p.add_argument("--restir", type=int, default=0, metavar="M",
                   help="temporal ReSTIR direct lighting: per-pixel "
                        "reservoir reused across iterations over M fresh "
                        "RIS candidates per frame (implies --nee; "
                        "area-light scenes; small documented bias — "
                        "tests/test_restir.py)")
    p.add_argument("--restir-cap", type=float, default=20.0,
                   help="temporal reservoir M-cap as a multiple of the "
                        "per-frame candidate count (default 20)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive sampling: re-allocate the per-iteration "
                        "path budget to high-variance pixels every "
                        "--adaptive-epoch iterations (host planner, "
                        "static device shapes; unbiased per-pixel means)")
    p.add_argument("--adaptive-epoch", type=int, default=32,
                   help="iterations between adaptive re-plans (default 32; "
                        "the first epoch is a uniform warmup)")
    p.add_argument("--bilinear", action="store_true",
                   help="bilinear texture/env filtering (4 corner "
                        "fetches + lerp; nearest is the default)")
    p.add_argument("--bilinear-fast", action="store_true",
                   help="with --bilinear: 2-gather RGB565 pair-plane "
                        "filtering (mag-filter atlas quality, nearest "
                        "env on the fused path) instead of the exact "
                        "4-gather form")
    p.add_argument("--clamp", type=float, default=0.0, metavar="R",
                   help="per-sample radiance clamp (firefly suppression; "
                        "biased, opt-in; pairs well with --denoise)")
    p.add_argument("--gamma", type=float, default=0.0, metavar="G",
                   help="apply 1/G display gamma to the saved PNG "
                        "(reference default: none — linear)")
    p.add_argument("--aces", action="store_true",
                   help="ACES filmic tonemap on the saved PNG "
                        "(Narkowicz 2015 fit; .hdr output stays linear)")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous wavelet denoise at save "
                        "time (Dammertz et al. 2010 — the course's own "
                        "Project-4 follow-up)")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels across all visible devices")
    p.add_argument("--preview", type=int, default=0, metavar="PORT",
                   help="serve a live HTTP preview on PORT")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                   help="write a progressive PNG every N iterations")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write a resume checkpoint every N iterations")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>.ckpt.npz if present")
    p.add_argument("--metrics", action="store_true",
                   help="emit JSON-line metrics to stderr")
    p.add_argument("--timestamp-name", action="store_true",
                   help="reference-style {FILE}.{timestamp}.{N}samp name")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN/Inf anywhere in the pipeline "
                        "(the crash-on-error posture of the reference's "
                        "checkCUDAError, src/pathtrace.cu:17-39)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    from ..scene.parser import load_scene
    from ..render.integrator import Renderer
    from ..render import checkpoint as ckpt
    from ..utils.metrics import RenderMetrics

    scene = load_scene(args.scene)
    st = scene.settings
    if args.iterations is not None:
        st.iterations = args.iterations
    if args.depth is not None:
        st.trace_depth = args.depth
    st.antialias = not args.no_antialias
    st.sort_materials = args.sort
    st.compact = args.compact
    st.russian_roulette = args.russian_roulette
    st.nee = args.nee or args.nee_ris >= 2 or args.restir >= 1
    st.nee_ris = args.nee_ris
    st.restir = args.restir
    st.restir_cap = args.restir_cap
    st.stratified = args.stratified
    st.strat_impl = args.sampler
    st.bake_scene = not args.no_bake
    st.seed = args.seed
    st.adaptive = args.adaptive
    st.adaptive_epoch = args.adaptive_epoch
    st.clamp = args.clamp
    st.bilinear = args.bilinear or args.bilinear_fast
    st.bilinear_fast = args.bilinear_fast
    if args.adaptive and (args.sort or args.compact):
        print("--adaptive is incompatible with --sort/--compact",
              file=sys.stderr)
        return 2
    if args.restir and (args.sort or args.compact or args.adaptive
                        or args.sharded):
        print("--restir is incompatible with --sort/--compact/--adaptive/"
              "--sharded (identity single-device path order required)",
              file=sys.stderr)
        return 2
    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.join(args.outdir, args.out or st.image_name)

    if args.sharded:
        from ..parallel.sharding import ShardedRenderer
        renderer = ShardedRenderer(scene)
    else:
        renderer = Renderer(scene)

    preview_srv = None
    if args.preview:
        from .preview import PreviewServer
        preview_srv = PreviewServer(renderer, port=args.preview).start()
        print(f"live preview at http://127.0.0.1:{preview_srv.port}/",
              file=sys.stderr)

    start_iter = 0
    if args.resume:
        found = ckpt.find_checkpoint(base)
        if found:
            accum, start_iter, seed = ckpt.load_checkpoint(found, args.scene)
            renderer.accum = jax.device_put(
                accum, getattr(renderer, "accum_sharding", None)) \
                if args.sharded else jax.numpy.asarray(accum)
            renderer.iteration = start_iter
            # Same RNG impl as an uninterrupted run (Renderer.__init__ uses
            # jax.random.key(seed, impl=settings.rng)) — a PRNGKey here would
            # silently switch a resumed render to a different sample stream.
            renderer.base_key = jax.random.key(seed, impl=st.rng)
            if hasattr(renderer, "restore_extras"):
                renderer.restore_extras(ckpt.load_extras(found))
            print(f"resumed from {found} at iteration {start_iter}",
                  file=sys.stderr)

    w, h = scene.camera.resolution
    metrics = RenderMetrics(width=w, height=h, trace_depth=st.trace_depth)

    print(f"rendering {args.scene}: {w}x{h}, {st.iterations} iterations, "
          f"depth {st.trace_depth}, devices={len(jax.devices())}",
          file=sys.stderr)

    metrics.start()
    done = start_iter
    while done < st.iterations:
        # advance to the next snapshot/checkpoint boundary in one call —
        # step_many scans iterations on device (dispatch-tax mitigation,
        # render/integrator.py) and is stream-identical to step()-ing
        nxt = st.iterations
        if args.snapshot_every:
            nxt = min(nxt, (done // args.snapshot_every + 1)
                      * args.snapshot_every)
        if args.checkpoint_every:
            nxt = min(nxt, (done // args.checkpoint_every + 1)
                      * args.checkpoint_every)
        renderer.step_many(nxt - done)
        done = nxt
        if args.snapshot_every and done % args.snapshot_every == 0:
            renderer.accum.block_until_ready()
            metrics.stop(done - start_iter - metrics._iters)
            out = renderer.save(f"{base}.snap{done}")
            print(f"[{done}/{st.iterations}] snapshot {out}",
                  file=sys.stderr)
            if args.metrics:
                metrics.emit(iteration=done)
            metrics.start()
        if args.checkpoint_every and done % args.checkpoint_every == 0:
            renderer.accum.block_until_ready()
            ckpt.save_checkpoint(base + ".ckpt.npz",
                                 np.asarray(jax.device_get(renderer.accum)),
                                 done, args.seed, args.scene,
                                 extras=(renderer.checkpoint_extras()
                                         if hasattr(renderer,
                                                    "checkpoint_extras")
                                         else None))
    renderer.accum.block_until_ready()
    if metrics._t0 is not None:
        metrics.stop(st.iterations - start_iter - metrics._iters)

    if args.timestamp_name:
        # {FILE}.{timestamp}.{N}samp (reference: src/main.cpp:91-97)
        ts = time.strftime("%Y-%m-%d_%H-%M-%SZ", time.gmtime())
        out_base = f"{base}.{ts}.{renderer.iteration}samp"
    else:
        out_base = base
    out = renderer.save(out_base, hdr=args.hdr, denoise=args.denoise,
                        gamma=args.gamma, aces=args.aces)
    print(f"saved {out}", file=sys.stderr)
    if args.metrics:
        metrics.emit(final=True, output=out)
    if preview_srv is not None:
        preview_srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
