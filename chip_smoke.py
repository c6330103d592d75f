#!/usr/bin/env python3
"""Smoke test of the path tracer on an NVIDIA GPU, in one process.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the data-parallel path only

Each phase prints one JSON line; the last line of standard output is
`{"ok": true, "device": {...}}`, printed only when every phase passed. A
failed phase raises: the script then exits non-zero without that line. It
refuses to run where JAX finds no GPU.

One-card phases:
  device   platform, device kind and count, and the card's name and power
           limit from nvidia-smi;
  build    the CUDA library from native/src (set-up time);
  forward  Cornell 800x800 depth 8 through Renderer (ms/iter, compile) and
           through the CLI; the image against the same program on the CPU
           backend, and the 64x64 8-spp seed-123 render against the
           committed golden; planar stages against the row-form oracles;
  train    the scanned train step at 800x800 depth 8 under both bounce
           schedules (ms/step, peak memory, finite losses); gradients at
           128x128 against the CPU backend;
  mesh     the CUDA traversal against the plain walk and brute force on a
           full 1024x1024 wavefront; mesh.txt and textured_env_proc.txt
           ms/iter through the kernel and through the plain walk; one
           textured_env 2048x2048 iteration; one finite mesh gradient;
  gpu_tests  pytest -m gpu: the repository's card-only tests;
  sweep    every scenes/*.txt for 2 iterations at its own resolution and
           depth, with the modes each scene exists to exercise.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")

# ---------------------------------------------------------------- tolerances
# Block-mean z bound for two independent Monte Carlo images of one scene:
# each block's mean difference over its standard error, the standard error
# taken from the per-pixel spread inside the block (an upper bound on the
# noise, since scene content also varies inside a block). At 5 sigma a
# correct renderer fails a 400-block image with probability ~2e-4.
Z_MAX = 5.0
BLOCK = 40
# Traversal: the kernel and the walk visit nodes in different orders, so
# only exact-distance ties (grazing hits on shared edges) may pick
# different triangles.
TRI_MISMATCH_MAX = 1e-4
# Distance agreement where the triangle agrees: float32 Moller-Trumbore on
# O(1) object coordinates, evaluated with and without fused multiply-adds,
# differs by a few ulps of the operands — 1e-5 relative for t >= 1, and
# 1e-5 absolute below (first-bounce rays start on the surface, where t is
# tiny and a relative bound would measure cancellation, not error).
T_TOL = 1e-5
# Gradients GPU vs CPU at 128x128: both backends draw the same threefry
# stream, so only rounding order differs, plus the grazing paths it flips;
# relative L2 over the whole gradient pytree.
GRAD_RTOL = 2e-2
# Planar stages vs row oracles: the same float32 math in another layout and
# fusion. Max over 640k rays of unit vectors and O(1)-relative distances;
# rounding through the per-geom transforms stays near 1e-5, a wrong formula
# is off by O(1).
STAGE_ATOL = 1e-3
# A ray that meets a box edge, or the crease where two boxes meet, has two
# equally right answers (hit or miss; this wall or that one), and the two
# forms break such ties differently: in Cornell 800^2 a whole pinhole pixel
# row lines up with the ceiling's front edge. A hit or material flip counts
# as a tie when the hit point of either form lies on two or more box faces
# within EDGE_TOL world units (t is the distance to the point backed off
# 1e-4 object units, up to 1e-3 world on the 10-unit walls). Flips that are
# not ties are wrong answers: at most STAGE_FLIP_MAX of the rays.
EDGE_TOL = 2e-3
STAGE_FLIP_MAX = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def block_z(a, b, block=None):
    """Max |z| of block-mean differences between two [H,W,3] mean images,
    with the per-block standard error from the pixel spread in each."""
    import numpy as np
    block = block or BLOCK
    h, w, _ = a.shape
    hb, wb = h // block, w // block

    def blocks(x):
        x = x[:hb * block, :wb * block].mean(-1)
        return x.reshape(hb, block, wb, block).transpose(0, 2, 1, 3) \
            .reshape(hb, wb, block * block)

    ba, bb = blocks(a), blocks(b)
    n = block * block
    se = np.sqrt(ba.var(-1) / n + bb.var(-1) / n) + 1e-12
    z = np.abs(ba.mean(-1) - bb.mean(-1)) / se
    return float(z.max()), hb * wb


def synced(fn, *args):
    """(result, seconds) of fn(*args) through jax.block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def time_render(renderer, iters: int):
    """(compile+first-run seconds, steady ms/iter): one warm-up call of
    the same chunk size, then a timed one."""
    _, first = synced(lambda: renderer.step_many(iters) or renderer.accum)
    _, dt = synced(lambda: renderer.step_many(iters) or renderer.accum)
    return first, dt / iters * 1e3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------- phases

def phase_device(expected: int):
    import jax
    dev = jax.devices()
    if dev[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (JAX platform "
                         f"{dev[0].platform!r}); refusing to run\n")
        raise SystemExit(2)
    if len(dev) < expected:
        raise SystemExit(f"chip_smoke: needs {expected} GPUs, found "
                         f"{len(dev)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no output", flush=True)
    emit("device", platform=dev[0].platform, kind=dev[0].device_kind,
         count=len(dev), nvidia_smi=card)
    return dev


def phase_build():
    from project3_cuda_path_tracer_tpu.ops import bvh8
    from project3_cuda_path_tracer_tpu.utils import native
    t0 = time.perf_counter()
    path = native.cuda_library()
    bvh8.register_cuda_targets()
    emit("build", library=os.path.relpath(path, REPO),
         setup_s=time.perf_counter() - t0)


def _load(path, res=None, depth=None):
    from project3_cuda_path_tracer_tpu import load_scene
    s = load_scene(os.path.join(REPO, path))
    if res is not None:
        s.camera.resolution = res
        s.camera.derive()
    if depth is not None:
        s.settings.trace_depth = depth
    return s


def phase_forward(cpu):
    import jax
    import numpy as np
    from project3_cuda_path_tracer_tpu.app import cli
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer

    s = _load("scenes/cornell.txt")
    w, h = s.camera.resolution
    r = Renderer(s)
    compile_s, ms = time_render(r, 32)
    img = r.image()
    check(np.isfinite(img).all() and img.mean() > 0.01, "cornell image")

    # Same program on the CPU backend at matched spp, independent seeds.
    spp = 4
    g = Renderer(_load("scenes/cornell.txt"))
    g.render(spp, seed=11)
    with jax.default_device(cpu):
        c = Renderer(_load("scenes/cornell.txt"))
        c.render(spp, seed=12)
        img_cpu = c.image()
    z_cpu, nblocks = block_z(g.image(), img_cpu)

    # The committed 64x64 8-spp seed-123 golden (statistically: its RNG
    # stream came from another backend).
    gold = np.load(os.path.join(REPO, "tests",
                                "golden_cornell_64x64_8spp_seed123.npz"))
    s64 = _load("scenes/cornell.txt", res=(64, 64))
    r64 = Renderer(s64)
    r64.render(8, seed=123)
    z_gold, _ = block_z(np.asarray(r64.accum) / 8.0,
                        np.asarray(gold["accum"]) / 8.0, block=8)

    # The user's entry point, in this process.
    rc = cli.main([os.path.join(REPO, "scenes/cornell.txt"),
                   "--iterations", "4", "--outdir", OUT_DIR,
                   "--out", "cornell_cli"])
    check(rc == 0 and os.path.exists(os.path.join(OUT_DIR,
                                                  "cornell_cli.png")),
          "CLI render")
    emit("forward", scene="cornell", res=[w, h],
         depth=s.settings.trace_depth, ms_per_iter=ms,
         compile_and_first_s=compile_s,
         cpu_block_z_max=z_cpu, blocks=nblocks, spp=spp,
         golden64_block_z_max=z_gold, z_bound=Z_MAX)
    check(z_cpu <= Z_MAX, f"cornell GPU vs CPU block z {z_cpu}")
    check(z_gold <= Z_MAX, f"cornell 64x64 vs golden block z {z_gold}")
    phase_stages()


def phase_stages():
    """Ray generation, intersection and shading in planar form against
    the row-form oracles (ops/camera, ops/intersect, ops/bsdf) on the
    800x800 Cornell primary wavefront."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from project3_cuda_path_tracer_tpu.ops import bsdf, camera, vec
    from project3_cuda_path_tracer_tpu.ops import intersect as isect
    from project3_cuda_path_tracer_tpu.ops import wavefront as wf

    s = _load("scenes/cornell.txt")
    w, h = s.camera.resolution
    n = w * h
    cam = s.camera.flat()
    gt = tuple(int(t) for t in np.asarray(s.geoms.type))
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(jax.random.PRNGKey(9), (n, 4))
    thr = jnp.full((n, 3), 0.7, jnp.float32)
    alive = jnp.ones((n,), bool)
    last = jnp.zeros((n,), bool)

    @jax.jit
    def planar():
        o, d, t, _ = wf.generate_rays_planar(cam, w, h, key,
                                             antialias=False)
        hit = wf.intersect_planar(o, d, t, s.geoms, s.meshes, gt)
        out = wf.shade_planar(hit, d, vec.from_rows(thr), alive,
                              s.materials, s.textures, u.T, last)
        return (vec.to_rows(d), hit.t, hit.mat_id, vec.to_rows(hit.normal),
                vec.to_rows(out.radiance), vec.to_rows(out.throughput),
                vec.to_rows(out.direction), out.alive, vec.to_rows(o))

    @jax.jit
    def rows():
        o, d, t = camera.generate_rays(cam, w, h, key, antialias=False)
        hit = isect.intersect_scene(o, d, t, s.geoms, s.meshes, ())
        out = bsdf.shade(hit, d, thr, alive, s.materials, s.textures, u,
                         last)
        return (d, hit.t, hit.mat_id, hit.normal, out.radiance,
                out.throughput, out.direction, out.alive)

    p, r = map(lambda x: [np.asarray(a) for a in x], (planar(), rows()))
    same = (p[2] == r[2]) & ((p[1] > 0) == (r[1] > 0))
    flip = np.nonzero(~same)[0]
    ties = np.zeros(flip.size, bool)
    for t in (p[1][flip], r[1][flip]):
        ties |= (t > 0) & (_box_faces_at(s.geoms, p[8][flip] + t[:, None]
                                         * p[0][flip]) >= 2)
    live = same & r[7] & p[7]
    hit = same & (r[1] > 0)
    err = {
        "raygen_dir": float(np.abs(p[0] - r[0]).max()),
        "t": float((np.abs(p[1] - r[1]) / np.maximum(np.abs(r[1]), 1.0)
                    )[same].max()),
        "normal": float(np.abs(p[3] - r[3])[hit].max()),
        "radiance": float(np.abs(p[4] - r[4])[same].max()),
        "throughput": float(np.abs(p[5] - r[5])[same].max()),
        "scatter_dir": float(np.abs(p[6] - r[6])[live].max()),
    }
    wrong = float((~ties).sum() / n)
    emit("stages", res=[w, h], max_abs_err=err, tol=STAGE_ATOL,
         hit_or_material_flips=int(flip.size), edge_ties=int(ties.sum()),
         non_tie_flip_frac=wrong, flip_max=STAGE_FLIP_MAX,
         edge_tol=EDGE_TOL)
    check(wrong <= STAGE_FLIP_MAX, f"planar vs row non-tie flips {wrong}")
    for k, v in err.items():
        check(v <= STAGE_ATOL, f"planar {k} vs row oracle: {v}")


def _box_faces_at(geoms, pts):
    """For world points [K,3]: how many faces of the scene's boxes each
    lies on, within EDGE_TOL world units."""
    import numpy as np
    from project3_cuda_path_tracer_tpu.scene import types as T
    ph = np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], 1)
    inv = np.asarray(geoms.inverse_transform)
    fwd = np.asarray(geoms.transform)
    faces = np.zeros(pts.shape[0], int)
    for g in np.nonzero(np.asarray(geoms.type) == T.CUBE)[0]:
        q = np.abs((ph @ inv[g].T)[:, :3])
        tol = EDGE_TOL / np.linalg.norm(fwd[g][:3, :3], axis=0)
        inside = (q <= 0.5 + tol).all(1)
        faces += np.where(inside, (np.abs(q - 0.5) <= tol).sum(1), 0)
    return faces


def _train_cfg(s, schedule):
    import numpy as np
    from project3_cuda_path_tracer_tpu.render.integrator import TraceConfig
    w, h = s.camera.resolution
    return TraceConfig(width=w, height=h, trace_depth=s.settings.trace_depth,
                       antialias=True,
                       geom_types=tuple(int(t) for t in
                                        np.asarray(s.geoms.type)),
                       glossy=False, sky=False,
                       unroll=(schedule == "unroll"),
                       remat=(schedule == "scan"))


def phase_train(cpu):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, make_seed_history, make_train_scan)

    steps = 10
    s = _load("scenes/cornell.txt")
    w, h = s.camera.resolution
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((h, w, 3), jnp.float32)
    dev = jax.devices()[0]
    out = {}
    for schedule in ("unroll", "scan"):
        cfg = _train_cfg(s, schedule)
        opt, run = make_train_scan(s.geoms, s.meshes, s.textures, cfg,
                                   num_steps=steps, history=True)
        params = jax.tree_util.tree_map(
            jnp.array, RenderParams(materials=s.materials,
                                    cam=s.camera.flat()))
        opt_state = opt.init(params)
        hist = make_seed_history(s.geoms, s.meshes, s.textures, cfg)(
            params, jax.random.fold_in(key, 999))
        (params, opt_state, hist, losses), first = synced(
            run, params, opt_state, hist, key, target)
        (params, opt_state, hist, losses), dt = synced(
            run, params, opt_state, hist, jax.random.fold_in(key, 1),
            target)
        check(bool(np.isfinite(np.asarray(losses)).all()),
              f"{schedule}: non-finite loss")
        stats = dev.memory_stats() or {}
        out[schedule] = {"ms_per_step": dt / steps * 1e3,
                         "compile_and_first_s": first,
                         "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    rel = _grad_vs_cpu(cpu)
    emit("train", scene="cornell", res=[w, h],
         depth=s.settings.trace_depth, steps_per_epoch=steps,
         schedules=out, grad128_rel_l2_vs_cpu=rel, grad_rtol=GRAD_RTOL,
         note="peak_bytes_in_use is the process peak so far")
    check(rel <= GRAD_RTOL, f"128x128 gradients vs CPU: {rel}")


def _grad_vs_cpu(cpu) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, history_residual_grad_loss)

    s = _load("scenes/cornell.txt", res=(128, 128))
    cfg = _train_cfg(s, "scan")
    target = jnp.full((128, 128, 3), 0.3, jnp.float32)
    residual = jnp.linspace(0.0, 1.0, 128 * 128 * 3).reshape(128, 128, 3)
    args = (RenderParams(materials=s.materials, cam=s.camera.flat()),
            s.geoms, s.meshes, s.textures, target, residual)

    def lf(p, geoms, meshes, textures, target, residual):
        return history_residual_grad_loss(
            p, geoms, meshes, textures, jax.random.PRNGKey(6), cfg,
            target, residual)[0]

    grad = jax.jit(jax.grad(lf))
    g_gpu = grad(*jax.device_put(args, jax.devices()[0]))
    g_cpu = grad(*jax.device_put(args, cpu))
    a = np.concatenate([np.ravel(x) for x in
                        jax.tree_util.tree_leaves(g_gpu)])
    b = np.concatenate([np.ravel(x) for x in
                        jax.tree_util.tree_leaves(g_cpu)])
    check(np.isfinite(a).all(), "non-finite GPU gradient")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@contextlib.contextmanager
def plain_walk():
    """Route mesh traversal through the plain XLA walk on the GPU too (a
    measurement only: the program's own choice is the kernel). Clears
    JAX's caches on entry and exit so neither variant reuses the other's
    compiled programs."""
    import jax
    from project3_cuda_path_tracer_tpu.ops import bvh8

    def walk(qo, qd, t_bound, packed, meshes, mesh_index, any_hit=False,
             mesh=None):
        return bvh8.traverse_walk(qo, qd, t_bound, packed, meshes,
                                  mesh_index)

    jax.clear_caches()
    with mock.patch.object(bvh8, "traverse", walk):
        yield
    jax.clear_caches()


def phase_mesh():
    import jax
    import numpy as np
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, mse_loss)
    from project3_cuda_path_tracer_tpu.render.integrator import (
        Renderer, TraceConfig)

    trav = _traversal_check()

    timings = {}
    for path, iters in (("scenes/mesh.txt", 8),
                        ("scenes/textured_env_proc.txt", 2)):
        name = os.path.basename(path)
        s = _load(path)
        r = Renderer(s)
        first, ms = time_render(r, iters)
        img_k = r.image()
        with plain_walk():
            rw = Renderer(_load(path))
            first_w, ms_w = time_render(rw, max(1, iters // 4))
            img_w = rw.image()
        check(np.isfinite(img_k).all() and np.isfinite(img_w).all(),
              f"{name} image")
        timings[name] = {"res": list(s.camera.resolution),
                         "depth": s.settings.trace_depth,
                         "cuda_ms_per_iter": ms,
                         "cuda_compile_and_first_s": first,
                         "walk_ms_per_iter": ms_w,
                         "walk_compile_and_first_s": first_w}

    s = _load("scenes/textured_env.txt")
    r = Renderer(s)
    _, t_env = synced(lambda: r.step_many(1) or r.accum)
    img = r.image()
    check(np.isfinite(img).all() and img.mean() > 0, "textured_env image")

    # One mesh gradient (differentiable hit attributes from the detached
    # winning triangle, ops/wavefront._mesh_hit).
    s = _load("scenes/mesh.txt")
    w, h = s.camera.resolution
    types = np.asarray(s.geoms.type)
    cfg = TraceConfig(width=w, height=h, trace_depth=s.settings.trace_depth,
                      geom_types=tuple(int(t) for t in types),
                      mesh_ids=tuple(int(m) for m in
                                     np.asarray(s.geoms.mesh_id)),
                      differentiable_mesh=True)
    params = RenderParams(materials=s.materials, cam=s.camera.flat())
    target = jax.numpy.full((h, w, 3), 0.2, jax.numpy.float32)
    grads, t_grad = synced(jax.jit(jax.grad(
        lambda p: mse_loss(p, s.geoms, s.meshes, s.textures,
                           jax.random.PRNGKey(0), cfg, target,
                           s.packed_meshes))), params)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]
    check(all(np.isfinite(x).all() for x in leaves), "mesh gradient")
    check(any(np.abs(x).max() > 0 for x in leaves), "mesh gradient is zero")

    emit("mesh", traversal=trav, ms_per_iter=timings,
         textured_env_2048_first_iter_s=t_env,
         mesh_grad_res=[w, h], mesh_grad_compile_and_run_s=t_grad)
    for name, t in timings.items():
        check(t["cuda_ms_per_iter"] < t["walk_ms_per_iter"],
              f"{name}: the CUDA kernel is slower than the plain walk")


def _traversal_check():
    """Kernel vs plain walk vs brute force on the full mesh.txt wavefront:
    primary rays, and first-bounce rays from the primary hits."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from project3_cuda_path_tracer_tpu.ops import bvh8, vec
    from project3_cuda_path_tracer_tpu.ops import wavefront as wf
    from project3_cuda_path_tracer_tpu.scene import types as T

    s = _load("scenes/mesh.txt")
    w, h = s.camera.resolution
    g = [i for i, t in enumerate(np.asarray(s.geoms.type))
         if int(t) == T.MESH][0]
    mid = int(np.asarray(s.geoms.mesh_id)[g])
    packed = s.packed_meshes[mid]
    n = w * h

    @jax.jit
    def primary(cam):
        o, d, _, _ = wf.generate_rays_planar(cam, w, h,
                                             jax.random.PRNGKey(0),
                                             antialias=False)
        inv = s.geoms.inverse_transform[g]
        qo = vec.xform_pt(inv, o)
        qd = vec.normalize(vec.xform_dir(inv, d))
        return tuple(qo), tuple(qd)

    kern = jax.jit(lambda a, b, c: bvh8.traverse_cuda(a, b, c, packed))
    anyk = jax.jit(lambda a, b, c: bvh8.traverse_cuda(a, b, c, packed,
                                                      any_hit=True))
    walk = jax.jit(lambda a, b, c: bvh8.traverse_walk(a, b, c, packed,
                                                      s.meshes, mid))
    rng = np.random.default_rng(0)
    report = {}

    def compare(name, qo, qd, tb):
        (tk, _, _, _, trik), ms_k = synced(kern, qo, qd, tb)
        (tw, _, _, _, triw), ms_w = synced(walk, qo, qd, tb)
        tk, trik, tw, triw = map(np.asarray, (tk, trik, tw, triw))
        same = trik == triw
        agree = same & (trik >= 0)
        dt = np.abs(tk[agree] - tw[agree])
        t_err = float(np.max(dt / np.maximum(tw[agree], 1.0), initial=0))
        # any-hit with random bounds: occluded iff the nearest hit is
        # closer than the bound
        tbn = np.asarray(tb)
        bound = np.where(tbn <= 0, tbn,
                         np.where(trik >= 0, tk * rng.uniform(0.0, 2.0, n),
                                  1e30)).astype(np.float32)
        ta, _, _, _, tria = anyk(qo, qd, jnp.asarray(bound))
        occl = np.asarray(tria) >= 0
        want = (trik >= 0) & (tk < bound)
        bf = _brute_force_check(qo, qd, tb, trik, tk, packed, rng)
        report[name] = {"rays": n, "hits": int((trik >= 0).sum()),
                        "tri_mismatch_frac": float((~same).mean()),
                        "t_err_max": t_err,
                        "anyhit_mismatch": int((occl != want).sum()),
                        "brute_force": bf,
                        "first_call_s": {"cuda": ms_k, "walk": ms_w}}
        check(report[name]["hits"] > 1000, f"{name}: too few hits")
        check((~same).mean() <= TRI_MISMATCH_MAX, f"{name}: triangles")
        check(t_err <= T_TOL, f"{name}: t error {t_err}")
        check(report[name]["anyhit_mismatch"] == 0, f"{name}: any-hit")
        check(bf["tri_mismatch_frac"] <= 1e-3 and bf["t_err_max"] <= T_TOL,
              f"{name}: brute force {bf}")
        return tk, trik

    qo, qd = primary(s.camera.flat())
    big = jnp.full((n,), 1e30, jnp.float32)
    tk, trik = compare("primary", qo, qd, big)
    # first bounce: random directions from the primary hit points
    hit = jnp.asarray(trik >= 0)
    dirs = jax.random.normal(jax.random.PRNGKey(1), (3, n))
    dirs = dirs / jnp.linalg.norm(dirs, axis=0)
    t0 = jnp.where(hit, jnp.asarray(tk), 0.0) - 1e-4
    qo2 = tuple(qo[i] + t0 * qd[i] for i in range(3))
    compare("bounce1", qo2, tuple(dirs[i] for i in range(3)),
            jnp.where(hit, 1e30, -1.0).astype(jnp.float32))
    report["tolerances"] = {"tri_mismatch_max": TRI_MISMATCH_MAX,
                            "t_tol": T_TOL}
    return report


def _brute_force_check(qo, qd, tb, trik, tk, packed, rng, m: int = 4096):
    """Exhaustive Moller-Trumbore over every triangle for `m` rays (half
    of them kernel hits), against the kernel's winners."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    tbn = np.asarray(tb)
    live = np.nonzero(tbn > 0)[0]
    hits = np.intersect1d(np.nonzero(trik >= 0)[0], live)
    pick = np.concatenate([
        rng.choice(hits, min(m // 2, hits.size), replace=False),
        rng.choice(live, min(m // 2, live.size), replace=False)])
    o = jnp.stack([q[pick] for q in qo], -1)
    d = jnp.stack([q[pick] for q in qd], -1)
    tris = packed.tris

    @jax.jit
    def brute(o, d):
        v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]

        def one(od):
            oi, di = od
            p = jnp.cross(di[None, :], e2)
            det = jnp.sum(e1 * p, -1)
            ok = jnp.abs(det) > 1e-12
            inv = jnp.where(ok, 1.0 / det, 0.0)
            tv = oi[None, :] - v0
            u = jnp.sum(tv * p, -1) * inv
            q = jnp.cross(tv, e1)
            v = jnp.sum(di[None, :] * q, -1) * inv
            t = jnp.sum(e2 * q, -1) * inv
            good = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
            t = jnp.where(good, t, jnp.inf)
            k = jnp.argmin(t)
            return t[k], jnp.where(jnp.isfinite(t[k]), k, -1)

        return jax.lax.map(one, (o, d), batch_size=256)

    t_ref, tri_ref = map(np.asarray, brute(o, d))
    tri_k, t_k = trik[pick], np.asarray(tk)[pick]
    agree = (tri_k == tri_ref) & (tri_ref >= 0)
    err = np.abs(t_k[agree] - t_ref[agree]) / np.maximum(t_ref[agree], 1.0)
    return {"rays": int(pick.size), "hits": int((tri_ref >= 0).sum()),
            "tri_mismatch_frac": float((tri_k != tri_ref).mean()),
            "t_err_max": float(err.max(initial=0))}


def phase_gpu_tests():
    """The repository's card-only tests (the `gpu` marker), run by pytest
    in this process (a second process could not reserve the card)."""
    import pytest

    class Passed:
        n = 0

        def pytest_runtest_logreport(self, report):
            self.n += report.when == "call" and report.passed

    passed = Passed()
    os.environ["PT_TESTS_ON_GPU"] = "1"
    rc = int(pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")], plugins=[passed]))
    emit("gpu_tests", marker="gpu", pytest_exit_code=rc, passed=passed.n)
    check(rc == 0 and passed.n > 0, f"pytest -m gpu: exit {rc}, "
          f"{passed.n} passed (a skip on the card is a failure)")


# Every scene, with the modes it exists to exercise.
SWEEP = (
    ("cornell.txt", {}),
    ("cornell_dof.txt", {"adaptive": True, "adaptive_epoch": 1}),
    ("cornell_glass.txt", {}),
    ("cornell_glossy.txt", {"stratified": True}),
    ("dispersion.txt", {}),
    ("lights.txt", {"nee": True, "restir": 4}),
    ("manylights.txt", {"nee": True}),
    ("manylights256.txt", {"nee": True, "nee_ris": 4}),
    ("manylights_glossy.txt", {"nee": True}),
    ("mesh.txt", {"nee": True}),
    ("sdf.txt", {}),
    ("sphere.txt", {}),
    ("textured_env.txt", {"bilinear": True}),
    ("textured_env_proc.txt", {"bilinear": True, "bilinear_fast": True}),
)


def phase_sweep():
    import numpy as np
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer
    from project3_cuda_path_tracer_tpu.utils import image as img_io
    listed = sorted(f for f in os.listdir(os.path.join(REPO, "scenes"))
                    if f.endswith(".txt"))
    check(listed == sorted(n for n, _ in SWEEP),
          f"scenes/ and the sweep list differ: {listed}")
    rows = []
    for name, modes in SWEEP:
        s = _load(os.path.join("scenes", name))
        for k, v in modes.items():
            setattr(s.settings, k, v)
        r = Renderer(s)
        _, sec = synced(lambda: r.step_many(2) or r.accum)
        img = r.image()
        ok = bool(np.isfinite(img).all() and img.mean() > 1e-4)
        row = {"scene": name, "modes": modes,
               "res": list(s.camera.resolution),
               "depth": s.settings.trace_depth,
               "first_2_iters_s": sec, "mean": float(img.mean()),
               "finite_nonblack": ok}
        if name == "cornell.txt":
            out = r.save(os.path.join(OUT_DIR, "cornell_denoised"),
                         denoise=True)
            den = img_io.read_png(out)
            row["denoised_mean"] = float(den.mean())
            ok = ok and den.mean() > 1e-3
        rows.append(row)
        check(ok, f"{name}: non-finite or black image ({row})")
    emit("sweep", scenes=rows)


def phase_four(devices):
    """ShardedRenderer over four cards against one card: Cornell 800x800
    depth 8 forward (block means), the sharded history train step
    (gradients), and a sharded mesh render whose traversal runs per shard
    (no all-gather of ray planes in the compiled program)."""
    import jax
    import numpy as np
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        ShardedRenderer, make_mesh)
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer

    mesh = make_mesh(devices=devices[:4])
    s = _load("scenes/cornell.txt")
    sh = ShardedRenderer(s, mesh=mesh)
    first, ms = time_render(sh, 32)
    one = Renderer(_load("scenes/cornell.txt"))
    one_first, one_ms = time_render(one, 32)
    z, nblocks = block_z(sh.image(), one.image())
    rel = _sharded_grad_rel(mesh)
    hlo_gathers = _sharded_mesh_check(mesh)
    emit("four", devices=len(mesh.devices.flat), scene="cornell",
         res=list(s.camera.resolution), depth=s.settings.trace_depth,
         ms_per_iter_4=ms, ms_per_iter_1=one_ms,
         compile_and_first_s_4=first, compile_and_first_s_1=one_first,
         block_z_max_vs_1=z, blocks=nblocks, z_bound=Z_MAX,
         grad_rel_l2_vs_1=rel, grad_rtol=GRAD_RTOL,
         mesh_traversal_allgathers=hlo_gathers)
    check(z <= Z_MAX, f"sharded vs one-card block z {z}")
    check(rel <= GRAD_RTOL, f"sharded vs one-card gradients {rel}")
    check(hlo_gathers == 0, "ray planes all-gathered around the traversal")


def _sharded_grad_rel(mesh) -> float:
    """History-residual train-step gradients at 800x800 depth 8: sharded
    over `mesh` against one device, same key (so the same paths)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from project3_cuda_path_tracer_tpu.models.inverse import (
        RenderParams, history_residual_grad_loss)

    s = _load("scenes/cornell.txt")
    w, h = s.camera.resolution
    base = _train_cfg(s, "scan")
    params = RenderParams(materials=s.materials, cam=s.camera.flat())
    target = jnp.full((h, w, 3), 0.3, jnp.float32)
    residual = jnp.linspace(0.0, 1.0, h * w * 3).reshape(h, w, 3)

    def grads(cfg, rep, row):
        p = jax.device_put(params, rep)

        def lf(p, target, residual):
            return history_residual_grad_loss(
                p, s.geoms, s.meshes, s.textures, jax.random.PRNGKey(6),
                cfg, target, residual)[0]
        g = jax.jit(jax.grad(lf))(p, jax.device_put(target, row),
                                  jax.device_put(residual, row))
        return np.concatenate([np.ravel(np.asarray(x)) for x in
                               jax.tree_util.tree_leaves(g)])

    d0 = jax.devices()[0]
    g1 = grads(base, d0, d0)
    cfg4 = dataclasses.replace(base, ray_sharding=NamedSharding(
        mesh, P("data")))
    g4 = grads(cfg4, NamedSharding(mesh, P()),
               NamedSharding(mesh, P("data", None, None)))
    return float(np.linalg.norm(g4 - g1) / max(np.linalg.norm(g1), 1e-30))


def _sharded_mesh_check(mesh) -> int:
    """Render mesh.txt sharded for 2 iterations (finite, non-black), and
    count the all-gathers in the compiled sharded traversal of its
    wavefront (ray planes must stay sharded around the foreign call)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from project3_cuda_path_tracer_tpu.ops import bvh8
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        ShardedRenderer)

    s = _load("scenes/mesh.txt")
    sh = ShardedRenderer(s, mesh=mesh)
    sh.step_many(2)
    img = sh.image()
    check(np.isfinite(img).all() and img.mean() > 0, "sharded mesh image")
    w, h = s.camera.resolution
    rays = NamedSharding(mesh, P("data"))
    plane = jax.device_put(jnp.ones((w * h,), jnp.float32), rays)
    packed = s.packed_meshes[0]
    f = jax.jit(lambda qo, qd, tb: bvh8.traverse(
        qo, qd, tb, packed, s.meshes, 0, mesh=mesh))
    hlo = f.lower((plane,) * 3, (plane,) * 3, plane).compile().as_text()
    return sum("all-gather" in ln for ln in hlo.splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: the data-parallel path and its "
                         "comparison with one card, nothing else")
    args = ap.parse_args(argv)

    import jax
    from project3_cuda_path_tracer_tpu.utils.compile_cache import (
        enable_compile_cache)
    devices = phase_device(4 if args.four else 1)
    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    phase_build()
    cpu = jax.devices("cpu")[0]
    if args.four:
        phase_four(devices)
    else:
        phase_forward(cpu)
        phase_train(cpu)
        phase_mesh()
        phase_gpu_tests()
        phase_sweep()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
