"""Adaptive sampling: variance-driven per-pixel sample reallocation.

A classic completed-project extension of the reference scaffold (the
scaffold's fixed one-path-per-pixel iteration is the reference baseline:
src/pathtrace.cu:122-143 one thread per pixel). Static-shape design — no
dynamic shapes, no device sorts:

  * every iteration still traces exactly W*H paths (static shapes), but
    path i shoots at pixel `pix[i]` from a host-planned mapping;
  * the planner runs on HOST once per epoch (numpy): relative-error image
    from (accum, accum2, count), largest-remainder apportionment of the
    W*H path budget, then `pix = repeat(arange, n_i)` — the device never
    sees a sort/searchsorted;
  * per-pixel sample counts come from `bincount(pix)` on host — zero
    device work;
  * per-path stratified sample streams are keyed on the surrogate
    `pix + occurrence * npix` so co-located paths draw distinct samples
    (ops/wavefront.generate_rays_planar strat_index).

Estimator: accum[p] = sum of samples, count[p] = how many; the display
image is accum/count. Each sample is an unbiased radiance estimate and
the allocation depends only on PAST samples, so the per-pixel mean stays
unbiased (sequential-sampling argument).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import integrator as I

# Rec.709 luma weights for the error metric
_LW = (0.2126, 0.7152, 0.0722)


def render_radiance_adaptive(materials, cam, geoms, meshes, textures, key,
                             cfg, packed_meshes=(), iteration=None,
                             pix_override=None, samp_index=None):
    """One adaptive iteration -> (radiance image [H,W,3], lum^2 image
    [H,W]). Differentiable in (materials, cam) like render_radiance."""
    rad, pix = I.trace_wavefront(materials, cam, geoms, meshes, textures,
                                 key, cfg, packed_meshes=packed_meshes,
                                 iteration=iteration,
                                 pix_override=pix_override,
                                 samp_index=samp_index)
    n = cfg.width * cfg.height
    zero = jnp.zeros((n,), jnp.float32)
    # host-planned indices are always in range; promise_in_bounds skips
    # XLA's per-element oob handling
    sc = lambda v: zero.at[pix].add(v, mode="promise_in_bounds")
    img = jnp.stack([sc(rad.x), sc(rad.y), sc(rad.z)],
                    axis=-1).reshape(cfg.height, cfg.width, 3)
    lum = _LW[0] * rad.x + _LW[1] * rad.y + _LW[2] * rad.z
    lum2 = sc(lum * lum).reshape(cfg.height, cfg.width)
    return img, lum2


def chunk_body(materials, cam, geoms, meshes, textures, base_key,
               start_iter, cfg, chunk, packed_meshes, pix, surr):
    """Scan `chunk` adaptive iterations under ONE fixed mapping,
    accumulating in PATH space; ONE set of scatters at the end.

    A scatter-add without provably unique indices serializes (it was
    the dominant per-iteration cost on the previous accelerator; an H100
    cell measures it again). The mapping is constant within an epoch, so
    path-space sums commute with the scatter and the cost divides by the
    chunk length.
    Returns (radiance image sum [H,W,3], lum^2 image sum [H,W])."""
    n = cfg.width * cfg.height
    zero = jnp.zeros((n,), jnp.float32)

    def one(carry, i):
        px, py, pz, pl = carry
        key = jax.random.fold_in(base_key, start_iter + i)
        rad, _ = I.trace_wavefront(
            materials, cam, geoms, meshes, textures, key, cfg,
            packed_meshes=packed_meshes, iteration=start_iter + i,
            pix_override=pix, samp_index=surr)
        lum = _LW[0] * rad.x + _LW[1] * rad.y + _LW[2] * rad.z
        return (px + rad.x, py + rad.y, pz + rad.z, pl + lum * lum), None

    (px, py, pz, pl), _ = jax.lax.scan(
        one, (zero, zero, zero, zero), jnp.arange(chunk, dtype=jnp.int32))
    sc = lambda v: zero.at[pix].add(v)
    img = jnp.stack([sc(px), sc(py), sc(pz)],
                    axis=-1).reshape(cfg.height, cfg.width, 3)
    lum2 = sc(pl).reshape(cfg.height, cfg.width)
    return img, lum2


@partial(jax.jit, static_argnames=("cfg", "chunk"),
         donate_argnames=("accum", "accum2", "countd"))
def adaptive_chunk(accum, accum2, countd, materials, cam, geoms, meshes,
                   textures, base_key, start_iter, cfg, chunk,
                   packed_meshes, pix_override, samp_index, count_img):
    """accum/accum2/count += `chunk` adaptive iterations (chunk_body).
    The per-pixel count lives on device so the replan never pulls it."""
    img, l2 = chunk_body(materials, cam, geoms, meshes, textures,
                         base_key, start_iter, cfg, chunk, packed_meshes,
                         pix_override, samp_index)
    return accum + img, accum2 + l2, countd + count_img * chunk


@partial(jax.jit, donate_argnames=())
def error_image(accum, accum2, count):
    """Device-side relative-standard-error image (the replan pulls this
    one [H,W] plane to the host instead of the full accumulator stack)."""
    cnt = jnp.maximum(count, 1.0)
    lum = (accum[..., 0] * _LW[0] + accum[..., 1] * _LW[1]
           + accum[..., 2] * _LW[2])
    mean = lum / cnt
    var = jnp.maximum(accum2 / cnt - mean ** 2, 0.0)
    g = jnp.maximum(jnp.sum(lum) / jnp.sum(cnt), 1e-12)
    return (jnp.sqrt(var / cnt) + 0.5 * g / cnt) / (mean + 0.1 * g + 1e-6)


def apportion(weights: np.ndarray, total: int) -> np.ndarray:
    """Largest-remainder apportionment: integer n_i >= 0 summing exactly
    to `total`, proportional to non-negative `weights`."""
    w = np.maximum(np.asarray(weights, np.float64).ravel(), 0.0)
    s = w.sum()
    if s <= 0:
        w = np.ones_like(w)
        s = w.sum()
    quota = w * (total / s)
    n = np.floor(quota).astype(np.int64)
    short = total - int(n.sum())
    if short > 0:
        rem = quota - n
        top = np.argpartition(rem, -short)[-short:]
        n[top] += 1
    return n


def plan_epoch(accum: np.ndarray, accum2: np.ndarray, count: np.ndarray,
               floor_frac: float = 0.15):
    """Host epoch planner: (pix, surrogate, count_image) for the next
    epoch from the running sums.

    Error metric: relative standard error of the per-pixel mean,
    sqrt(var/n) / (mean + eps) — the pixels whose displayed value is
    still moving get the budget. `floor_frac` mixes in a uniform floor so
    every pixel keeps being sampled (an err underestimate can never
    starve a pixel permanently).
    """
    h, w = count.shape
    npix = h * w
    cnt = np.maximum(np.asarray(count, np.float64), 1.0)
    lum = (np.asarray(accum[..., 0], np.float64) * _LW[0]
           + np.asarray(accum[..., 1], np.float64) * _LW[1]
           + np.asarray(accum[..., 2], np.float64) * _LW[2])
    mean = lum / cnt
    var = np.maximum(np.asarray(accum2, np.float64) / cnt - mean ** 2, 0.0)
    # Starvation guard: a pixel whose few samples all missed the light
    # reads var = 0 and would never be sampled again, freezing a too-dark
    # estimate (a real measured bias: -40% image mean on cornell 32^2 at
    # 48 spp without this). Add an exploration term at the scale of the
    # global mean luminance (an unseen light spike) that decays as 1/n —
    # fast enough that genuinely-black converged regions stop eating
    # budget, slow enough that no pixel is ever permanently starved. A
    # var FLOOR (err ~ 1/sqrt(n) for dark pixels forever) was measured to
    # pin the allocation near-uniform on dark-background scenes.
    g = max(float(lum.sum() / cnt.sum()), 1e-12)
    err = (np.sqrt(var / cnt) + 0.5 * g / cnt) / (mean + 0.1 * g + 1e-6)
    return plan_from_err(err, floor_frac)


def cost_proxy_image(scene, width: int, height: int,
                     mesh_ratio: float = 128.0) -> np.ndarray:
    """Host-side per-pixel COST proxy [h,w]: 1.0 for pixels whose primary
    ray misses every mesh geom's world AABB, `mesh_ratio` for the rest.

    Why: the planner's per-SAMPLE optimal allocation (n ~ err) moves the
    budget from near-free sky rays onto BVH-traversal rays, which cost
    far more per sample. Neyman allocation under heterogeneous cost is
    n ~ err/sqrt(cost); this proxy captures the dominant cost cliff.
    Returns all-ones when the scene has no meshes. The default ratio was
    set on the previous accelerator's packet traversal; an H100 mesh
    cell sets it again for the CUDA traversal. The honest envelope: adaptive's
    equal-TIME wins come on cost-uniform scenes with concentrated
    variance; when the variance lives in the expensive region (glass
    mesh), Neyman damping can only bound the loss, not flip it.
    """
    from ..scene import types as T
    gtypes = np.asarray(scene.geoms.type)
    mesh_ids = np.nonzero(gtypes == T.MESH)[0]
    if len(mesh_ids) == 0 or not scene.packed_meshes:
        return np.ones((height, width), np.float32)
    cam = {k: np.asarray(v) for k, v in scene.camera.flat().items()}
    idx = np.arange(width * height)
    x = (idx % width).astype(np.float64) + 0.5
    y = (idx // width).astype(np.float64) + 0.5
    sx = cam["pixel_length"][0] * (x - width * 0.5)
    sy = cam["pixel_length"][1] * (y - height * 0.5)
    d = (cam["view"][None, :] - cam["right"][None, :] * sx[:, None]
         - cam["up"][None, :] * sy[:, None])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = cam["position"][None, :]
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    hit_any = np.zeros(width * height, bool)
    xf = np.asarray(scene.geoms.transform)
    for g in mesh_ids:
        m = int(np.asarray(scene.geoms.mesh_id)[g])
        packed = scene.packed_meshes[m]
        nf = np.asarray(packed.nodes_f[0])
        los = nf[0:48].reshape(8, 6)[:, 0:3]
        his = nf[0:48].reshape(8, 6)[:, 3:6]
        ok = np.isfinite(los[:, 0])
        lo_o, hi_o = los[ok].min(0), his[ok].max(0)
        # world AABB of the transformed object box (8 corners)
        cs = np.stack(np.meshgrid(*[[lo_o[k], hi_o[k]] for k in range(3)],
                                  indexing="ij"), -1).reshape(-1, 3)
        cw = cs @ np.asarray(xf[g])[:3, :3].T + np.asarray(xf[g])[:3, 3]
        lo, hi = cw.min(0), cw.max(0)
        t1 = (lo[None, :] - o) * inv
        t2 = (hi[None, :] - o) * inv
        tmin = np.minimum(t1, t2).max(1)
        tmax = np.maximum(t1, t2).min(1)
        hit_any |= (tmax >= tmin) & (tmax > 0)
    cost = np.where(hit_any, mesh_ratio, 1.0).astype(np.float32)
    return cost.reshape(height, width)


def plan_from_err(err: np.ndarray, floor_frac: float = 0.15,
                  tile: int = 0, cost: np.ndarray = None):
    """(pix, surrogate, count_image) from a host error image (the fast
    path: the Renderer pulls only `error_image` over the transport).

    `tile` > 0 emits the paths in TxT pixel-tile-major order so
    consecutive paths stay screen-coherent for the mesh traversal; pure
    pixel-id order otherwise."""
    h, w = err.shape
    npix = h * w
    err = np.asarray(err, np.float64)
    u = err.sum() / npix
    err = (1.0 - floor_frac) * err + floor_frac * max(u, 1e-12)
    if cost is not None:
        # Neyman allocation under per-pixel cost: n ~ err/sqrt(cost)
        err = err / np.sqrt(np.asarray(cost, np.float64))
    n = apportion(err, npix)
    if tile and h % tile == 0 and w % tile == 0:
        order = np.asarray(identity_plan(w, h, tile)[0], np.int64)
        pix = np.repeat(order, n[order])
    else:
        pix = np.repeat(np.arange(npix, dtype=np.int64), n)
    # occurrence index within each pixel's run (runs are contiguous in
    # either emission order)
    change = np.empty(npix, bool)
    change[0] = True
    np.not_equal(pix[1:], pix[:-1], out=change[1:])
    run_start = np.maximum.accumulate(
        np.where(change, np.arange(npix, dtype=np.int64), 0))
    occ = np.arange(npix, dtype=np.int64) - run_start
    # int32-safe surrogate: occurrences past the cap reuse a stream
    # (harmless: stratification quality degrades for those few paths)
    cap = (2 ** 31 - 1) // npix - 1
    surr = pix + np.minimum(occ, cap) * npix
    count_img = n.reshape(h, w).astype(np.float32)
    # ONE packed upload (pix | surr) — transfer count, not bandwidth,
    # dominates the replan over the remote transport
    packed = jnp.asarray(np.concatenate([pix, surr]), jnp.int32)
    return packed[:npix], packed[npix:], count_img


def plan_epoch_sharded(accum: np.ndarray, accum2: np.ndarray,
                       count: np.ndarray, ndev: int,
                       floor_frac: float = 0.15):
    """Per-shard adaptive plan: the pixel rows are split into `ndev`
    equal row blocks (the ShardedRenderer's data sharding) and each
    block's W*H/ndev path budget is apportioned WITHIN the block — every
    path's pixel stays on its own shard, so the radiance scatter is
    provably local under shard_map (no cross-chip collectives). The
    budget-per-shard constraint costs a little allocation optimality vs
    the global plan; locality avoids a collective per iteration."""
    h, w = count.shape
    assert h % ndev == 0
    rows = h // ndev
    cnt = np.maximum(np.asarray(count, np.float64), 1.0)
    lum = (np.asarray(accum[..., 0], np.float64) * _LW[0]
           + np.asarray(accum[..., 1], np.float64) * _LW[1]
           + np.asarray(accum[..., 2], np.float64) * _LW[2])
    mean = lum / cnt
    var = np.maximum(np.asarray(accum2, np.float64) / cnt - mean ** 2, 0.0)
    g = max(float(lum.sum() / cnt.sum()), 1e-12)
    err = (np.sqrt(var / cnt) + 0.5 * g / cnt) / (mean + 0.1 * g + 1e-6)
    npix_loc = rows * w
    pix_all, surr_all, cimg_all = [], [], []
    for d in range(ndev):
        blk = err[d * rows:(d + 1) * rows]
        e = np.asarray(blk, np.float64)
        u = e.sum() / npix_loc
        e = (1.0 - floor_frac) * e + floor_frac * max(u, 1e-12)
        n = apportion(e, npix_loc)
        base = d * npix_loc
        pix = base + np.repeat(np.arange(npix_loc, dtype=np.int64), n)
        starts = np.concatenate([[0], np.cumsum(n)[:-1]])
        occ = np.arange(npix_loc, dtype=np.int64) - np.repeat(starts, n)
        cap = (2 ** 31 - 1) // (h * w) - 1
        surr_all.append(pix + np.minimum(occ, cap) * (h * w))
        pix_all.append(pix)
        cimg_all.append(n.reshape(rows, w))
    pix = np.concatenate(pix_all)
    surr = np.concatenate(surr_all)
    count_img = np.concatenate(cimg_all).astype(np.float32)
    return (jnp.asarray(pix, jnp.int32), jnp.asarray(surr, jnp.int32),
            count_img)


def identity_plan_sharded(width: int, height: int, ndev: int,
                          tile: int = 0):
    """Warmup mapping for the sharded renderer: the identity (or a
    per-shard-block tile swizzle when the tile divides the block rows —
    a straddling tile would leak paths across shards)."""
    rows = height // ndev
    if tile and (rows % tile or width % tile):
        tile = 0
    blocks = []
    for d in range(ndev):
        p, _, _ = identity_plan(width, rows, tile)
        blocks.append(np.asarray(p, np.int64) + d * rows * width)
    idx = np.concatenate(blocks)
    return (jnp.asarray(idx, jnp.int32), jnp.asarray(idx, jnp.int32),
            np.ones((height, width), np.float32))


def identity_plan(width: int, height: int, tile: int = 0):
    """Warmup mapping: path i -> pixel i (or the TxT tile swizzle the
    uniform renderer would use) — bitwise the uniform render."""
    npix = width * height
    idx = np.arange(npix, dtype=np.int64)
    if tile and width % tile == 0 and height % tile == 0:
        per = tile * tile
        tpr = width // tile
        xi = (idx // per % tpr) * tile + idx % per % tile
        yi = (idx // per // tpr) * tile + idx % per // tile
        idx = xi + yi * width
    return (jnp.asarray(idx, jnp.int32), jnp.asarray(idx, jnp.int32),
            np.ones((height, width), np.float32))
