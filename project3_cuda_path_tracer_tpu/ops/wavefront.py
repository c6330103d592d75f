"""Planar (component-SoA) wavefront kernels: ray-gen, intersect, shade.

This is the production hot path. The [N,3]-based modules (ops/camera,
ops/intersect, ops/bsdf) remain as readable reference oracles; tests assert
these planar kernels match them. Differences are purely mechanical:

  * every 3-vector is a `vec.V3` of flat [N] planes (see ops/vec.py);
  * no cross-lane ops: the reference's argmax/argmin + take_along_axis axis
    selection (slab test) becomes explicit 3-way comparison selects (no
    element gathers);
  * per-geom scene constants are scalars (static geom index), so XLA
    constant-folds the transform rows into the fused elementwise pipeline;
  * material table lookups unroll into masked selects over the (static,
    small) material count instead of [N]-sized gathers.

Reference parity: same math as src/intersections.h:27-144 (slab + quadratic
in object space, world-distance t, 1e-4 back-off, interior normal flips) and
the scatterRay contract of src/interactions.h:44-79.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import vec
from .vec import V3
from ..scene import types as T
from ..utils.math import SQRT_OF_ONE_THIRD, TWO_PI, RAY_EPS

BIG = jnp.float32(1e30)


# ---------------------------------------------------------------------------
# Ray generation (reference: src/pathtrace.cu:122-143 + AA/DoF/motion TODOs)
# ---------------------------------------------------------------------------

def _hash01(idx: jnp.ndarray, salt: int) -> jnp.ndarray:
    """Per-pixel uniform in [0,1) from an integer hash (utilhash-style,
    reference src/intersections.h:12-20) — the fixed Cranley-Patterson
    rotation for stratified camera sampling. Pure elementwise int ops."""
    x = idx.astype(jnp.uint32) ^ jnp.uint32(salt)
    x = (x ^ (x >> 16)) * jnp.uint32(0x45D9F3B)
    x = (x ^ (x >> 16)) * jnp.uint32(0x45D9F3B)
    x = x ^ (x >> 16)
    return (x & jnp.uint32(0x00FFFFFF)).astype(jnp.float32) * (1.0 / (1 << 24))


# R_d low-discrepancy sequences (generalized-golden-ratio rank-1
# lattices, Roberts 2018): the i-th d-dim point is frac(0.5 + i * ALPHA_d).
# With a per-pixel CP rotation each pixel sees its own shifted lattice
# over iterations — variance in the stratified dims converges ~O(1/N)
# instead of O(1/sqrt(N)).
_R2A = (0.7548776662466927, 0.5698402909980532)
_R3A = (0.8191725133961645, 0.6710436067037893, 0.5497004779019703)
_R4A = (0.8566748838545029, 0.7338918566271259,
        0.6287067210378086, 0.5385972572236101)
_R8A = (0.921599319633983, 0.8493453059498204,
        0.7827560560976716, 0.721387448738994,
        0.6648301819503516, 0.6127070433575812,
        0.5646703942932961, 0.5203998511981547)
_PHI_INV = 0.6180339887498949  # 1-D golden-ratio sequence (shutter time)


_ALPHAS = {1: (_PHI_INV,), 2: _R2A, 3: _R3A, 4: _R4A,
           5: _R4A + (_PHI_INV,), 8: _R8A}

# "depth" slot used for the camera dims (distinct from bounce depths)
CAMERA_SLOT = 0x7FFFFFFF


def stratified_planes(iteration, depth, pixel_index, num_dims: int,
                      salt0: int, impl: str = "lattice"):
    """`num_dims` stratified uniform planes for (iteration, depth,
    pixel). Two implementations, both deterministic and keyed only on
    (iteration, depth, pixel) (so permutation-invariant under
    sort/compact):

      "lattice" — CP-rotated R_d rank-1 lattices; the default: its
                  hash draws are CHEAPER than the rbg bit-gen they
                  replace, so stratification is a net speedup.
      "sobol"   — padded hash-based Owen-scrambled Sobol (0,2) pairs
                  (ops/qmc.py): every power-of-2 sample prefix is
                  perfectly stratified per pixel (best per-sample RMSE)
                  but costs a 32-step bit expansion per draw — pick it
                  when traversal dominates.
    """
    if impl == "sobol":
        from . import qmc
        return qmc.sample_planes(iteration, depth, pixel_index, num_dims,
                                 salt0)
    it_f = jnp.asarray(iteration, jnp.float32)
    mix = pixel_index.astype(jnp.uint32) ^ (
        jnp.asarray(depth, jnp.uint32) * jnp.uint32(0x9E3779B9))
    return tuple(
        jnp.mod(0.5 + it_f * a + _hash01(mix, salt0 + 101 * k), 1.0)
        for k, a in enumerate(_ALPHAS[num_dims][:num_dims]))


def generate_rays_planar(cam: dict, width: int, height: int, key: jax.Array,
                         antialias: bool = True, tile: int = 0,
                         dof: bool = True, motion: bool = True,
                         stratified: bool = False, iteration=None,
                         strat_impl: str = "lattice",
                         pixel_override=None, strat_index=None):
    """Primary rays as (origin V3, dir V3, time [N], pixel_index [N]).

    `tile` > 0 swizzles the path→pixel mapping into TxT image tiles so that
    consecutive path indices cover a compact screen tile instead of a full
    scan row, so neighbouring rays walk similar BVH paths (a warp of the
    mesh traversal kernel holds 32 consecutive paths). pixel_index records
    the mapping; tile=0 is the reference's row-major identity
    (src/pathtrace.cu:128,140).

    `stratified` (with the traced `iteration` index) replaces the random
    camera-sample draws (AA jitter, lens disk, shutter time) with
    per-pixel Cranley-Patterson-rotated low-discrepancy sequences —
    deterministic, equidistributed over iterations, and pure elementwise
    (no RNG bit-gen for those planes). Falls back to the random draws
    when `iteration` is None (callers that don't track an index).
    """
    # Under a pixel override the path count follows the override (a
    # sharded caller traces only its local block of paths while the
    # pixel ids — and the width/height the direction math uses — stay
    # GLOBAL).
    n = width * height if pixel_override is None else \
        pixel_override.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    if pixel_override is not None:
        # Adaptive sampling (render/adaptive.py): path i shoots at an
        # arbitrary pixel (several paths may share one). `strat_index`
        # keys the stratified draws uniquely per path (pixel + occurrence
        # * npix) so co-located paths don't duplicate samples.
        xi = pixel_override % width
        yi = pixel_override // width
    elif tile and width % tile == 0 and height % tile == 0:
        per_tile = tile * tile
        tiles_per_row = width // tile
        tile_id = idx // per_tile
        within = idx % per_tile
        xi = (tile_id % tiles_per_row) * tile + within % tile
        yi = (tile_id // tiles_per_row) * tile + within // tile
    else:
        xi = idx % width
        yi = idx // width
    pixel_index = xi + yi * width
    x = xi.astype(jnp.float32)
    y = yi.astype(jnp.float32)

    # Multi-plane draws are FLAT + sliced: a [2, n] draw makes XLA slice
    # [1, n] rows out of a 2-D array in every consumer (same choice as
    # the per-bounce uniforms, render/integrator.py).
    k_aa, k_lens, k_time = jax.random.split(key, 3)
    strat = stratified and iteration is not None
    if strat:
        samp_key = strat_index if strat_index is not None else pixel_index

        def draw(num, salt):
            return stratified_planes(iteration, CAMERA_SLOT, samp_key,
                                     num, salt, impl=strat_impl)
    if antialias:
        if strat:
            u_ax, u_ay = draw(2, 0x68BC21EB)
            x = x + u_ax
            y = y + u_ay
        else:
            jit_xy = jax.random.uniform(k_aa, (2 * n,), jnp.float32)
            x = x + jit_xy[:n]
            y = y + jit_xy[n:]

    view = vec.from_rows(cam["view"])
    right = vec.from_rows(cam["right"])
    up = vec.from_rows(cam["up"])
    plx, ply = cam["pixel_length"][0], cam["pixel_length"][1]

    sx = plx * (x - width * 0.5)
    sy = ply * (y - height * 0.5)
    d = vec.normalize(V3(view.x - right.x * sx - up.x * sy,
                         view.y - right.y * sx - up.y * sy,
                         view.z - right.z * sx - up.z * sy))
    pos = vec.from_rows(cam["position"])
    o = vec.splat((pos.x, pos.y, pos.z), like=x)

    # `dof` / `motion` (static) skip the thin-lens and shutter math when the
    # scene statically has no aperture/shutter: the runtime `use_dof` select
    # already yielded the pinhole values bitwise, but XLA still executed the
    # sqrt/sincos/normalize on every lane. The k_aa/k_lens/k_time splits are
    # independent, so skipping a draw does not shift the other streams —
    # images are bitwise identical either way (tested).
    if dof:
        aperture = cam["aperture"]
        focal = cam["focal_distance"]
        if strat:
            u_l0, u_l1 = draw(2, 0x51633E2D)
        else:
            u_lens = jax.random.uniform(k_lens, (2 * n,), jnp.float32)
            u_l0, u_l1 = u_lens[:n], u_lens[n:]
        r = jnp.sqrt(u_l0) * aperture
        phi = u_l1 * TWO_PI
        lr, lu = r * jnp.cos(phi), r * jnp.sin(phi)
        o_dof = V3(o.x + right.x * lr + up.x * lu,
                   o.y + right.y * lr + up.y * lu,
                   o.z + right.z * lr + up.z * lu)
        f = jnp.maximum(focal, 1e-6)
        focus = V3(o.x + d.x * f, o.y + d.y * f, o.z + d.z * f)
        d_dof = vec.normalize(focus - o_dof)
        use_dof = (aperture > 0.0) & (focal > 0.0)
        o = vec.where(use_dof, o_dof, o)
        d = vec.where(use_dof, d_dof, d)

    if motion:
        if strat:
            (u_t,) = draw(1, 0x3504F333)
        else:
            u_t = jax.random.uniform(k_time, (n,), jnp.float32)
        times = u_t * cam["shutter"]
    else:
        times = jnp.zeros((n,), jnp.float32)
    return o, d, times, pixel_index


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------

class HitP(NamedTuple):
    """Planar ShadeableIntersection + shading inputs.

    `point` is the 1e-4 backed-off hit point (getPointOnRay semantics,
    reference src/intersections.h:27-29), lifted off the surface along
    the normal (ops/intersect.lift_off), used for reflected/diffuse
    continuation; `surf` is the EXACT surface point, which transmission
    pushes through (a fixed world-space push from the backed-off point
    cannot reliably cross the surface for strongly scaled geoms)."""
    t: jnp.ndarray       # [N]; -1 = miss (after finalize)
    normal: V3
    mat_id: jnp.ndarray  # [N] int32
    point: V3            # backed-off world hit point
    surf: V3             # exact world surface point
    u: jnp.ndarray       # [N] texture u
    v: jnp.ndarray       # [N] texture v
    outside: jnp.ndarray  # [N] bool
    # World-space dP/du (unnormalized; only computed under
    # intersect_planar(tangents=True), else None) — the uv-consistent
    # tangent frame file-loaded normal maps need (shade_planar
    # orthonormalizes against the normal and falls back to a
    # normal-derived frame where |dP/du| degenerates, e.g. sphere poles).
    tan: V3 = None


def _box_local_planar(qo: V3, qd: V3):
    """Unit-cube slab test (reference: src/intersections.h:48-90) with the
    axis argmax/argmin replaced by comparison selects."""
    # exact-zero components are bumped to 1e-30 instead of dividing to
    # inf: the slab decisions are identical (t ~ 1e30 ordering like inf),
    # but 1/0's infinite VJP would NaN live-direction gradients (secondary
    # mirror/refraction chains) through the multiply-style min/max
    # transposes even on unselected slabs. The clamp is 1e-12 (not
    # denormal-tiny): 1/x's VJP is -1/x^2, which must stay finite in f32
    # (1e24 here); the slab decisions at t ~ 1e12 are the same as at inf.
    def _nz(c):
        return jnp.where(jnp.abs(c) < 1e-12,
                         jnp.where(c < 0, -1e-12, 1e-12), c)
    inv = V3(1.0 / _nz(qd.x), 1.0 / _nz(qd.y), 1.0 / _nz(qd.z))
    t1 = V3((-0.5 - qo.x) * inv.x, (-0.5 - qo.y) * inv.y,
            (-0.5 - qo.z) * inv.z)
    t2 = V3((0.5 - qo.x) * inv.x, (0.5 - qo.y) * inv.y, (0.5 - qo.z) * inv.z)
    ta = V3(jnp.minimum(t1.x, t2.x), jnp.minimum(t1.y, t2.y),
            jnp.minimum(t1.z, t2.z))
    tb = V3(jnp.maximum(t1.x, t2.x), jnp.maximum(t1.y, t2.y),
            jnp.maximum(t1.z, t2.z))
    sign = V3(jnp.where(t2.x < t1.x, 1.0, -1.0),
              jnp.where(t2.y < t1.y, 1.0, -1.0),
              jnp.where(t2.z < t1.z, 1.0, -1.0))

    tap = V3(jnp.where(ta.x > 0, ta.x, -BIG),
             jnp.where(ta.y > 0, ta.y, -BIG),
             jnp.where(ta.z > 0, ta.z, -BIG))
    tmin = jnp.maximum(tap.x, jnp.maximum(tap.y, tap.z))
    tmax = jnp.minimum(tb.x, jnp.minimum(tb.y, tb.z))

    hit = (tmax >= tmin) & (tmax > 0)
    outside = tmin > 0
    t_obj = jnp.where(outside, tmin, tmax)

    # entering face (outside) picks argmax of tap; exiting face (inside)
    # picks argmin of tb — both via equality selects with x>y>z tie priority
    ex = jnp.where(outside, tap.x == tmin, tb.x == tmax)
    ey = (~ex) & jnp.where(outside, tap.y == tmin, tb.y == tmax)
    ez = ~(ex | ey)
    n_local = V3(jnp.where(ex, sign.x, 0.0),
                 jnp.where(ey, sign.y, 0.0),
                 jnp.where(ez, sign.z, 0.0))
    return t_obj, hit, outside, n_local, ex, ez


def _sphere_local_planar(qo: V3, qd: V3):
    """r=0.5 sphere quadratic (reference: src/intersections.h:102-144).

    The discriminant sqrt is double-where'd: sqrt(max(x,0)) at x<0 has a
    0*inf VJP (JAX's max transpose multiplies by an indicator instead of
    selecting, so the sqrt-at-zero infinite derivative NaNs every
    upstream gradient — camera position, and the IOR/SPECEX chains that
    flow through scatter directions since round 5). Miss lanes get a
    dummy radicand; their t roots were garbage already (hit=False routes
    them away)."""
    v_dot_d = vec.dot(qo, qd)
    radicand = v_dot_d * v_dot_d - (vec.dot(qo, qo) - 0.25)
    has_root = radicand >= 0
    s = jnp.sqrt(jnp.where(has_root, jnp.maximum(radicand, 0.0), 1.0))
    t1 = -v_dot_d + s
    t2 = -v_dot_d - s
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    return t_obj, has_root & ~both_neg, both_pos


def _primitive_hit_planar(o: V3, d: V3, times, geoms: T.Geoms, g: int,
                          gtype: int, tangents: bool = False) -> HitP:
    """One static primitive vs the wavefront, fully elementwise."""
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    velx, vely, velz = (geoms.velocity[g, 0], geoms.velocity[g, 1],
                        geoms.velocity[g, 2])

    o_shift = V3(o.x - velx * times, o.y - vely * times, o.z - velz * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))

    if gtype == T.CUBE:
        t_obj, hit, outside, n_local, ex, ez = _box_local_planar(qo, qd)
    else:
        t_obj, hit, outside = _sphere_local_planar(qo, qd)

    tb = t_obj - RAY_EPS
    ip_obj = V3(qo.x + tb * qd.x, qo.y + tb * qd.y, qo.z + tb * qd.z)
    sf_obj = V3(qo.x + t_obj * qd.x, qo.y + t_obj * qd.y,
                qo.z + t_obj * qd.z)
    ip_world = vec.xform_pt(fwd, ip_obj)
    ip_world = V3(ip_world.x + velx * times, ip_world.y + vely * times,
                  ip_world.z + velz * times)
    sf_world = vec.xform_pt(fwd, sf_obj)
    sf_world = V3(sf_world.x + velx * times, sf_world.y + vely * times,
                  sf_world.z + velz * times)
    t_world = vec.norm(o - ip_world)

    tan = None
    if gtype == T.CUBE:
        u = jnp.where(ex, ip_obj.y, ip_obj.x) + 0.5
        v = jnp.where(ez, ip_obj.y, ip_obj.z) + 0.5
        if tangents:
            # dP_obj/du follows the uv convention above: the +x faces
            # parameterize u by object y, the others by object x.
            zero = jnp.zeros_like(u)
            t_obj_dir = V3(jnp.where(ex, 0.0, 1.0) + zero,
                           jnp.where(ex, 1.0, 0.0) + zero, zero)
            tan = vec.xform_dir(fwd, t_obj_dir)
    else:
        flip = jnp.where(outside, 1.0, -1.0)
        n_local = V3(ip_obj.x * flip, ip_obj.y * flip, ip_obj.z * flip)
        u = 0.5 + jnp.arctan2(ip_obj.z, ip_obj.x) / (2 * jnp.pi)
        # 1e-7 inset: arcsin'(+-1) = inf and clip's multiply-style VJP
        # passes 0*inf = NaN for garbage lanes with |y| > 0.5 (see the
        # sphere-quadratic guard); primal shift only at exact pole hits
        # (v moves ~1.4e-4 texels at 4k)
        v = 0.5 + jnp.arcsin(jnp.clip(ip_obj.y / 0.5,
                                      -1.0 + 1e-7, 1.0 - 1e-7)) / jnp.pi
        if tangents:
            # equirect dP_obj/du ~ d/du (cos, ., sin)(2*pi*u) ~ (-z, 0, x);
            # degenerates at the poles (shade_planar falls back there)
            tan = vec.xform_dir(fwd, V3(-ip_obj.z, jnp.zeros_like(u),
                                        ip_obj.x))

    normal = vec.normalize(vec.xform_dir(inv_tr, n_local))
    return HitP(t=jnp.where(hit, t_world, BIG), normal=normal,
                mat_id=jnp.broadcast_to(geoms.material_id[g], t_world.shape),
                point=ip_world, surf=sf_world, u=u, v=v, outside=outside,
                tan=tan)


def _sdf_hit_planar(o: V3, d: V3, times, geoms: T.Geoms, g: int,
                    kind, tangents: bool = False) -> HitP:
    """One static SDF geom vs the wavefront (reference TODO alternative
    primitives: src/pathtrace.cu:188). Same object-space convention as
    `_primitive_hit_planar` — transform with the inverse, march along the
    normalized object-space direction, return WORLD-distance t
    (src/intersections.h:87,143 semantics) — the surface just comes from
    sphere tracing (ops/sdf.py) instead of a closed form."""
    from . import sdf as S
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    params = geoms.sdf_params[g]
    velx, vely, velz = (geoms.velocity[g, 0], geoms.velocity[g, 1],
                        geoms.velocity[g, 2])

    o_shift = V3(o.x - velx * times, o.y - vely * times, o.z - velz * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))

    t_obj, hit, outside = S.march_local(qo, qd, kind, params)

    tb = t_obj - RAY_EPS
    ip_obj = V3(qo.x + tb * qd.x, qo.y + tb * qd.y, qo.z + tb * qd.z)
    sf_obj = V3(qo.x + t_obj * qd.x, qo.y + t_obj * qd.y,
                qo.z + t_obj * qd.z)
    n_local = S.normal_local(sf_obj, kind, params)
    # march_local flips the field for interior rays; the geometric normal
    # must still oppose the incoming ray (interior flip like the sphere's,
    # src/intersections.h:139-141)
    n_local = vec.where(outside, n_local, -n_local)

    ip_world = vec.xform_pt(fwd, ip_obj)
    ip_world = V3(ip_world.x + velx * times, ip_world.y + vely * times,
                  ip_world.z + velz * times)
    sf_world = vec.xform_pt(fwd, sf_obj)
    sf_world = V3(sf_world.x + velx * times, sf_world.y + vely * times,
                  sf_world.z + velz * times)
    t_world = vec.norm(o - ip_world)

    # spherical uv from the local normal (cheap, good enough for
    # checker/texture shading on implicit surfaces)
    u = 0.5 + jnp.arctan2(n_local.z, n_local.x) / (2 * jnp.pi)
    v = 0.5 + jnp.arcsin(jnp.clip(n_local.y, -1.0, 1.0)) / jnp.pi
    tan = None
    if tangents:   # spherical-uv tangent, same convention as the sphere
        tan = vec.xform_dir(fwd, V3(-n_local.z, jnp.zeros_like(u),
                                    n_local.x))

    normal = vec.normalize(vec.xform_dir(inv_tr, n_local))
    return HitP(t=jnp.where(hit, t_world, BIG), normal=normal,
                mat_id=jnp.broadcast_to(geoms.material_id[g], t_world.shape),
                point=ip_world, surf=sf_world, u=u, v=v, outside=outside,
                tan=tan)


def _mesh_hit(o: V3, d: V3, times, geoms: T.Geoms, packed,
              g: int, meshes: T.MeshBundle, mesh_index: int,
              differentiable: bool = False,
              t_world_bound=None,
              alive=None,
              any_hit: bool = False,
              tangents: bool = False,
              mesh=None) -> HitP:
    """MESH geom via the BVH traversal (ops/bvh8.traverse: the CUDA kernel
    on the GPU, the plain XLA walk elsewhere).

    The traversal has no VJP; the winning TRIANGLE index is treated as a
    detached discrete decision (the detached-sampling convention extended
    to visibility). With `differentiable=True` the hit attributes (t,
    barycentrics, smooth normal) are RECOMPUTED from the winning triangle
    with plain jnp ops, so gradients flow through the continuous geometry
    exactly (Moller-Trumbore is smooth in ray origin/direction); the
    forward-only path keeps the traversal's own interpolation and no
    gathers. `mesh` shards the traversal over a device mesh (see
    ops/bvh8.traverse).
    """
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    velx, vely, velz = (geoms.velocity[g, 0], geoms.velocity[g, 1],
                        geoms.velocity[g, 2])

    o_shift = V3(o.x - velx * times, o.y - vely * times, o.z - velz * times)
    qo = vec.xform_pt(inv, o_shift)
    qd = vec.normalize(vec.xform_dir(inv, d))

    from . import bvh8
    sg = jax.lax.stop_gradient
    n = qo.x.shape[0]
    t_bound = jnp.full((n,), BIG, jnp.float32)
    if t_world_bound is not None:
        # occlusion bound in object units: world distance along the ray is
        # t_obj * |M_linear qd| (exact for affine transforms); small slack
        # keeps borderline hits for the world-space merge to adjudicate
        md = vec.xform_dir(fwd, qd)
        t_bound = sg(t_world_bound / jnp.maximum(vec.norm(md), 1e-12)
                     * 1.0005 + 1e-3)
    if alive is not None:
        # Terminated paths get the dead-ray sentinel t_bound = -1 and are
        # not traversed (the wavefront masking analogue of the reference's
        # stream compaction, src/pathtrace.cu:313-317). Their outputs
        # (tri = -1) are already masked downstream by `hit`.
        t_bound = jnp.where(alive, t_bound, -1.0)

    t_obj, (nlx, nly, nlz), u, v, tri = bvh8.traverse(
        (sg(qo.x), sg(qo.y), sg(qo.z)), (sg(qd.x), sg(qd.y), sg(qd.z)),
        t_bound, packed, meshes, mesh_index, any_hit=any_hit, mesh=mesh)
    tri_offset = meshes.mesh_tri_offset[mesh_index]
    hit = tri >= 0

    if differentiable:
        # re-derive the continuous hit attributes from the detached winner
        tri_g = jnp.maximum(tri, 0) + tri_offset
        take = lambda a: vec.from_rows(jnp.take(a, tri_g, axis=0))
        v0 = take(meshes.tri_v0)
        e1 = take(meshes.tri_e1)
        e2 = take(meshes.tri_e2)
        pvec = vec.cross(qd, e2)
        det = vec.dot(e1, pvec)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = qo - v0
        bu = vec.dot(tvec, pvec) * inv_det
        qvec = vec.cross(tvec, e1)
        bv = vec.dot(qd, qvec) * inv_det
        t_obj = vec.dot(e2, qvec) * inv_det
        bw = 1.0 - bu - bv
        n0 = take(meshes.tri_n0)
        n1 = take(meshes.tri_n1)
        n2 = take(meshes.tri_n2)
        nlx = bw * n0.x + bu * n1.x + bv * n2.x
        nly = bw * n0.y + bu * n1.y + bv * n2.y
        nlz = bw * n0.z + bu * n1.z + bv * n2.z
        uv0 = jnp.take(meshes.tri_uv0, tri_g, axis=0)
        uv1 = jnp.take(meshes.tri_uv1, tri_g, axis=0)
        uv2 = jnp.take(meshes.tri_uv2, tri_g, axis=0)
        u = bw * uv0[:, 0] + bu * uv1[:, 0] + bv * uv2[:, 0]
        v = bw * uv0[:, 1] + bu * uv1[:, 1] + bv * uv2[:, 1]

    tb = t_obj - RAY_EPS
    ip_obj = V3(qo.x + tb * qd.x, qo.y + tb * qd.y, qo.z + tb * qd.z)
    sf_obj = V3(qo.x + t_obj * qd.x, qo.y + t_obj * qd.y,
                qo.z + t_obj * qd.z)
    ip_world = vec.xform_pt(fwd, ip_obj)
    ip_world = V3(ip_world.x + velx * times, ip_world.y + vely * times,
                  ip_world.z + velz * times)
    sf_world = vec.xform_pt(fwd, sf_obj)
    sf_world = V3(sf_world.x + velx * times, sf_world.y + vely * times,
                  sf_world.z + velz * times)
    t_world = jnp.where(hit, vec.norm(o - ip_world), BIG)

    normal = vec.normalize(vec.xform_dir(inv_tr, V3(nlx, nly, nlz)))
    # two-sided: flip toward the incoming ray (open surfaces)
    facing = vec.dot(normal, d) < 0
    normal = vec.where(facing, normal, -normal)

    tan = None
    if tangents:
        # Per-triangle uv tangent (dP/du from the uv-edge system), the
        # standard solve T = (e1*dv2 - e2*dv1)/det gathered by the
        # detached winning-triangle index — mesh lanes only pay when the
        # scene actually uses normal maps (cfg.nmap).
        tri_g = jnp.maximum(tri, 0) + tri_offset
        take3 = lambda a: vec.from_rows(jnp.take(a, tri_g, axis=0))
        e1t = take3(meshes.tri_e1)
        e2t = take3(meshes.tri_e2)
        uv0 = jnp.take(meshes.tri_uv0, tri_g, axis=0)
        uv1 = jnp.take(meshes.tri_uv1, tri_g, axis=0)
        uv2 = jnp.take(meshes.tri_uv2, tri_g, axis=0)
        du1 = uv1[:, 0] - uv0[:, 0]
        dv1 = uv1[:, 1] - uv0[:, 1]
        du2 = uv2[:, 0] - uv0[:, 0]
        dv2 = uv2[:, 1] - uv0[:, 1]
        det = du1 * dv2 - du2 * dv1
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        t_obj_dir = V3((e1t.x * dv2 - e2t.x * dv1) * inv_det,
                       (e1t.y * dv2 - e2t.y * dv1) * inv_det,
                       (e1t.z * dv2 - e2t.z * dv1) * inv_det)
        tan = jax.tree_util.tree_map(sg, vec.xform_dir(fwd, t_obj_dir))

    return HitP(t=t_world, normal=normal,
                mat_id=jnp.broadcast_to(geoms.material_id[g],
                                        t_world.shape),
                point=ip_world, surf=sf_world, u=u, v=v, outside=facing,
                tan=tan)


# Blocked-scan chunk width for the batched sphere intersector: K spheres
# are tested per scan step (inner unroll), so carry HBM traffic scales
# with B/K while compile size stays O(K).
SPHERE_BATCH_K = 16


def _batched_spheres_planar(o: V3, d: V3, times, geoms: T.Geoms,
                            idxs: Tuple[int, ...],
                            tangents: bool = False) -> HitP:
    """ALL eligible SPHERE geoms against the wavefront in ONE blocked
    lax.scan — the many-light scaling path (scenes/manylights256.txt).

    The per-geom unroll of intersect_planar is O(G) in compile size AND
    instruction count; a 256-emitter scene has 258 geoms, which is far
    past where the unroll explodes. Eligibility (static, computed by
    render/integrator.build_trace_config): uniform scale (the sphere
    reduces to a world-space center+radius quadratic — rotation cannot
    matter for the surface or its radial normals) and an untextured,
    checker-free, bump-free material (uv is meaningless in world frame,
    so lanes won't consume it). Motion velocity is supported.

    The scan carries only (t_best, winner index) — 2 [N] planes — and
    the winner's attributes are recomputed post-scan from 8 small-table
    gathers, exactly like the packet-BVH winner path. Matches
    _primitive_hit_planar's sphere semantics: positive world-distance t,
    RAY_EPS object-unit back-off (RAY_EPS * 2r in world units), interior
    normal flip, two-sided hits."""
    n = o.x.shape[0]
    gi = jnp.asarray(np.asarray(idxs, np.int32))
    tm = jnp.take(geoms.transform, gi, axis=0)            # [B,4,4]
    cx, cy, cz = tm[:, 0, 3], tm[:, 1, 3], tm[:, 2, 3]
    r = 0.5 * jnp.sqrt(tm[:, 0, 0] ** 2 + tm[:, 1, 0] ** 2
                       + tm[:, 2, 0] ** 2)
    velt = jnp.take(geoms.velocity, gi, axis=0)           # [B,3]
    mid = jnp.take(geoms.material_id, gi)                 # [B]

    b_count = len(idxs)
    k = SPHERE_BATCH_K
    pad = (-b_count) % k
    steps = (b_count + pad) // k

    def padv(a, fill):
        if pad == 0:
            return a
        return jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])

    # padding spheres: r = 0 at a far center — disc < 0, never hit
    cxp, cyp, czp = padv(cx, 1e9), padv(cy, 1e9), padv(cz, 1e9)
    rp = padv(r, 0.0)
    vxp, vyp, vzp = (padv(velt[:, 0], 0.0), padv(velt[:, 1], 0.0),
                     padv(velt[:, 2], 0.0))
    cols = jnp.stack([cxp, cyp, czp, rp, vxp, vyp, vzp], axis=1)
    blocks = cols.reshape(steps, k, 7)

    def step(carry, blk):
        t_best, i_best, base = carry
        for j in range(k):
            scx, scy, scz, sr = blk[j, 0], blk[j, 1], blk[j, 2], blk[j, 3]
            svx, svy, svz = blk[j, 4], blk[j, 5], blk[j, 6]
            ocx = o.x - svx * times - scx
            ocy = o.y - svy * times - scy
            ocz = o.z - svz * times - scz
            bq = ocx * d.x + ocy * d.y + ocz * d.z
            cq = ocx * ocx + ocy * ocy + ocz * ocz - sr * sr
            disc = bq * bq - cq
            has = disc >= 0.0
            # double-where (see _sphere_local_planar): miss lanes must not
            # NaN gradients through sqrt's 0*inf VJP
            s = jnp.sqrt(jnp.where(has, jnp.maximum(disc, 0.0), 1.0))
            t1 = -bq + s
            t2 = -bq - s
            both_neg = (t1 < 0) & (t2 < 0)
            both_pos = (t1 > 0) & (t2 > 0)
            t_c = jnp.where(both_pos, jnp.minimum(t1, t2),
                            jnp.maximum(t1, t2))
            closer = has & ~both_neg & (t_c < t_best)
            t_best = jnp.where(closer, t_c, t_best)
            i_best = jnp.where(closer, base + j, i_best)
        return (t_best, i_best + 0, base + k), None

    t0 = jnp.full((n,), BIG, jnp.float32)
    i0 = jnp.full((n,), -1, jnp.int32)
    (t_best, i_best, _), _ = jax.lax.scan(
        step, (t0, i0, jnp.int32(0)), blocks)

    got = i_best >= 0
    iw = jnp.clip(i_best, 0, b_count - 1)
    cwx, cwy, cwz = (jnp.take(cxp, iw), jnp.take(cyp, iw),
                     jnp.take(czp, iw))
    rw = jnp.maximum(jnp.take(rp, iw), 1e-12)
    vwx, vwy, vwz = (jnp.take(vxp, iw), jnp.take(vyp, iw),
                     jnp.take(vzp, iw))
    matw = jnp.take(mid, iw)
    # shift the center INTO the ray's time frame (equivalent to shifting
    # the origin out of it, matching _primitive_hit_planar)
    cwx = cwx + vwx * times
    cwy = cwy + vwy * times
    cwz = cwz + vwz * times
    surf = V3(o.x + t_best * d.x, o.y + t_best * d.y, o.z + t_best * d.z)
    tb = t_best - (2.0 * RAY_EPS) * rw       # RAY_EPS in object units
    point = V3(o.x + tb * d.x, o.y + tb * d.y, o.z + tb * d.z)
    inv_r = 1.0 / rw
    nr = V3((surf.x - cwx) * inv_r, (surf.y - cwy) * inv_r,
            (surf.z - cwz) * inv_r)
    ox_c = o.x - cwx
    oy_c = o.y - cwy
    oz_c = o.z - cwz
    outside = ox_c * ox_c + oy_c * oy_c + oz_c * oz_c > rw * rw
    flip = jnp.where(outside, 1.0, -1.0)
    normal = vec.normalize(V3(nr.x * flip, nr.y * flip, nr.z * flip))
    half = jnp.full((n,), 0.5, jnp.float32)  # uv unused (untextured elig.)
    zero_tan = (V3(*(jnp.zeros((n,), jnp.float32),) * 3) if tangents
                else None)
    return HitP(t=jnp.where(got, t_best, BIG), normal=normal,
                mat_id=matw, point=point, surf=surf,
                u=half, v=half, outside=outside, tan=zero_tan)


def intersect_planar(o: V3, d: V3, times, geoms: T.Geoms,
                     meshes: T.MeshBundle, geom_types: Tuple[int, ...],
                     packed_meshes: tuple = (),
                     mesh_ids: Tuple[int, ...] = (),
                     differentiable_mesh: bool = False,
                     alive=None,
                     sdf_kinds: Tuple = (),
                     any_hit: bool = False,
                     max_t=None,
                     tangents: bool = False,
                     sphere_batch: Tuple[int, ...] = (),
                     mesh=None) -> HitP:
    """Nearest hit over all geoms (statically unrolled merge;
    reference loop: src/pathtrace.cu:176-199).

    `mesh_ids[g]` (static) selects the PackedMesh8 of MESH geoms from
    `packed_meshes` (the parser packs every mesh scene). `alive` ([N]
    bool, optional) lets the mesh traversal skip terminated paths; the
    primitive tests are branchless per lane so masking would not speed
    them up. `mesh` (a device mesh with a 'data' axis, or None) runs the
    mesh traversal per shard (ops/bvh8.traverse).

    Occlusion queries (NEE shadow rays): `any_hit=True` lets the mesh
    traversal stop a ray at ANY triangle closer than its bound (only
    `t > 0` is meaningful, attributes are garbage), and `max_t` ([N],
    optional) caps the search so hits beyond the light report as miss
    (t = -1) and mesh subtrees beyond it are pruned."""
    n = o.x.shape[0]
    t_init = (jnp.full((n,), BIG, jnp.float32) if max_t is None
              else jnp.minimum(max_t, BIG))
    zero_tan = (V3(*(jnp.zeros((n,), jnp.float32),) * 3) if tangents
                else None)
    best = HitP(t=t_init,
                normal=V3(*(jnp.zeros((n,), jnp.float32),) * 3),
                mat_id=jnp.zeros((n,), jnp.int32),
                point=V3(*(jnp.zeros((n,), jnp.float32),) * 3),
                surf=V3(*(jnp.zeros((n,), jnp.float32),) * 3),
                u=jnp.zeros((n,), jnp.float32),
                v=jnp.zeros((n,), jnp.float32),
                outside=jnp.ones((n,), bool),
                tan=zero_tan)
    def merge(best, cand):
        closer = cand.t < best.t
        return HitP(
            t=jnp.where(closer, cand.t, best.t),
            normal=vec.where(closer, cand.normal, best.normal),
            mat_id=jnp.where(closer, cand.mat_id, best.mat_id),
            point=vec.where(closer, cand.point, best.point),
            surf=vec.where(closer, cand.surf, best.surf),
            u=jnp.where(closer, cand.u, best.u),
            v=jnp.where(closer, cand.v, best.v),
            outside=jnp.where(closer, cand.outside, best.outside),
            tan=(vec.where(closer, cand.tan, best.tan) if tangents
                 else None))

    # primitives first: their nearest hit becomes the meshes' occlusion
    # bound, letting the packet traversal prune subtrees behind known hits
    batched = set(sphere_batch)
    if batched:
        best = merge(best, _batched_spheres_planar(o, d, times, geoms,
                                                   sphere_batch,
                                                   tangents=tangents))
    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH or g in batched:
            continue
        if gtype == T.SDF:
            best = merge(best, _sdf_hit_planar(o, d, times, geoms, g,
                                               sdf_kinds[g],
                                               tangents=tangents))
        else:
            best = merge(best, _primitive_hit_planar(o, d, times, geoms, g,
                                                     gtype,
                                                     tangents=tangents))
    for g, gtype in enumerate(geom_types):
        if gtype != T.MESH:
            continue
        mid = mesh_ids[g] if g < len(mesh_ids) else -1
        if not 0 <= mid < len(packed_meshes):
            raise ValueError(f"MESH geom {g} has no packed BVH (mesh id "
                             f"{mid}, {len(packed_meshes)} packed meshes)")
        cand = _mesh_hit(
            o, d, times, geoms, packed_meshes[mid], g, meshes, mid,
            differentiable=differentiable_mesh,
            t_world_bound=best.t, alive=alive, any_hit=any_hit,
            tangents=tangents, mesh=mesh)
        best = merge(best, cand)
    miss = best.t >= t_init
    p, nrm = best.point, best.normal
    # ops/intersect.lift_off in planar form
    lift = RAY_EPS * (1.0 + jnp.maximum(jnp.maximum(jnp.abs(p.x),
                                                    jnp.abs(p.y)),
                                        jnp.abs(p.z)))
    return best._replace(t=jnp.where(miss, -1.0, best.t),
                         mat_id=jnp.where(miss, 0, best.mat_id),
                         point=V3(p.x + lift * nrm.x, p.y + lift * nrm.y,
                                  p.z + lift * nrm.z))


# ---------------------------------------------------------------------------
# Shading (reference contract: src/interactions.h:44-79, pathtrace.cu:224-266)
# ---------------------------------------------------------------------------

class ShadeOutP(NamedTuple):
    origin: V3
    direction: V3
    throughput: V3
    radiance: V3
    alive: jnp.ndarray
    # Set only under NEE (ops/nee.py): the solid-angle pdf of the chosen
    # continuation direction under the DIFFUSE lobe (p_diff * cos / pi),
    # 0 for specular/refractive/terminated lanes. The next bounce's
    # emissive hit is MIS-weighted against the light-sampling pdf of that
    # hit (balance heuristic); 0 means full weight.
    nee_pdf: Optional[jnp.ndarray] = None


# Above this material count _mat_select switches from the chained-select
# unroll to per-lane gathers. The unroll avoids [N] gathers for the
# handful of materials ordinary scenes carry (no [N] gathers), but its
# XLA graph is O(M) PER FETCH and a bounce makes ~15 fetches — at the
# many-light scale (hundreds of per-light materials, scenes/
# manylights256.txt) the compile explodes the same way the light-table
# unroll did (>50 min of CPU compile at 64 faces). Gathers on [M]-row
# tables are M-independent at compile time. Scenes at or below the
# threshold compile bitwise-identically to before. The threshold was set
# on the previous accelerator; an H100 cell decides it again.
MAT_UNROLL_MAX = 24


def _mat_select(table: jnp.ndarray, mat_id: jnp.ndarray):
    """Masked-select a [M] or [M,3] material column by per-ray id:
    unrolled chained selects for small M (no [N] gathers), per-lane
    takes above MAT_UNROLL_MAX (many-light scenes)."""
    m_count = table.shape[0]
    if m_count > MAT_UNROLL_MAX:
        if table.ndim == 1:
            return jnp.take(table, mat_id)
        return V3(jnp.take(table[:, 0], mat_id),
                  jnp.take(table[:, 1], mat_id),
                  jnp.take(table[:, 2], mat_id))
    if table.ndim == 1:
        acc = jnp.broadcast_to(table[0], mat_id.shape)
        for m in range(1, m_count):
            acc = jnp.where(mat_id == m, table[m], acc)
        return acc
    accs = [jnp.broadcast_to(table[0, c], mat_id.shape) for c in range(3)]
    for m in range(1, m_count):
        for c in range(3):
            accs[c] = jnp.where(mat_id == m, table[m, c], accs[c])
    return V3(*accs)


def _atlas_flat_index(textures: T.Textures, mat_id, u, v,
                      rect=None, tid_table=None):
    """(flat texel index [N] int32, textured mask) for the atlas fetch.
    `rect`/`tid_table` default to the color-texture tables; normal maps
    pass textures.nrm_rect/nrm_id (same strip, own rows)."""
    rect = textures.rect if rect is None else rect
    tid_table = textures.tex_id if tid_table is None else tid_table
    # unrolled per-material rect select (static M, no [N] gathers)
    rx = _mat_select(rect[:, 0].astype(jnp.float32), mat_id)
    ry = _mat_select(rect[:, 1].astype(jnp.float32), mat_id)
    rw = _mat_select(rect[:, 2].astype(jnp.float32), mat_id)
    rh = _mat_select(rect[:, 3].astype(jnp.float32), mat_id)
    tid = _mat_select(tid_table.astype(jnp.float32), mat_id)

    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    xi = rx + jnp.clip(jnp.floor(uu * rw), 0.0, jnp.maximum(rw - 1, 0.0))
    yi = ry + jnp.clip(jnp.floor((1.0 - vv) * rh), 0.0,
                       jnp.maximum(rh - 1, 0.0))
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    flat = (jnp.clip(yi, 0, ha - 1) * wa
            + jnp.clip(xi, 0, wa - 1)).astype(jnp.int32)
    return flat, tid >= 0


def _unpack_rgb8(p) -> V3:
    """R8G8B8 u32 texel -> linear f32 RGB (bitwise identical to the three
    f32 takes — utils/image.pack_rgb8)."""
    p = p.astype(jnp.int32)
    return V3((p & 0xFF).astype(jnp.float32) / 255.0,
              ((p >> 8) & 0xFF).astype(jnp.float32) / 255.0,
              ((p >> 16) & 0xFF).astype(jnp.float32) / 255.0)


def _env_flat_index(textures: T.Textures, d: V3):
    """Flat equirect texel index [N] int32 for the environment fetch."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    u = 0.5 + jnp.arctan2(d.x, -d.z) / (2.0 * jnp.pi)
    v = jnp.arccos(jnp.clip(d.y, -1.0, 1.0)) / jnp.pi
    xi = jnp.clip((u * we).astype(jnp.int32), 0, we - 1)
    yi = jnp.clip((v * he).astype(jnp.int32), 0, he - 1)
    return yi * we + xi


def _atlas_bilinear_indices(textures: T.Textures, mat_id, u, v):
    """Four corner texel indices + fractions for bilinear atlas
    filtering (--bilinear): texel centers at (x+0.5)/w, corners clamped
    to the material's atlas rect (no bleeding across atlas entries)."""
    rect, tid_table = textures.rect, textures.tex_id
    rx = _mat_select(rect[:, 0].astype(jnp.float32), mat_id)
    ry = _mat_select(rect[:, 1].astype(jnp.float32), mat_id)
    rw = _mat_select(rect[:, 2].astype(jnp.float32), mat_id)
    rh = _mat_select(rect[:, 3].astype(jnp.float32), mat_id)
    tid = _mat_select(tid_table.astype(jnp.float32), mat_id)
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    xf = uu * rw - 0.5
    yf = (1.0 - vv) * rh - 0.5
    x0 = jnp.floor(xf)
    y0 = jnp.floor(yf)
    fu = xf - x0
    fv = yf - y0
    # left-edge clamp: x0 < 0 means both horizontal corners clamp to
    # texel 0 so the lerp weight is irrelevant for the exact path — but
    # the PAIR plane (--bilinear-fast) always returns (t0, t1) there, so
    # fu must collapse to 0 to reproduce the clamped fetch.
    fu = jnp.where(x0 < 0.0, 0.0, fu)
    hi_x = jnp.maximum(rw - 1, 0.0)
    hi_y = jnp.maximum(rh - 1, 0.0)
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]

    def at(xc, yc):
        xi = rx + jnp.clip(xc, 0.0, hi_x)
        yi = ry + jnp.clip(yc, 0.0, hi_y)
        return (jnp.clip(yi, 0, ha - 1) * wa
                + jnp.clip(xi, 0, wa - 1)).astype(jnp.int32)

    return (at(x0, y0), at(x0 + 1, y0), at(x0, y0 + 1),
            at(x0 + 1, y0 + 1), fu, fv, tid >= 0)


def _env_bilinear_indices(textures: T.Textures, d: V3):
    """Four corner texel indices + fractions for bilinear equirect
    filtering: longitude wraps, latitude clamps at the poles."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    u = 0.5 + jnp.arctan2(d.x, -d.z) / (2.0 * jnp.pi)
    # 1e-7 inset mirrors the sphere-uv guard: arccos'(+-1) = inf would
    # NaN live-direction gradients on straight-up/down lanes
    v = jnp.arccos(jnp.clip(d.y, -1.0 + 1e-7, 1.0 - 1e-7)) / jnp.pi
    xf = u * we - 0.5
    yf = v * he - 0.5
    x0 = jnp.floor(xf)
    y0 = jnp.floor(yf)
    fu = xf - x0
    fv = yf - y0

    def at(xc, yc):
        xi = jnp.mod(xc, we)                        # longitude wrap
        yi = jnp.clip(yc, 0, he - 1)                # pole clamp
        return (yi * we + xi).astype(jnp.int32)

    return (at(x0, y0), at(x0 + 1, y0), at(x0, y0 + 1),
            at(x0 + 1, y0 + 1), fu, fv)


def _unpack_565pair(p):
    """One atlas_pair u32 -> (texel, right-neighbor texel) as linear f32
    RGB at RGB565 precision (scene/types.py atlas_pair; parser builds the
    plane with in-rect neighbor clamping). Masks after the arithmetic
    shifts make int32 sign-extension harmless."""
    p = p.astype(jnp.int32)

    def one(q):
        return V3((q & 31).astype(jnp.float32) / 31.0,
                  ((q >> 5) & 63).astype(jnp.float32) / 63.0,
                  ((q >> 11) & 31).astype(jnp.float32) / 31.0)

    return one(p), one(p >> 16)


def _unpack_envpair(p, scale):
    """One env_pair u32 -> (texel, right-neighbor texel) as linear f32
    HDR RGB (utils/image.pack_env_pair): two 12-bit 4/4/4 mini-RGBE
    texels sharing one 8-bit exponent; channel = (m + 0.5) * 2^(E-132).
    The power of two is bit-constructed like _unpack_rgbe's (exact, no
    exp2 approximation); E == 0 decodes to black."""
    ex = ((p >> 24) & 0xFF).astype(jnp.int32)
    pot = jax.lax.bitcast_convert_type(
        jnp.clip(ex - 5, 1, 254) << 23, jnp.float32)
    s = jnp.where(ex > 0, pot, 0.0) * scale
    q = p.astype(jnp.int32)

    def one(t):
        return V3(((t & 15).astype(jnp.float32) + 0.5) * s,
                  (((t >> 4) & 15).astype(jnp.float32) + 0.5) * s,
                  (((t >> 8) & 15).astype(jnp.float32) + 0.5) * s)

    return one(q), one(q >> 12)


def _bilerp(c00: V3, c10: V3, c01: V3, c11: V3, fu, fv) -> V3:
    a = V3(c00.x + (c10.x - c00.x) * fu, c00.y + (c10.y - c00.y) * fu,
           c00.z + (c10.z - c00.z) * fu)
    b = V3(c01.x + (c11.x - c01.x) * fu, c01.y + (c11.y - c01.y) * fu,
           c01.z + (c11.z - c01.z) * fu)
    return V3(a.x + (b.x - a.x) * fv, a.y + (b.y - a.y) * fv,
              a.z + (b.z - a.z) * fv)


def _unpack_rgbe(p, scale) -> V3:
    """Radiance RGBE u32 texel -> linear f32 RGB (bitwise identical to the
    three f32 takes — utils/image.pack_rgbe)."""
    ex = ((p >> 24) & 0xFF).astype(jnp.int32)
    p = p.astype(jnp.int32)
    # 2^(ex-136) built exactly by bit-constructing the f32 exponent
    # field (hardware exp2 is an approximation); the biased exponent
    # ex-9 is clamped to the normal range — the load-time roundtrip
    # guard (scene/parser.py) falls back to the f32 planes for any
    # asset with sub-2^-126 radiance texels.
    pot = jax.lax.bitcast_convert_type(
        jnp.clip(ex - 9, 1, 254) << 23, jnp.float32)
    s = jnp.where(ex > 0, pot, 0.0) * scale
    return V3(((p & 0xFF).astype(jnp.float32) + 0.5) * s,
              (((p >> 8) & 0xFF).astype(jnp.float32) + 0.5) * s,
              (((p >> 16) & 0xFF).astype(jnp.float32) + 0.5) * s)


def _sample_texture_planar(textures: T.Textures, mat_id, u, v,
                           base: V3) -> V3:
    """Nearest-neighbor atlas fetch as three 1-D takes on [Ha*Wa] planes.

    The row-based version ([N,3]-output 2-D fancy indexing) lowers to a
    gather whose result carries the length-3 lane axis — planar flat takes
    are the fast form of the same random access."""
    flat, textured = _atlas_flat_index(textures, mat_id, u, v)
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    if textures.atlas_packed.shape[0] == ha * wa:
        # single-gather path: one u32 take + elementwise R8G8B8 unpack
        rgb = _unpack_rgb8(jnp.take(textures.atlas_packed, flat))
    else:
        rgb = V3(jnp.take(textures.atlas[:, :, 0].reshape(-1), flat),
                 jnp.take(textures.atlas[:, :, 1].reshape(-1), flat),
                 jnp.take(textures.atlas[:, :, 2].reshape(-1), flat))
    return vec.where(textured, rgb, base)


def _sample_env_planar(textures: T.Textures, d: V3) -> V3:
    """Equirect environment fetch as three 1-D takes (see above)."""
    he, we = textures.env.shape[0], textures.env.shape[1]
    flat = _env_flat_index(textures, d)
    scale = textures.env_enabled
    if textures.env_packed.shape[0] == he * we:
        # single-gather path: one u32 take + elementwise RGBE unpack
        return _unpack_rgbe(jnp.take(textures.env_packed, flat), scale)
    return V3(jnp.take(textures.env[:, :, 0].reshape(-1), flat) * scale,
              jnp.take(textures.env[:, :, 1].reshape(-1), flat) * scale,
              jnp.take(textures.env[:, :, 2].reshape(-1), flat) * scale)


def cosine_hemisphere_planar(n: V3, u1, u2) -> V3:
    """calculateRandomDirectionInHemisphere (src/interactions.h:10-42)."""
    up = jnp.sqrt(u1)
    over = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    around = u2 * TWO_PI

    pick_x = jnp.abs(n.x) < SQRT_OF_ONE_THIRD
    pick_y = (~pick_x) & (jnp.abs(n.y) < SQRT_OF_ONE_THIRD)
    not_n = V3(jnp.where(pick_x, 1.0, 0.0),
               jnp.where(pick_y, 1.0, 0.0),
               jnp.where(pick_x | pick_y, 0.0, 1.0))
    p1 = vec.normalize(vec.cross(n, not_n))
    p2 = vec.normalize(vec.cross(n, p1))
    c = jnp.cos(around) * over
    s = jnp.sin(around) * over
    return V3(up * n.x + c * p1.x + s * p2.x,
              up * n.y + c * p1.y + s * p2.y,
              up * n.z + c * p1.z + s * p2.z)


def reflect_planar(d: V3, n: V3) -> V3:
    k = 2.0 * vec.dot(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def shade_planar(hit: HitP, ray_d: V3, throughput: V3, alive, materials,
                 textures: T.Textures, uniforms: jnp.ndarray,
                 last_bounce, glossy: bool = True,
                 sky: bool = True, nee=None,
                 nee_area: float = 0.0, nee_env_c: float = 0.0,
                 nee_q: float = 1.0, bump: bool = False,
                 nmap: bool = False, dispersion: bool = False,
                 bilinear: bool = False,
                 bilinear_fast: bool = False) -> ShadeOutP:
    """One scattering step over the wavefront; uniforms is [4,N].

    `glossy` / `sky` (static) gate the Phong-lobe and procedural-sky math —
    both contain pow(), a transcendental the VPU pays for on every lane, so
    scenes that don't use them skip the work entirely.

    `nee` (ops/nee.py; None = plain BSDF sampling) is the strategy-agnostic
    tuple (wl V3, vis [N] bool, le V3, pdf_l [N], prev_pdf [N]): the
    shadow-tested light sample for this bounce — direction, visibility,
    emitted radiance, and the sampler's EFFECTIVE solid-angle pdf (the
    conditional pdf times the strategy-selection probability, built in
    render/integrator) — plus the previous bounce's BSDF-lobe pdf. Light
    and BSDF sampling are combined with the one-sample MIS balance
    heuristic: the NEE contribution's weight collapses to raw/(1+raw)
    (raw = pdf_bsdf/pdf_l — bounded, so the classic near-light 1/d^2
    area-sampling spike cannot occur), and BSDF-sampled light hits are
    weighted prev_pdf/(prev_pdf + pdf_light(hit)) with prev_pdf==0
    meaning full weight (camera/specular rays).

    The BSDF-side light pdfs are rebuilt from statics: `nee_area` > 0
    enables the area-light weight on emissive hits (union surface area;
    pdf = d^2/(cos*area)); `nee_env_c` > 0 enables the env weight on
    misses (pdf(d) = lum(d)*C — free off the already-fetched texel).
    When BOTH strategies are live (a scene with area lights AND an HDR
    env), `nee_q` is the static probability the integrator sampled the
    area union (1-q the env map); each side's pdf is scaled by its
    selection probability, which keeps every weight pair summing to 1 —
    the mixture stays unbiased because an env sample occluded by a light
    (and vice versa) is killed by its own shadow test, so each transport
    path is covered by exactly two strategies."""
    mat_id = hit.mat_id
    albedo = _mat_select(materials.color, mat_id)

    has_atlas = textures.atlas.shape[0] > 1 or textures.atlas.shape[1] > 1
    has_env = textures.env.shape[0] > 1 or textures.env.shape[1] > 1
    ha, wa = textures.atlas.shape[0], textures.atlas.shape[1]
    he, we = textures.env.shape[0], textures.env.shape[1]
    # Fused texture+environment fetch: the atlas is read for HIT lanes and
    # the env map for MISSED lanes — disjoint — so both ride ONE u32 take
    # on the concatenated packed tables (this halves the per-bounce
    # random-access gather count). The
    # cross-unpacked garbage (env texel RGB8-decoded on hit lanes and vice
    # versa) lands only in values masked off below — images bit-identical.
    fuse = (has_atlas and has_env
            and textures.atlas_packed.shape[0] == ha * wa
            and textures.env_packed.shape[0] == he * we)
    has_pair = textures.atlas_pair.shape[0] == ha * wa
    has_env_pair = textures.env_pair.shape[0] == he * we
    env_fused = None
    if fuse and bilinear and bilinear_fast and has_pair and has_env_pair:
        # --bilinear-fast with BOTH pair planes (round 5): the env's four
        # bilinear corners ride the SAME two u32 gathers as the atlas —
        # env_pair entries carry (texel, (x+1) mod W neighbor) as two
        # 12-bit shared-exponent mini-RGBE texels (utils/image.
        # pack_env_pair), so rows y0/y0+1 supply all four corners for hit
        # AND miss lanes. Quality contract: 5/6-bit atlas, pair_max/16
        # env error (tests/test_bilinear.py bounds both).
        on_env = hit.t <= 0.0
        a00, _, a01, _, fua, fva, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        e00, _, e01, _, fue, fve = _env_bilinear_indices(textures, ray_d)
        table = jnp.concatenate([textures.atlas_pair, textures.env_pair])
        p_top = jnp.take(table, jnp.where(on_env, e00 + ha * wa, a00))
        p_bot = jnp.take(table, jnp.where(on_env, e01 + ha * wa, a01))
        c00, c10 = _unpack_565pair(p_top)
        c01, c11 = _unpack_565pair(p_bot)
        albedo = vec.where(textured & ~on_env,
                           _bilerp(c00, c10, c01, c11, fua, fva), albedo)
        ec00, ec10 = _unpack_envpair(p_top, textures.env_enabled)
        ec01, ec11 = _unpack_envpair(p_bot, textures.env_enabled)
        env_fused = _bilerp(ec00, ec10, ec01, ec11, fue, fve)
    elif fuse and bilinear and bilinear_fast and has_pair:
        # atlas pair plane only (env_pair absent): TWO u32 gathers; env
        # (miss) lanes ride the same takes as a NEAREST RGBE fetch.
        on_env = hit.t <= 0.0
        a00, _, a01, _, fu, fv, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        eflat = _env_flat_index(textures, ray_d)
        table = jnp.concatenate([textures.atlas_pair,
                                 textures.env_packed])
        p_top = jnp.take(table, jnp.where(on_env, eflat + ha * wa, a00))
        p_bot = jnp.take(table, jnp.where(on_env, eflat + ha * wa, a01))
        c00, c10 = _unpack_565pair(p_top)
        c01, c11 = _unpack_565pair(p_bot)
        albedo = vec.where(textured & ~on_env,
                           _bilerp(c00, c10, c01, c11, fu, fv), albedo)
        env_fused = _unpack_rgbe(p_top, textures.env_enabled)
    elif has_atlas and bilinear and bilinear_fast and has_pair:
        a00, _, a01, _, fu, fv, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        c00, c10 = _unpack_565pair(jnp.take(textures.atlas_pair, a00))
        c01, c11 = _unpack_565pair(jnp.take(textures.atlas_pair, a01))
        albedo = vec.where(textured,
                           _bilerp(c00, c10, c01, c11, fu, fv), albedo)
    elif fuse and bilinear:
        # bilinear filtering (--bilinear): 4 fused corner fetches + lerp
        # (4x the gather cost — opt-in quality; nearest is the default
        # like the reference's stb-free sampling)
        on_env = hit.t <= 0.0
        a00, a10, a01, a11, fua, fva, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        e00, e10, e01, e11, fue, fve = _env_bilinear_indices(
            textures, ray_d)
        fu = jnp.where(on_env, fue, fua)
        fv = jnp.where(on_env, fve, fva)
        table = jnp.concatenate([textures.atlas_packed,
                                 textures.env_packed])
        ps = [jnp.take(table, jnp.where(on_env, e + ha * wa, a))
              for a, e in ((a00, e00), (a10, e10), (a01, e01), (a11, e11))]
        albedo = vec.where(
            textured & ~on_env,
            _bilerp(*[_unpack_rgb8(p) for p in ps], fu, fv), albedo)
        env_fused = _bilerp(
            *[_unpack_rgbe(p, textures.env_enabled) for p in ps], fu, fv)
    elif fuse:
        aflat, textured = _atlas_flat_index(textures, mat_id, hit.u, hit.v)
        eflat = _env_flat_index(textures, ray_d)
        on_env = hit.t <= 0.0
        idx = jnp.where(on_env, eflat + ha * wa, aflat)
        p = jnp.take(
            jnp.concatenate([textures.atlas_packed, textures.env_packed]),
            idx)
        albedo = vec.where(textured & ~on_env, _unpack_rgb8(p), albedo)
        env_fused = _unpack_rgbe(p, textures.env_enabled)
    elif has_atlas and bilinear \
            and textures.atlas_packed.shape[0] == ha * wa:
        a00, a10, a01, a11, fu, fv, textured = _atlas_bilinear_indices(
            textures, mat_id, hit.u, hit.v)
        cs4 = [_unpack_rgb8(jnp.take(textures.atlas_packed, i))
               for i in (a00, a10, a01, a11)]
        albedo = vec.where(textured, _bilerp(*cs4, fu, fv), albedo)
    elif has_atlas:
        albedo = _sample_texture_planar(textures, mat_id, hit.u, hit.v,
                                        albedo)
    # procedural checker (pure elementwise, no gathers)
    cs = _mat_select(textures.checker_scale, mat_id)
    c2 = _mat_select(textures.checker_color2, mat_id)
    par = jnp.mod(jnp.floor(hit.u * cs) + jnp.floor(hit.v * cs), 2.0)
    albedo = vec.where((cs > 0) & (par > 0.5), c2, albedo)
    spec_color = _mat_select(materials.specular_color, mat_id)
    emittance = _mat_select(materials.emittance, mat_id)
    p_refr = jnp.clip(_mat_select(materials.has_refractive, mat_id), 0., 1.)
    p_spec = (jnp.clip(_mat_select(materials.has_reflective, mat_id), 0., 1.)
              * (1.0 - p_refr))
    p_diff = jnp.maximum(1.0 - p_refr - p_spec, 0.0)
    ior = _mat_select(materials.ior, mat_id)

    hit_ok = hit.t > 0.0
    is_light = hit_ok & (emittance > 0.0)
    missed = ~hit_ok

    # --- bump / normal mapping (both static-gated; INSTRUCTION.md's
    # "Texture mapping AND Bump mapping" item) ------------------------------
    # Shading normal n_sh replaces the geometric normal in every scatter/
    # cosine term below; the geometric normal keeps its roles in the
    # light-hit MIS pdf (a property of the LIGHT surface) and in the
    # origin back-off (hit.point was already offset along the ray).
    n_sh = hit.normal
    if bump:
        # Procedural world-space bump: h(p) = sin(f x) sin(f y) sin(f z),
        # analytic gradient projected onto the tangent plane — pure
        # elementwise (no gathers, like the checker texture).
        bs = _mat_select(textures.bump[:, 0], mat_id)
        bf = _mat_select(textures.bump[:, 1], mat_id)
        px, py, pz = hit.surf.x * bf, hit.surf.y * bf, hit.surf.z * bf
        sx_, sy_, sz_ = jnp.sin(px), jnp.sin(py), jnp.sin(pz)
        grad = V3(bf * jnp.cos(px) * sy_ * sz_,
                  bf * sx_ * jnp.cos(py) * sz_,
                  bf * sx_ * sy_ * jnp.cos(pz))
        gn = vec.dot(grad, n_sh)
        pert = vec.normalize(V3(n_sh.x - bs * (grad.x - gn * n_sh.x),
                                n_sh.y - bs * (grad.y - gn * n_sh.y),
                                n_sh.z - bs * (grad.z - gn * n_sh.z)))
        n_sh = vec.where(bs > 0.0, pert, n_sh)
    if nmap and hit.tan is not None:
        # File-loaded tangent-space normal map: one extra texel gather on
        # the same packed atlas strip; frame = uv tangent from the
        # intersect stage (intersect_planar(tangents=True)), Gram-Schmidt
        # against n, normal-derived fallback where dP/du degenerates.
        nflat, has_map = _atlas_flat_index(textures, mat_id, hit.u, hit.v,
                                           rect=textures.nrm_rect,
                                           tid_table=textures.nrm_id)
        ha_, wa_ = textures.atlas.shape[0], textures.atlas.shape[1]
        if textures.atlas_packed.shape[0] == ha_ * wa_:
            texel = _unpack_rgb8(jnp.take(textures.atlas_packed, nflat))
        else:
            texel = V3(jnp.take(textures.atlas[:, :, 0].reshape(-1), nflat),
                       jnp.take(textures.atlas[:, :, 1].reshape(-1), nflat),
                       jnp.take(textures.atlas[:, :, 2].reshape(-1), nflat))
        tn = V3(texel.x * 2.0 - 1.0, texel.y * 2.0 - 1.0,
                texel.z * 2.0 - 1.0)
        tdn = vec.dot(hit.tan, n_sh)
        tperp = V3(hit.tan.x - tdn * n_sh.x, hit.tan.y - tdn * n_sh.y,
                   hit.tan.z - tdn * n_sh.z)
        tlen2 = vec.dot(tperp, tperp)
        # fallback frame (the SQRT_OF_ONE_THIRD trick on n)
        fx = jnp.abs(n_sh.x) < SQRT_OF_ONE_THIRD
        fy = (~fx) & (jnp.abs(n_sh.y) < SQRT_OF_ONE_THIRD)
        not_n = V3(jnp.where(fx, 1.0, 0.0), jnp.where(fy, 1.0, 0.0),
                   jnp.where(fx | fy, 0.0, 1.0))
        t_fb = vec.normalize(vec.cross(n_sh, not_n))
        ok_t = tlen2 > 1e-12
        inv_l = jax.lax.rsqrt(jnp.maximum(tlen2, 1e-12))
        t_dir = vec.where(ok_t, V3(tperp.x * inv_l, tperp.y * inv_l,
                                   tperp.z * inv_l), t_fb)
        b_dir = vec.cross(n_sh, t_dir)
        n_map = vec.normalize(V3(
            t_dir.x * tn.x + b_dir.x * tn.y + n_sh.x * tn.z,
            t_dir.y * tn.x + b_dir.y * tn.y + n_sh.y * tn.z,
            t_dir.z * tn.x + b_dir.z * tn.y + n_sh.z * tn.z))
        # keep the perturbed normal on the geometric hemisphere (extreme
        # texels at grazing frames could flip it and leak light)
        keep = has_map & (vec.dot(n_map, hit.normal) > 1e-3)
        n_sh = vec.where(keep, n_map, n_sh)
    if bump or nmap:
        hit = hit._replace(normal=n_sh)

    # env lighting only when enabled (static shape check)
    if env_fused is not None:
        env = env_fused
    elif has_env and bilinear and bilinear_fast and has_env_pair:
        # env-only --bilinear-fast: 2 pair gathers give all 4 corners
        e00, _, e01, _, fu, fv = _env_bilinear_indices(textures, ray_d)
        ec00, ec10 = _unpack_envpair(jnp.take(textures.env_pair, e00),
                                     textures.env_enabled)
        ec01, ec11 = _unpack_envpair(jnp.take(textures.env_pair, e01),
                                     textures.env_enabled)
        env = _bilerp(ec00, ec10, ec01, ec11, fu, fv)
    elif has_env and bilinear and textures.env_packed.shape[0] == he * we:
        e00, e10, e01, e11, fu, fv = _env_bilinear_indices(textures, ray_d)
        env = _bilerp(*[_unpack_rgbe(jnp.take(textures.env_packed, i),
                                     textures.env_enabled)
                        for i in (e00, e10, e01, e11)], fu, fv)
    elif has_env:
        env = _sample_env_planar(textures, ray_d)
    else:
        e = textures.env[0, 0] * textures.env_enabled
        env = vec.splat((e[0], e[1], e[2]), like=hit.t)
    if sky:
        # procedural sky (elementwise): horizon->zenith gradient + sun lobe
        sk = textures.sky
        up_t = jnp.clip(ray_d.y, 0.0, 1.0)
        sun = vec.normalize(V3(sk[7] + jnp.zeros_like(up_t),
                               sk[8] + jnp.zeros_like(up_t),
                               sk[9] + jnp.zeros_like(up_t)))
        sun_cos = jnp.clip(vec.dot(ray_d, sun), 0.0, 1.0)
        sun_lobe = jnp.power(sun_cos, jnp.maximum(sk[13], 1.0))
        sky_rgb = V3(
            sk[4] + (sk[1] - sk[4]) * up_t + sk[10] * sun_lobe,
            sk[5] + (sk[2] - sk[5]) * up_t + sk[11] * sun_lobe,
            sk[6] + (sk[3] - sk[6]) * up_t + sk[12] * sun_lobe)
        env = env + sky_rgb * sk[0]

    lit = alive & is_light
    mis = alive & missed
    rad_scale = jnp.where(lit, emittance, 0.0)
    if nee is not None and nee_area > 0.0:
        # MIS-weight the emissive BSDF hit against the light-sampling pdf
        # of the SAME point (balance heuristic). prev_pdf == 0 means the
        # previous event was camera/specular/glossy: full weight.
        prev_pdf = nee[4]
        cos_l_hit = jnp.abs(vec.dot(hit.normal, ray_d))
        pdf_l_hit = (hit.t * hit.t) / jnp.maximum(cos_l_hit * nee_area,
                                                  1e-9)
        if nee_q != 1.0:   # mixed mode: scale by the selection probability
            pdf_l_hit = pdf_l_hit * nee_q
        w_hit = jnp.where(prev_pdf > 0.0,
                          prev_pdf / jnp.maximum(prev_pdf + pdf_l_hit,
                                                 1e-30), 1.0)
        rad_scale = rad_scale * w_hit
    if nee is not None and nee_env_c > 0.0:
        # MIS-weight the env MISS against the env-sampling pdf of the
        # same direction — free: pdf(d) = lum(fetched texel) * C.
        from . import nee as nee_mod
        prev_pdf = nee[4]
        pdf_env_dir = nee_mod.env_lum(env) * nee_env_c
        if nee_q != 0.0:   # mixed mode: scale by the selection probability
            pdf_env_dir = pdf_env_dir * (1.0 - nee_q)
        w_env = jnp.where(prev_pdf > 0.0,
                          prev_pdf / jnp.maximum(prev_pdf + pdf_env_dir,
                                                 1e-30), 1.0)
        env = V3(env.x * w_env, env.y * w_env, env.z * w_env)
    radiance = V3(
        jnp.where(lit, throughput.x * albedo.x * rad_scale,
                  jnp.where(mis, throughput.x * env.x, 0.0)),
        jnp.where(lit, throughput.y * albedo.y * rad_scale,
                  jnp.where(mis, throughput.y * env.y, 0.0)),
        jnp.where(lit, throughput.z * albedo.z * rad_scale,
                  jnp.where(mis, throughput.z * env.z, 0.0)))

    # (the NEE direct-light contribution is added after the lobe section —
    # it evaluates the glossy lobe's pdf around the mirror axis)

    # --- lobe selection (detached) ----------------------------------------
    u_lobe = jax.lax.stop_gradient(uniforms[0])
    take_refr = u_lobe < p_refr
    take_spec = (~take_refr) & (u_lobe < p_refr + p_spec)

    n = hit.normal
    d_diff = cosine_hemisphere_planar(n, uniforms[1], uniforms[2])
    d_spec = reflect_planar(ray_d, n)
    d_mirror = d_spec  # pure mirror axis (NEE glossy-lobe pdf evaluation)

    # Glossy Phong lobe: SPECEX > 0 widens the perfect mirror into a
    # cos^n lobe around the reflection direction (the Material.specular
    # .exponent field the reference defines, src/sceneStructs.h:33-35).
    if not glossy:
        spec_exp = None
    else:
      spec_exp = _mat_select(materials.specular_exponent, mat_id)
      cos_a = jnp.power(jnp.clip(uniforms[1], 1e-9, 1.0),
                        1.0 / (spec_exp + 1.0))
      # 1e-20 floor: at u ~ 1 cos_a rounds to 1.0 and sqrt(0) has an
      # infinite derivative — the floor zeroes the tangent there instead
      # of NaN-ing the SPECEX gradient (primal shift <= 1e-10 in one
      # direction component). The exponent gradient flows through cos_a
      # (reparameterized Phong-lobe sample; see the scatter-direction
      # gradient note below).
      sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 1e-20))
      phi_g = uniforms[2] * TWO_PI
      pick_gx = jnp.abs(d_spec.x) < SQRT_OF_ONE_THIRD
      pick_gy = (~pick_gx) & (jnp.abs(d_spec.y) < SQRT_OF_ONE_THIRD)
      not_s = V3(jnp.where(pick_gx, 1.0, 0.0),
                 jnp.where(pick_gy, 1.0, 0.0),
                 jnp.where(pick_gx | pick_gy, 0.0, 1.0))
      g1 = vec.normalize(vec.cross(d_spec, not_s))
      g2 = vec.cross(d_spec, g1)
      cg = jnp.cos(phi_g) * sin_a
      sg = jnp.sin(phi_g) * sin_a
      d_gloss = V3(cos_a * d_spec.x + cg * g1.x + sg * g2.x,
                   cos_a * d_spec.y + cg * g1.y + sg * g2.y,
                   cos_a * d_spec.z + cg * g1.z + sg * g2.z)
      # keep the glossy sample above the surface; fall back to the mirror
      above = vec.dot(d_gloss, n) > 0.0
      d_gloss = vec.where(above, d_gloss, d_spec)
      d_spec = vec.where(spec_exp > 0.0, d_gloss, d_spec)

    disp_scale = None
    if dispersion:
        # Spectral dispersion (MATERIAL key DISPERSION d): refraction
        # samples ONE RGB wavelength band per path — detached reuse of
        # the lobe draw (u_lobe/p_refr is U[0,1) again within the
        # refractive branch) — and refracts with ior + d*(ch-1): red
        # bends least, blue most. The path's throughput collapses to 3x
        # that channel; E[3 * onehot_ch * L_ch] = sum_ch L_ch, so white
        # light stays unbiased and caustics split into rainbows.
        disp = _mat_select(materials.dispersion, mat_id)
        u_ch = jax.lax.stop_gradient(
            jnp.clip(u_lobe / jnp.maximum(p_refr, 1e-9), 0.0, 1.0 - 1e-7))
        ch = jnp.floor(u_ch * 3.0)
        dispersing = take_refr & (disp > 0.0)
        ior = jnp.where(dispersing, ior + disp * (ch - 1.0), ior)
        one = jnp.ones_like(ior)
        disp_scale = V3(
            jnp.where(dispersing, jnp.where(ch == 0, 3.0, 0.0), one),
            jnp.where(dispersing, jnp.where(ch == 1, 3.0, 0.0), one),
            jnp.where(dispersing, jnp.where(ch == 2, 3.0, 0.0), one))

    outside = hit.outside
    safe_ior = jnp.maximum(ior, 1e-6)
    eta = jnp.where(outside, 1.0 / safe_ior, safe_ior)
    cos_i = jnp.clip(-vec.dot(ray_d, n), 0.0, 1.0)
    eta_i = jnp.where(outside, 1.0, ior)
    eta_t = jnp.where(outside, ior, 1.0)
    r0 = ((eta_i - eta_t) / (eta_i + eta_t)) ** 2
    fres = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5

    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    # 1e-20 floor: on TIR lanes 1-sin2_t clamps and sqrt(0)'s infinite
    # derivative would NaN the IOR gradient (0 cotangent * inf = NaN)
    # even though d_refr is replaced by the mirror there; the floor makes
    # the dead branch's tangent finite (primal shift <= 1e-10, unused).
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-20))
    k_r = eta * cos_i - cos_t
    d_refr = V3(eta * ray_d.x + k_r * n.x,
                eta * ray_d.y + k_r * n.y,
                eta * ray_d.z + k_r * n.z)
    u_fres = jax.lax.stop_gradient(uniforms[3])
    refl_instead = tir | (u_fres < jax.lax.stop_gradient(fres))
    d_refr = vec.where(refl_instead, d_spec, d_refr)

    # Scatter-direction gradients (differentiable delta/glossy chains —
    # BASELINE north star names IOR and roughness): the DIFFUSE sample
    # stays detached (the detached-sampling convention, header comment —
    # reparameterizing the cosine-hemisphere draw buys nothing for
    # material gradients and amplifies visibility-discontinuity noise),
    # but the mirror/refraction directions are DETERMINISTIC functions of
    # (ior, geometry) and the glossy direction is a REPARAMETERIZED
    # Phong-lobe sample (cos_a = u^(1/(e+1)) with u fixed), so those
    # lanes keep their tangents: d(image)/d(REFRIOR) flows through
    # d_refr's eta and d(image)/d(SPECEX) through cos_a
    # (tests/test_grad.py FD checks). Primal values are unchanged.
    # Caveat (documented, standard for detached estimators): the
    # reflect-vs-refract BERNOULLI decision keeps probability fres with
    # weight 1, so the d(fres)/d(ior) score term is not estimated — the
    # gradient covers the transport-geometry dependence, which dominates.
    d_diff = V3(jax.lax.stop_gradient(d_diff.x),
                jax.lax.stop_gradient(d_diff.y),
                jax.lax.stop_gradient(d_diff.z))
    new_dir = vec.where(take_refr, d_refr,
                        vec.where(take_spec, d_spec, d_diff))
    new_dir = vec.normalize(new_dir)

    if nee is not None:
        # Direct light through the surface's non-delta components, with
        # per-component one-sample MIS (balance heuristic):
        #   diffuse: albedo * le * pdf_bd / (pdf_l + pdf_bd)
        #   glossy:  spec_color * le * q_l / (pdf_l + p_spec * q_l)
        # where pdf_bd = p_diff*cos_s/pi, q_l = (e+1)/(2pi)*cos^e(angle
        # to the mirror axis), and pdf_l is the light sampler's
        # solid-angle pdf (area form 1/geom; env form lum*C). Skipped on
        # the last bounce so the estimator covers exactly the transport
        # of the plain estimator at equal depth (ops/nee.py).
        wl, vis, le_n, pdf_l = nee[0], nee[1], nee[2], nee[3]
        cos_s = jnp.clip(vec.dot(hit.normal, wl), 0.0, None)
        nee_ok = alive & hit_ok & ~is_light & ~last_bounce & vis
        pdf_bd = p_diff * cos_s * (1.0 / jnp.pi)
        wd = jnp.where(nee_ok, pdf_bd / (pdf_l + pdf_bd + 1e-30), 0.0)
        fx = albedo.x * wd
        fy = albedo.y * wd
        fz = albedo.z * wd
        if glossy:
            cos_al = jnp.clip(vec.dot(wl, d_mirror), 1e-9, 1.0)
            q_l = ((spec_exp + 1.0) * (0.5 / jnp.pi)
                   * jnp.power(cos_al, spec_exp))
            q_l = jnp.where((spec_exp > 0.0) & (cos_s > 0.0), q_l, 0.0)
            wg = jnp.where(nee_ok,
                           q_l / (pdf_l + p_spec * q_l + 1e-30), 0.0)
            fx = fx + spec_color.x * wg
            fy = fy + spec_color.y * wg
            fz = fz + spec_color.z * wg
        radiance = V3(radiance.x + throughput.x * le_n.x * fx,
                      radiance.y + throughput.y * le_n.y * fy,
                      radiance.z + throughput.z * le_n.z * fz)

    inv_pd = 1.0 / jnp.maximum(p_diff, 1e-6)
    inv_ps = 1.0 / jnp.maximum(p_spec, 1e-6)
    inv_pr = 1.0 / jnp.maximum(p_refr, 1e-6)
    factor = vec.where(
        take_refr, spec_color * inv_pr,
        vec.where(take_spec, spec_color * inv_ps, albedo * inv_pd))
    if dispersion:
        factor = V3(factor.x * disp_scale.x, factor.y * disp_scale.y,
                    factor.z * disp_scale.z)

    scattering = alive & hit_ok & ~is_light
    new_throughput = vec.where(scattering, throughput * factor, throughput)

    # transmitted rays start just past the EXACT surface point; reflected/
    # diffuse rays keep the backed-off point (safe side of the surface)
    transmit = take_refr & ~refl_instead
    base_x = jnp.where(transmit, hit.surf.x, hit.point.x)
    base_y = jnp.where(transmit, hit.surf.y, hit.point.y)
    base_z = jnp.where(transmit, hit.surf.z, hit.point.z)
    push = jnp.where(transmit, 2.0 * RAY_EPS, 0.0)
    new_origin = V3(base_x + push * new_dir.x,
                    base_y + push * new_dir.y,
                    base_z + push * new_dir.z)

    still_alive = scattering & ~last_bounce
    nee_pdf = None
    if nee is not None:
        # Strategy density of the CHOSEN lobe at the chosen direction —
        # the next emissive hit / env miss is balance-weighted against
        # the light sampler with this. 0 = delta lobes (mirror, refr,
        # below-surface glossy fallback): full weight, NEE never covers
        # them.
        take_diff_cont = still_alive & ~take_refr & ~take_spec
        cos_next = jnp.clip(vec.dot(n, new_dir), 0.0, None)
        nee_pdf = jnp.where(take_diff_cont,
                            p_diff * cos_next * (1.0 / jnp.pi), 0.0)
        if glossy:
            q_samp = ((spec_exp + 1.0) * (0.5 / jnp.pi)
                      * jnp.power(jnp.clip(cos_a, 1e-9, 1.0), spec_exp))
            gloss_cont = (still_alive & take_spec & (spec_exp > 0.0)
                          & above)
            nee_pdf = jnp.where(gloss_cont, p_spec * q_samp, nee_pdf)
    return ShadeOutP(origin=new_origin, direction=new_dir,
                     throughput=new_throughput, radiance=radiance,
                     alive=still_alive, nee_pdf=nee_pdf)
