"""Intersection stage (wavefront stage 2).

Structure-of-arrays re-design of computeIntersections + the device intersection
library (reference: src/pathtrace.cu:149-213, src/intersections.h:27-144).

Semantics preserved from the reference:
  * rays are transformed to object space via inverseTransform; object-space
    directions re-normalized (src/intersections.h:51-52,106-107)
  * canonical primitives: unit cube [-0.5,0.5]^3, sphere r=0.5 at origin
  * the returned `t` is the WORLD-space distance
    length(origin - intersectionPoint) (src/intersections.h:87,143)
  * the hit point backs off the surface by 1e-4 along the (object-space) ray
    (getPointOnRay, src/intersections.h:27-29), then lifts off it along the
    normal (`lift_off`: not in the reference)
  * interior sphere hits flip the normal (src/intersections.h:139-141)
  * t = -1 encodes a miss (src/pathtrace.cu:203)

Two-pass design (not in the reference): pass 1 computes only the
[N,G] world-distance matrix (fusible elementwise work, nothing else
materialized); pass 2 gathers the winning geom's transforms per ray and
recomputes normals/uv for the winner only — trading a little recompute for a
large memory-bandwidth saving.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene import types as T
from ..utils.math import RAY_EPS

BIG = jnp.float32(1e30)


def lift_off(point, normal):
    """Continuation origin: `point` moved along `normal` (which faces the
    incoming ray) by RAY_EPS relative to the coordinate magnitude, [N,3].

    The object-space back-off alone is about one float32 ulp of a world
    coordinate on thin scaled geoms (Cornell's 0.01-thick walls at |p| ~ 10),
    so whether the next ray started inside the wall, and re-hit it at
    t ~ 1e-6, depended on rounding: ~8% of Cornell's first-bounce rays did
    on one backend and fewer on another (fused multiply-adds), a few percent
    of image brightness apart."""
    mag = jnp.max(jnp.abs(point), axis=-1, keepdims=True)
    return point + (RAY_EPS * (1.0 + mag)) * normal


class Hit(NamedTuple):
    """SoA ShadeableIntersection (reference: src/sceneStructs.h:71-76) plus
    the fields the shading stage needs (hit point, uv, material)."""
    t: jnp.ndarray        # [N] world distance; -1 = miss
    normal: jnp.ndarray   # [N,3]
    mat_id: jnp.ndarray   # [N] int32
    point: jnp.ndarray    # [N,3] world hit point (with the 1e-4 back-off)
    uv: jnp.ndarray       # [N,2]
    outside: jnp.ndarray  # [N] bool


def _xform_pt(mat, p):
    """Affine transform of points, unrolled to elementwise FMAs.

    Deliberately NOT einsum/dot: a [...,3,3]x[...,3] contraction can lower
    to a matrix unit whose default f32 precision is reduced (bf16 inputs,
    or TF32 on a GPU) — at object-space magnitudes of ~500 (thin-wall
    inverse scales) that loses whole units. Elementwise keeps full f32."""
    return (mat[..., :3, 0] * p[..., 0, None]
            + mat[..., :3, 1] * p[..., 1, None]
            + mat[..., :3, 2] * p[..., 2, None]
            + mat[..., :3, 3])


def _xform_dir(mat, v):
    """Linear transform of directions (see _xform_pt for why not einsum)."""
    return (mat[..., :3, 0] * v[..., 0, None]
            + mat[..., :3, 1] * v[..., 1, None]
            + mat[..., :3, 2] * v[..., 2, None])


def _normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def _box_local(qo, qd):
    """Slab test against the unit cube, reference math
    (src/intersections.h:48-90). Returns (t_obj, hit, outside, axis, sign)."""
    t1 = (-0.5 - qo) / qd
    t2 = (0.5 - qo) / qd
    ta = jnp.minimum(t1, t2)
    tb = jnp.maximum(t1, t2)
    n_sign = jnp.where(t2 < t1, 1.0, -1.0)  # src/intersections.h:66
    ta_pos = jnp.where(ta > 0, ta, -BIG)
    tmin = jnp.max(ta_pos, axis=-1)
    tmin_axis = jnp.argmax(ta_pos, axis=-1)
    tmax = jnp.min(tb, axis=-1)
    tmax_axis = jnp.argmin(tb, axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    outside = tmin > 0  # src/intersections.h:78-84
    t_obj = jnp.where(outside, tmin, tmax)
    axis = jnp.where(outside, tmin_axis, tmax_axis)
    sign = jnp.take_along_axis(n_sign, axis[..., None], axis=-1)[..., 0]
    return t_obj, hit, outside, axis, sign


def _sphere_local(qo, qd):
    """Quadratic test against the r=0.5 sphere, reference math
    (src/intersections.h:102-144). Returns (t_obj, hit, outside)."""
    v_dot_d = jnp.sum(qo * qd, axis=-1)
    radicand = v_dot_d * v_dot_d - (jnp.sum(qo * qo, axis=-1) - 0.25)
    has_root = radicand >= 0
    s = jnp.sqrt(jnp.maximum(radicand, 0.0))
    t1 = -v_dot_d + s
    t2 = -v_dot_d - s
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    hit = has_root & ~both_neg
    outside = both_pos
    return t_obj, hit, outside


def _to_object(ray_o, ray_d, times, geoms: T.Geoms):
    """Transform the wavefront into every geom's object space: [N,G,3].

    Motion blur: a geom translated by velocity*t is equivalent to shifting
    the ray origin by -velocity*t in world space before the static transform
    (reference TODO: src/pathtrace.cu:119)."""
    o_shift = ray_o[:, None, :] - geoms.velocity[None, :, :] * times[:, None, None]
    qo = _xform_pt(geoms.inverse_transform[None, :], o_shift)
    qd = _normalize(_xform_dir(geoms.inverse_transform[None, :], ray_d[:, None, :]))
    return qo, qd


def _world_t(t_obj, qo, qd, transform, vel_world, ray_o):
    """World distance of the (backed-off) hit point, reference convention
    (src/intersections.h:85-87,135-143)."""
    ip_obj = qo + (t_obj[..., None] - RAY_EPS) * qd
    ip_world = _xform_pt(transform, ip_obj) + vel_world
    return jnp.linalg.norm(ray_o - ip_world, axis=-1), ip_world


def primitive_distances(ray_o, ray_d, times, geoms: T.Geoms) -> jnp.ndarray:
    """Pass 1: [N,G] world distances; +inf where missed or not a primitive."""
    qo, qd = _to_object(ray_o, ray_d, times, geoms)
    vel_world = geoms.velocity[None, :, :] * times[:, None, None]

    tb, hb, _, _, _ = _box_local(qo, qd)
    ts, hs, _ = _sphere_local(qo, qd)

    is_cube = (geoms.type == T.CUBE)[None, :]
    is_sphere = (geoms.type == T.SPHERE)[None, :]
    t_obj = jnp.where(is_cube, tb, ts)
    hit = jnp.where(is_cube, hb, jnp.where(is_sphere, hs, False))

    tw, _ = _world_t(t_obj, qo, qd, geoms.transform[None, :], vel_world,
                     ray_o[:, None, :])
    return jnp.where(hit, tw, BIG)


def primitive_hit_detail(ray_o, ray_d, times, geoms: T.Geoms, g_star) -> Hit:
    """Pass 2: recompute full hit attributes for the winning geom only."""
    inv = geoms.inverse_transform[g_star]       # [N,4,4]
    fwd = geoms.transform[g_star]
    inv_tr = geoms.inverse_transpose[g_star]
    vel = geoms.velocity[g_star]
    gtype = geoms.type[g_star]

    o_shift = ray_o - vel * times[:, None]
    qo = _xform_pt(inv, o_shift)
    qd = _normalize(_xform_dir(inv, ray_d))

    tb, hb, ob, axis, sign = _box_local(qo, qd)
    ts, hs, os_ = _sphere_local(qo, qd)

    is_cube = gtype == T.CUBE
    t_obj = jnp.where(is_cube, tb, ts)
    outside = jnp.where(is_cube, ob, os_)

    ip_obj = qo + (t_obj[:, None] - RAY_EPS) * qd
    ip_world = _xform_pt(fwd, ip_obj) + vel * times[:, None]
    t_world = jnp.linalg.norm(ray_o - ip_world, axis=-1)

    # normals: cube = signed face axis; sphere = object point direction,
    # flipped for interior hits (src/intersections.h:86,138-141)
    n_box_local = jax.nn.one_hot(axis, 3, dtype=qo.dtype) * sign[:, None]
    n_sph_local = ip_obj * jnp.where(outside, 1.0, -1.0)[:, None]
    n_local = jnp.where(is_cube[:, None], n_box_local, n_sph_local)
    normal = _normalize(_xform_dir(inv_tr, n_local))

    # uv parameterization (extension for texturing; reference stores none)
    u_sph = 0.5 + jnp.arctan2(ip_obj[:, 2], ip_obj[:, 0]) / (2 * jnp.pi)
    v_sph = 0.5 + jnp.arcsin(jnp.clip(ip_obj[:, 1] / 0.5, -1, 1)) / jnp.pi
    # cube: project onto the hit face's two tangent axes
    p01 = ip_obj + 0.5
    uv_face = jnp.stack([
        jnp.where(axis == 0, p01[:, 1], p01[:, 0]),
        jnp.where(axis == 2, p01[:, 1], p01[:, 2]),
    ], axis=-1)
    uv = jnp.where(is_cube[:, None],
                   uv_face, jnp.stack([u_sph, v_sph], axis=-1))

    return Hit(t=t_world, normal=normal, mat_id=geoms.material_id[g_star],
               point=ip_world, uv=uv, outside=outside)


# ---------------------------------------------------------------------------
# Triangle meshes + BVH traversal (reference TODO slot: src/pathtrace.cu:188)
# ---------------------------------------------------------------------------

# BVH leaves hold at most LEAF_K triangles (a static gather width for the
# walk). 4 was chosen for the previous accelerator's packet kernel; an
# H100 mesh cell decides it again for the CUDA traversal (ops/bvh8).
LEAF_K = 4
MAX_TRAV_STEPS = 4096


def _aabb_hit(qo, inv_qd, lo, hi, t_best):
    """Slab test vs axis-aligned box; returns whether the box can contain a
    closer hit than t_best (object space)."""
    t1 = (lo - qo) * inv_qd
    t2 = (hi - qo) * inv_qd
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (tmax >= tmin) & (tmax > 0) & (tmin < t_best)


def _tri_hit(qo, qd, v0, e1, e2):
    """Moller-Trumbore; qo/qd [N,3], tris [N,K,3]. Returns t [N,K], u, v."""
    d = qd[:, None, :]
    o = qo[:, None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = ((jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > 1e-6))
    return jnp.where(ok, t, BIG), u, v


def bvh_traverse(qo, qd, meshes: T.MeshBundle, root: jnp.ndarray,
                 t_bound=None):
    """Stackless skip-pointer BVH traversal, vectorized over the wavefront.

    Every ray keeps its own node cursor; internal-hit advances to node+1
    (children are laid out depth-first), miss/leaf-done jumps to node_skip.
    Divergence is absorbed by per-lane cursors + masking. `t_bound` [N]
    (optional) only accepts hits closer than it; a ray with t_bound <= 0
    is dead and never traversed. Returns (t_obj [N], tri [N] int32,
    barycentric u [N], v [N]); t_obj is the bound (BIG by default) and tri
    -1 on a miss.
    """
    n = qo.shape[0]
    if t_bound is None:
        t_bound = jnp.full((n,), BIG, jnp.float32)
    inv_qd = jnp.where(jnp.abs(qd) > 1e-12, 1.0 / qd, jnp.sign(qd) * BIG + BIG)

    def cond(state):
        cur, step, t_best, tri_best, u_best, v_best = state
        return jnp.any(cur >= 0) & (step < MAX_TRAV_STEPS)

    def body(state):
        cur, step, t_best, tri_best, u_best, v_best = state
        node = jnp.maximum(cur, 0)
        lo = meshes.node_lo[node]
        hi = meshes.node_hi[node]
        start = meshes.node_start[node]
        count = meshes.node_count[node]
        skip = meshes.node_skip[node]

        active = cur >= 0
        box_ok = _aabb_hit(qo, inv_qd, lo, hi, t_best) & active
        is_leaf = count > 0

        # Leaf: test up to LEAF_K triangles (static gather width).
        do_leaf = box_ok & is_leaf
        safe_start = jnp.maximum(start, 0)
        tri_idx = safe_start[:, None] + jnp.arange(LEAF_K, dtype=jnp.int32)[None, :]
        in_leaf = jnp.arange(LEAF_K, dtype=jnp.int32)[None, :] < count[:, None]
        tri_idx = jnp.minimum(tri_idx, meshes.tri_v0.shape[0] - 1)
        t_k, u_k, v_k = _tri_hit(qo, qd,
                                 meshes.tri_v0[tri_idx],
                                 meshes.tri_e1[tri_idx],
                                 meshes.tri_e2[tri_idx])
        t_k = jnp.where(in_leaf & do_leaf[:, None], t_k, BIG)
        k_best = jnp.argmin(t_k, axis=-1)
        t_cand = jnp.take_along_axis(t_k, k_best[:, None], axis=-1)[:, 0]
        better = t_cand < t_best
        t_best = jnp.where(better, t_cand, t_best)
        tri_best = jnp.where(better,
                             jnp.take_along_axis(tri_idx, k_best[:, None],
                                                 axis=-1)[:, 0], tri_best)
        u_best = jnp.where(better,
                           jnp.take_along_axis(u_k, k_best[:, None],
                                               axis=-1)[:, 0], u_best)
        v_best = jnp.where(better,
                           jnp.take_along_axis(v_k, k_best[:, None],
                                               axis=-1)[:, 0], v_best)

        # Advance: descend on internal hit, otherwise take the escape pointer.
        nxt = jnp.where(box_ok & ~is_leaf, node + 1, skip)
        cur = jnp.where(active, nxt, cur)
        return cur, step + 1, t_best, tri_best, u_best, v_best

    init = (jnp.where(t_bound > 0, jnp.asarray(root, jnp.int32), -1),
            jnp.int32(0),
            jnp.asarray(t_bound, jnp.float32),
            -jnp.ones((n,), jnp.int32),
            jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32))
    _, _, t_best, tri_best, u_best, v_best = jax.lax.while_loop(cond, body, init)
    return t_best, tri_best, u_best, v_best


def mesh_hit(ray_o, ray_d, times, geoms: T.Geoms, meshes: T.MeshBundle,
             geom_index: int):
    """Full hit record for one MESH geom against the whole wavefront."""
    inv = geoms.inverse_transform[geom_index]
    fwd = geoms.transform[geom_index]
    inv_tr = geoms.inverse_transpose[geom_index]
    vel = geoms.velocity[geom_index]
    mesh_id = geoms.mesh_id[geom_index]

    o_shift = ray_o - vel[None, :] * times[:, None]
    qo = _xform_pt(inv[None], o_shift)
    qd = _normalize(_xform_dir(inv[None], ray_d))

    root = meshes.mesh_root[mesh_id]
    t_obj, tri, u, v = bvh_traverse(qo, qd, meshes, root)
    hit = tri >= 0
    tri_s = jnp.maximum(tri, 0)

    ip_obj = qo + (t_obj[:, None] - RAY_EPS) * qd
    ip_world = _xform_pt(fwd[None], ip_obj) + vel[None, :] * times[:, None]
    t_world = jnp.where(hit, jnp.linalg.norm(ray_o - ip_world, axis=-1), BIG)

    w = 1.0 - u - v
    n_obj = (w[:, None] * meshes.tri_n0[tri_s]
             + u[:, None] * meshes.tri_n1[tri_s]
             + v[:, None] * meshes.tri_n2[tri_s])
    normal = _normalize(_xform_dir(inv_tr[None], n_obj))
    # flip toward the incoming ray (meshes are open surfaces; two-sided)
    facing = jnp.sum(normal * ray_d, axis=-1) < 0
    normal = jnp.where(facing[:, None], normal, -normal)
    uv = (w[:, None] * meshes.tri_uv0[tri_s]
          + u[:, None] * meshes.tri_uv1[tri_s]
          + v[:, None] * meshes.tri_uv2[tri_s])

    mat = jnp.full_like(tri_s, geoms.material_id[geom_index])
    return Hit(t=t_world, normal=normal, mat_id=mat, point=ip_world, uv=uv,
               outside=facing)


# ---------------------------------------------------------------------------
# Scene-level dispatch
# ---------------------------------------------------------------------------

def _primitive_hit_one(ray_o, ray_d, times, geoms: T.Geoms, g: int,
                       gtype: int):
    """Full hit record of ONE primitive geom (static index + type) against
    the wavefront. All arrays are [N]-shaped; with the geom index static the
    transform rows are scalars and XLA fuses the whole test into one
    elementwise pipeline — the wavefront analog of the reference's per-thread geom
    loop (src/pathtrace.cu:176-199) without materializing [N,G] anything."""
    inv = geoms.inverse_transform[g]
    fwd = geoms.transform[g]
    inv_tr = geoms.inverse_transpose[g]
    vel = geoms.velocity[g]

    o_shift = ray_o - vel[None, :] * times[:, None]
    qo = _xform_pt(inv[None], o_shift)
    qd = _normalize(_xform_dir(inv[None], ray_d))

    if gtype == T.CUBE:
        t_obj, hit, outside, axis, sign = _box_local(qo, qd)
        n_local = jax.nn.one_hot(axis, 3, dtype=qo.dtype) * sign[:, None]
    else:
        t_obj, hit, outside = _sphere_local(qo, qd)

    ip_obj = qo + (t_obj[:, None] - RAY_EPS) * qd
    ip_world = _xform_pt(fwd[None], ip_obj) + vel[None, :] * times[:, None]
    t_world = jnp.linalg.norm(ray_o - ip_world, axis=-1)

    if gtype == T.CUBE:
        p01 = ip_obj + 0.5
        uv = jnp.stack([
            jnp.where(axis == 0, p01[:, 1], p01[:, 0]),
            jnp.where(axis == 2, p01[:, 1], p01[:, 2]),
        ], axis=-1)
    else:
        n_local = ip_obj * jnp.where(outside, 1.0, -1.0)[:, None]
        u_sph = 0.5 + jnp.arctan2(ip_obj[:, 2], ip_obj[:, 0]) / (2 * jnp.pi)
        v_sph = 0.5 + jnp.arcsin(
            jnp.clip(ip_obj[:, 1] / 0.5, -1, 1)) / jnp.pi
        uv = jnp.stack([u_sph, v_sph], axis=-1)

    normal = _normalize(_xform_dir(inv_tr[None], n_local))
    t = jnp.where(hit, t_world, BIG)
    return Hit(t=t, normal=normal,
               mat_id=jnp.broadcast_to(geoms.material_id[g], t.shape),
               point=ip_world, uv=uv, outside=outside)


def _merge_hits(best: Hit, cand: Hit) -> Hit:
    closer = cand.t < best.t
    c3 = closer[:, None]
    return Hit(t=jnp.where(closer, cand.t, best.t),
               normal=jnp.where(c3, cand.normal, best.normal),
               mat_id=jnp.where(closer, cand.mat_id, best.mat_id),
               point=jnp.where(c3, cand.point, best.point),
               uv=jnp.where(c3, cand.uv, best.uv),
               outside=jnp.where(closer, cand.outside, best.outside))


def intersect_scene_fused(ray_o, ray_d, times, geoms: T.Geoms,
                          meshes: T.MeshBundle,
                          geom_types: tuple) -> Hit:
    """Single-pass nearest-hit over all geoms, statically unrolled.

    `geom_types` is the static tuple of GeomType per geom slot (known at
    trace time), so each primitive's test compiles to exactly its own math
    and everything fuses into one pass over the wavefront. Preferred over
    the two-pass `intersect_scene`: no [N,G] intermediates, no per-ray
    transform gathers.
    """
    n = ray_o.shape[0]
    best = Hit(t=jnp.full((n,), BIG, jnp.float32),
               normal=jnp.zeros((n, 3), jnp.float32),
               mat_id=jnp.zeros((n,), jnp.int32),
               point=jnp.zeros((n, 3), jnp.float32),
               uv=jnp.zeros((n, 2), jnp.float32),
               outside=jnp.ones((n,), bool))
    for g, gtype in enumerate(geom_types):
        if gtype == T.MESH:
            cand = mesh_hit(ray_o, ray_d, times, geoms, meshes, g)
        else:
            cand = _primitive_hit_one(ray_o, ray_d, times, geoms, g, gtype)
        best = _merge_hits(best, cand)

    miss = best.t >= BIG
    return Hit(t=jnp.where(miss, -1.0, best.t), normal=best.normal,
               mat_id=jnp.where(miss, 0, best.mat_id),
               point=lift_off(best.point, best.normal),
               uv=best.uv, outside=best.outside)


def intersect_scene(ray_o, ray_d, times, geoms: T.Geoms,
                    meshes: T.MeshBundle, mesh_geom_indices=()) -> Hit:
    """Nearest-hit query for the whole wavefront (reference:
    src/pathtrace.cu:149-213). `mesh_geom_indices` is the static tuple of
    geom slots whose type is MESH (known at trace time)."""
    dists = primitive_distances(ray_o, ray_d, times, geoms)  # [N,G]
    g_star = jnp.argmin(dists, axis=-1).astype(jnp.int32)
    t_prim = jnp.min(dists, axis=-1)
    prim = primitive_hit_detail(ray_o, ray_d, times, geoms, g_star)

    best = Hit(t=jnp.where(t_prim < BIG, prim.t, BIG),
               normal=prim.normal, mat_id=prim.mat_id,
               point=prim.point, uv=prim.uv, outside=prim.outside)

    for gi in mesh_geom_indices:
        mh = mesh_hit(ray_o, ray_d, times, geoms, meshes, gi)
        closer = mh.t < best.t
        best = Hit(
            t=jnp.where(closer, mh.t, best.t),
            normal=jnp.where(closer[:, None], mh.normal, best.normal),
            mat_id=jnp.where(closer, mh.mat_id, best.mat_id),
            point=jnp.where(closer[:, None], mh.point, best.point),
            uv=jnp.where(closer[:, None], mh.uv, best.uv),
            outside=jnp.where(closer, mh.outside, best.outside),
        )

    miss = best.t >= BIG
    return Hit(t=jnp.where(miss, -1.0, best.t), normal=best.normal,
               mat_id=jnp.where(miss, 0, best.mat_id),
               point=lift_off(best.point, best.normal),
               uv=best.uv, outside=best.outside)
