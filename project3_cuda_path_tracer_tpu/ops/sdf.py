"""Signed-distance-field primitives + CSG — the reference TODO's alternative
primitive slots ("metaball? CSG?", reference src/pathtrace.cu:188).

A new GeomType (`T.SDF`) whose object-space surface is the zero set of a
signed distance function, intersected by fixed-iteration sphere tracing —
the wavefront form of an iterative root find: a `lax.scan` with a static
trip count over fully elementwise distance evaluations (no data-dependent
control flow, like every other wavefront kernel).

Kinds (static per geom, so XLA traces exactly one distance function per
object — no runtime dispatch):

  torus R r            ring in the object-space xz plane
  roundbox hx hy hz r  box with rounded edges
  capsule hh r         y-axis capsule, half-height hh
  metaball k  (x y z r)*   smooth-min blend of up to MAX_BALLS spheres
                           (the classic metaball look; smin underestimates
                           true distance, so marching stays conservative)
  csg_union / csg_inter / csg_diff  A <shape> / B <shape>
      boolean of two sub-shapes, each a sphere (cx cy cz r) or box
      (cx cy cz hx hy hz) in object space; min/max of SDFs has the exact
      CSG boundary as its zero set and never overestimates distance, so
      sphere tracing converges to the true surface.

All shapes live in the canonical unit-ish object space and are placed by
the OBJECT's TRANS/ROTAT/SCALE like every other primitive (reference
src/scene.cpp:56-85); rays march in object space along the *normalized*
object-space direction, so non-uniform scales are handled by the same
world-distance-t convention as box/sphere (src/intersections.h:87,143).

Normals are tetrahedral finite differences of the SDF (4 extra evals),
mapped to world space via the inverse-transpose like the analytic
primitives.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from . import vec
from .vec import V3
from ..utils.math import RAY_EPS

# SDF kind ids (static; parser writes them into Scene.sdf_kinds)
TORUS = 0
ROUNDBOX = 1
CAPSULE = 2
METABALL = 3
CSG_UNION = 4
CSG_INTER = 5
CSG_DIFF = 6

# CSG sub-shape ids (static, stored in the kind tuple's aux slots)
SUB_NONE = -1
SUB_SPHERE = 0
SUB_BOX = 1

MAX_BALLS = 4
PARAM_SLOTS = 20          # Geoms.sdf_params is [G, PARAM_SLOTS]
MARCH_STEPS = 64          # static sphere-tracing trip count
HIT_EPS = 1e-3            # object-space convergence epsilon
NORMAL_EPS = 1e-3
T_MAX = 1e4


def _sd_sphere(p: V3, cx, cy, cz, r):
    return vec.norm(V3(p.x - cx, p.y - cy, p.z - cz)) - r


def _sd_box(p: V3, cx, cy, cz, hx, hy, hz):
    qx = jnp.abs(p.x - cx) - hx
    qy = jnp.abs(p.y - cy) - hy
    qz = jnp.abs(p.z - cz) - hz
    outside = vec.norm(V3(jnp.maximum(qx, 0.0), jnp.maximum(qy, 0.0),
                          jnp.maximum(qz, 0.0)))
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    return outside + inside


def _sd_torus(p: V3, R, r):
    ring = jnp.sqrt(p.x * p.x + p.z * p.z) - R
    return jnp.sqrt(ring * ring + p.y * p.y) - r


def _sd_roundbox(p: V3, hx, hy, hz, rad):
    return _sd_box(p, 0.0, 0.0, 0.0, hx - rad, hy - rad, hz - rad) - rad


def _sd_capsule(p: V3, hh, r):
    py = p.y - jnp.clip(p.y, -hh, hh)
    return vec.norm(V3(p.x, py, p.z)) - r


def _smin(a, b, k):
    """Polynomial smooth min (blend radius k): <= min(a,b), Lipschitz-1."""
    h = jnp.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b * (1.0 - h) + a * h - k * h * (1.0 - h)


def _sub_shape(p: V3, sub_kind: int, prm) -> jnp.ndarray:
    """CSG sub-shape distance; prm is an 8-slot static-offset view."""
    if sub_kind == SUB_SPHERE:
        return _sd_sphere(p, prm[0], prm[1], prm[2], prm[3])
    if sub_kind == SUB_BOX:
        return _sd_box(p, prm[0], prm[1], prm[2], prm[3], prm[4], prm[5])
    raise ValueError(f"bad CSG sub-shape kind {sub_kind}")


def sdf_eval(p: V3, kind: Tuple[int, int, int], params) -> jnp.ndarray:
    """Distance at object-space points `p` ([N] planes); `kind` is the
    static (kind, aux_a, aux_b) triple, `params` the geom's [PARAM_SLOTS]
    row (traced — SDF shape parameters are differentiable scene inputs
    like every transform/material)."""
    k, a, b = kind
    if k == TORUS:
        return _sd_torus(p, params[0], params[1])
    if k == ROUNDBOX:
        return _sd_roundbox(p, params[0], params[1], params[2], params[3])
    if k == CAPSULE:
        return _sd_capsule(p, params[0], params[1])
    if k == METABALL:
        nballs = max(1, min(a, MAX_BALLS))   # static ball count in aux_a
        kblend = params[0]
        d = _sd_sphere(p, params[1], params[2], params[3], params[4])
        for i in range(1, nballs):
            o = 1 + 4 * i
            di = _sd_sphere(p, params[o], params[o + 1], params[o + 2],
                            params[o + 3])
            d = _smin(d, di, kblend)
        return d
    if k in (CSG_UNION, CSG_INTER, CSG_DIFF):
        da = _sub_shape(p, a, params[0:8])
        db = _sub_shape(p, b, params[8:16])
        if k == CSG_UNION:
            return jnp.minimum(da, db)
        if k == CSG_INTER:
            return jnp.maximum(da, db)
        return jnp.maximum(da, -db)
    raise ValueError(f"bad SDF kind {k}")


def _bounding_radius(kind: Tuple[int, int, int], params) -> jnp.ndarray:
    """Conservative object-space bounding-sphere radius (traced scalar);
    used to skip marching for rays that miss the object entirely and to
    start the march at the sphere's entry."""
    k, a, b = kind
    if k == TORUS:
        return params[0] + params[1]
    if k == ROUNDBOX:
        return jnp.sqrt(params[0] ** 2 + params[1] ** 2 + params[2] ** 2)
    if k == CAPSULE:
        return params[0] + params[1]
    if k == METABALL:
        nballs = max(1, min(a, MAX_BALLS))
        r = jnp.float32(0.0)
        for i in range(nballs):
            o = 1 + 4 * i
            c = jnp.sqrt(params[o] ** 2 + params[o + 1] ** 2
                         + params[o + 2] ** 2)
            # smin can pull the blended surface outward by up to k/4
            r = jnp.maximum(r, c + params[o + 3] + params[0])
        return r
    # CSG: union of the two sub-shape bounds (conservative for all ops)
    def sub_r(sub_kind, prm):
        if sub_kind == SUB_SPHERE:
            return (jnp.sqrt(prm[0] ** 2 + prm[1] ** 2 + prm[2] ** 2)
                    + prm[3])
        return (jnp.sqrt(prm[0] ** 2 + prm[1] ** 2 + prm[2] ** 2)
                + jnp.sqrt(prm[3] ** 2 + prm[4] ** 2 + prm[5] ** 2))
    return jnp.maximum(sub_r(a, params[0:8]), sub_r(b, params[8:16]))


def march_local(qo: V3, qd: V3, kind: Tuple[int, int, int], params):
    """Sphere-trace the SDF in object space. qd must be normalized.

    Returns (t_obj [N], hit [N] bool, outside [N] bool). Fixed
    MARCH_STEPS-trip `lax.scan` — converged lanes stop advancing (masked),
    overshoot is impossible because every kind's field never overestimates
    distance (smin/min/max are <= the true distance).
    """
    f0 = sdf_eval(qo, kind, params)
    outside = f0 >= 0.0
    # March toward the crossing from either side: flip the field's sign for
    # rays starting inside so `d` is always "distance until the surface".
    sgn = jnp.where(outside, 1.0, -1.0)

    # Start at the bounding sphere's entry (big constant-folded win for
    # rays that pass nowhere near the object).
    rb = _bounding_radius(kind, params) + HIT_EPS
    oc2 = vec.dot(qo, qo)
    proj = -vec.dot(qo, qd)                       # t of closest approach
    perp2 = oc2 - proj * proj
    half = jnp.sqrt(jnp.maximum(rb * rb - perp2, 0.0))
    t_in = jnp.maximum(proj - half, 0.0)
    misses_bound = (perp2 > rb * rb) | (proj + half <= 0.0)

    t0 = jnp.where(misses_bound, T_MAX, t_in)
    live0 = ~misses_bound

    # Surface-acne guard: scattered rays start ~1e-4 off their surface —
    # INSIDE the HIT_EPS band — so a naive march would re-hit the same
    # surface at t=0 (every bounce ray, making SDF objects near-black).
    # A lane is only allowed to report a hit once it is ARMED, i.e. clear
    # of the band (d > 2*HIT_EPS) — judged at the ray's TRUE origin (rays
    # born far away arm immediately; the bounding-sphere entry point would
    # sit right at the band edge and never arm) or at any later march
    # point; until armed it advances by at least HIT_EPS per step.
    armed0 = live0 & (sgn * f0 > 2.0 * HIT_EPS)
    hit0 = live0 & False

    def step(carry, _):
        t, live, armed, hit = carry
        p = V3(qo.x + t * qd.x, qo.y + t * qd.y, qo.z + t * qd.z)
        d = sgn * sdf_eval(p, kind, params)
        armed = armed | (d > 2.0 * HIT_EPS)
        hit_now = live & armed & (d <= HIT_EPS)
        hit = hit | hit_now
        adv = jnp.where(live & ~hit_now,
                        jnp.maximum(d, jnp.where(armed, 0.0, HIT_EPS)),
                        0.0)
        t = t + adv
        live = live & ~hit_now & (t < 2.0 * rb + t_in)
        return (t, live, armed, hit), None

    (t, live, armed, hit), _ = jax.lax.scan(
        step, (t0, live0, armed0, hit0), None, length=MARCH_STEPS)
    # Lanes that ran out of steps while converging (d already inside the
    # loose band) still count as hits — dropping them punches holes.
    p = V3(qo.x + t * qd.x, qo.y + t * qd.y, qo.z + t * qd.z)
    d_final = sgn * sdf_eval(p, kind, params)
    hit = hit | (armed & (d_final <= 4.0 * HIT_EPS) & (t < T_MAX))
    return t, hit, outside


def normal_local(p: V3, kind: Tuple[int, int, int], params) -> V3:
    """Tetrahedral finite-difference SDF gradient (4 evals)."""
    e = NORMAL_EPS
    n = V3(jnp.zeros_like(p.x), jnp.zeros_like(p.x), jnp.zeros_like(p.x))
    for sx, sy, sz in ((1, -1, -1), (-1, -1, 1), (-1, 1, -1), (1, 1, 1)):
        d = sdf_eval(V3(p.x + sx * e, p.y + sy * e, p.z + sz * e),
                     kind, params)
        n = V3(n.x + sx * d, n.y + sy * d, n.z + sz * d)
    return vec.normalize(n)
