"""Next-event estimation (direct-light sampling) over the planar wavefront.

The classic "direct lighting" completed-project extension to the
reference scaffold's BSDF-sampling loop (the shading TODO at
src/pathtrace.cu:360-367 + src/interactions.h:44-68 defines pure BSDF
sampling; NEE is the standard variance-reduction layered on top): at
every diffuse-capable hit, sample one point uniformly over the union of
the scene's emissive surfaces, cast a shadow ray through the production
intersector, and add the area-form direct contribution

    throughput * p_diff * albedo/pi * Le * cos_s * cos_l / d^2 * A_total

Both strategies stay active and are combined with one-sample MIS
(balance heuristic): the NEE term is weighted against the BSDF pdf of
the same direction, and a diffuse/glossy-continuation ray that hits an
emitter at the next bounce is down-weighted against the light sampler's
pdf of that hit (ops/wavefront.shade_planar). Because NEE is skipped on
the last bounce, the estimator covers EXACTLY the same transport as the
plain estimator at equal trace depth (tested: tests/test_nee.py renders
converge to the same image). Scenes with BOTH area lights and an HDR
env run a flux-proportional one-sample mixture of the two light
samplers (render/integrator._wire_nee's nee_q).

Design decisions:
  * The light table is STATIC (a hashable tuple baked into TraceConfig):
    light geometry derives from scene transforms, which the
    differentiable path never optimizes. Emitted radiance
    (color * emittance) is read from the traced materials table at shade
    time, so NEE stays differentiable in light brightness/color.
  * Face selection is a static unroll over the table (chained selects,
    no gathers — the same no-gather discipline as ops/wavefront).
  * Two-sided emitters (matching the reference, where ANY hit on an
    emissive geom collects emittance): cos_l uses |dot|; a sample on a
    back face is killed by its own occlusion test.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from . import vec
from .vec import V3
from ..scene import types as T

# face record layout (hashable floats):
#   (cum_frac, kind, ox,oy,oz, ux,uy,uz, vx,vy,vz, nx,ny,nz, mat_id, radius)
# kind 0 = parallelogram (cube face), kind 1 = sphere (o=center, radius).
FACE_LEN = 16


def build_light_table(scene) -> Tuple[tuple, float]:
    """Static NEE light table for a scene: (faces, total_area).

    Eligible emissive geoms: CUBE (any affine transform — each face maps
    to a world-space parallelogram, uniform area sampling stays uniform)
    and SPHERE with uniform scale. Returns ((), 0.0) when the scene has
    no emissive geoms OR any emissive geom is ineligible (mesh/SDF/
    non-uniform sphere): partial NEE would bias the suppression rule, so
    it is all-or-nothing.
    """
    types = np.asarray(scene.geoms.type)
    mat_ids = np.asarray(scene.geoms.material_id)
    emit = np.asarray(scene.materials.emittance)
    xforms = np.asarray(scene.geoms.transform)
    inv_t = np.asarray(scene.geoms.inverse_transpose)

    faces = []
    for g in range(types.shape[0]):
        m = int(mat_ids[g])
        if emit[m] <= 0.0:
            continue
        M = xforms[g]
        if types[g] == T.CUBE:
            for k in range(3):
                for s in (0.5, -0.5):
                    ka, kb = (k + 1) % 3, (k + 2) % 3
                    corner = np.full(3, -0.5)
                    corner[k] = s
                    o = (M[:3, :3] @ corner) + M[:3, 3]
                    eu = M[:3, ka].copy()
                    ev = M[:3, kb].copy()
                    area = float(np.linalg.norm(np.cross(eu, ev)))
                    n_obj = np.zeros(3)
                    n_obj[k] = np.sign(s)
                    n = inv_t[g][:3, :3] @ n_obj
                    nn = np.linalg.norm(n)
                    n = n / nn if nn > 0 else n_obj
                    faces.append((0.0, 0.0, *o.tolist(), *eu.tolist(),
                                  *ev.tolist(), *n.tolist(), float(m),
                                  0.0, area))
        elif types[g] == T.SPHERE:
            s0, s1, s2 = (np.linalg.norm(M[:3, i]) for i in range(3))
            if abs(s0 - s1) > 1e-5 * s0 or abs(s0 - s2) > 1e-5 * s0:
                return (), 0.0  # non-uniform sphere: ineligible
            r = 0.5 * float(s0)
            c = M[:3, 3]
            area = 4.0 * math.pi * r * r
            faces.append((0.0, 1.0, *c.tolist(), 0.0, 0.0, 0.0,
                          0.0, 0.0, 0.0, 0.0, 0.0, 0.0, float(m), r, area))
        else:
            return (), 0.0  # emissive mesh/SDF: ineligible
    if not faces:
        return (), 0.0
    total = sum(f[-1] for f in faces)
    out = []
    cum = 0.0
    for f in faces:
        cum += f[-1] / total
        out.append((cum,) + tuple(f[1:-1]))
    # pin the last cum to exactly 1.0 against float drift
    out[-1] = (1.0,) + out[-1][1:]
    return tuple(out), float(total)


# Above this face count the static unroll switches to the gather-based
# sampler: the unroll's XLA cost is O(F) chained selects PER CANDIDATE
# (a 64-face x M=4 x depth-4 trace took over 50 min to compile on the
# CPU backend), while the gather form is F-independent
# (log F searchsorted + 15 small-table takes). For small F the unroll
# wins at runtime (no gathers), so it stays the default.
UNROLL_MAX_FACES = 16


def sample_lights_planar(faces: tuple, u_face, u1, u2):
    """Uniform-by-area sample over the light union.

    Returns (lp V3, ln V3, light_mat [N] int32). Static face unroll for
    small tables (chained selects, no gathers); CDF-searchsorted +
    per-lane table gathers above UNROLL_MAX_FACES (identical estimator —
    tests/test_nee.py::test_gather_sampler_matches_unroll).
    """
    if len(faces) > UNROLL_MAX_FACES:
        return _sample_lights_gather(faces, u_face, u1, u2)
    def face_point(f):
        cum, kind = f[0], f[1]
        o = V3(*(c + jnp.zeros_like(u1) for c in f[2:5]))
        if kind >= 0.5:  # sphere
            r = f[15]
            z = 1.0 - 2.0 * u1
            rxy = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
            phi = u2 * (2.0 * math.pi)
            w = V3(rxy * jnp.cos(phi), rxy * jnp.sin(phi), z)
            lp = V3(o.x + r * w.x, o.y + r * w.y, o.z + r * w.z)
            return lp, w
        eu, ev, nrm = f[5:8], f[8:11], f[11:14]
        lp = V3(o.x + u1 * eu[0] + u2 * ev[0],
                o.y + u1 * eu[1] + u2 * ev[1],
                o.z + u1 * eu[2] + u2 * ev[2])
        ln = V3(*(c + jnp.zeros_like(u1) for c in nrm))
        return lp, ln

    lp, ln = face_point(faces[0])
    lmat = jnp.full_like(u1, faces[0][14])
    prev_cum = faces[0][0]
    for f in faces[1:]:
        take = u_face >= prev_cum
        p2, n2 = face_point(f)
        lp = vec.where(take, p2, lp)
        ln = vec.where(take, n2, ln)
        lmat = jnp.where(take, f[14], lmat)
        prev_cum = f[0]
    return lp, ln, lmat.astype(jnp.int32)


def _sample_lights_gather(faces: tuple, u_face, u1, u2):
    """Gather-based face sampler for LARGE light tables (F >
    UNROLL_MAX_FACES): per-lane face id via searchsorted on the CDF
    column, then 15 per-lane takes of the [F]-row table planes. The
    small-table gathers are F-independent, so compile time and runtime
    stop scaling with the light count. Semantics match the unroll
    exactly: u in [cum_{j-1}, cum_j) selects face j (side='right')."""
    tab = np.asarray(faces, np.float32)          # [F,16] host constant
    cum = jnp.asarray(tab[:-1, 0])               # last cum pinned to 1.0
    fi = jnp.searchsorted(cum, u_face, side="right").astype(jnp.int32)

    def g(col):
        return jnp.take(jnp.asarray(tab[:, col]), fi)

    kind = g(1)
    o = V3(g(2), g(3), g(4))
    # sphere branch (branchless; both forms computed, lanes select)
    r = g(15)
    z = 1.0 - 2.0 * u1
    rxy = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = u2 * (2.0 * math.pi)
    w = V3(rxy * jnp.cos(phi), rxy * jnp.sin(phi), z)
    lp_s = V3(o.x + r * w.x, o.y + r * w.y, o.z + r * w.z)
    # parallelogram branch
    eu = V3(g(5), g(6), g(7))
    ev = V3(g(8), g(9), g(10))
    nrm = V3(g(11), g(12), g(13))
    lp_p = V3(o.x + u1 * eu.x + u2 * ev.x,
              o.y + u1 * eu.y + u2 * ev.y,
              o.z + u1 * eu.z + u2 * ev.z)
    sph = kind >= 0.5
    lp = vec.where(sph, lp_s, lp_p)
    ln = vec.where(sph, w, nrm)
    return lp, ln, g(14).astype(jnp.int32)


_LUM = (0.2126, 0.7152, 0.0722)


def build_env_alias(env: np.ndarray):
    """Alias table for env-map importance sampling (env NEE).

    `env` is the [He,We,3] equirect radiance image. Texel weights are
    luminance * (exact texel solid angle), so the solid-angle pdf of any
    direction d collapses to a CONSTANT times the luminance of d's
    texel: pdf(d) = lum(d) * C, C = We / (2*pi * sum(lum*dcos)). That
    makes the MIS weight on the BSDF side free: the miss path already
    fetched the texel RGB.

    Returns (alias [T] int32, prob [T] float32, C float) or None for a
    black/absent env. Vose construction, vectorized-ish numpy; T = He*We.
    """
    he, we = env.shape[0], env.shape[1]
    if he * we <= 1:
        return None
    lum = (env[..., 0] * _LUM[0] + env[..., 1] * _LUM[1]
           + env[..., 2] * _LUM[2]).astype(np.float64)
    # exact per-row solid angle: integral of sin over the texel band
    edges = np.cos(np.arange(he + 1, dtype=np.float64) * math.pi / he)
    dcos = edges[:-1] - edges[1:]
    w = (lum * dcos[:, None]).reshape(-1)
    total = w.sum()
    if total <= 0:
        return None
    t = w.size
    p = w / total * t
    alias = np.arange(t, dtype=np.int64)
    prob = p.copy()
    small = [i for i in np.nonzero(p < 1.0)[0]]
    large = [i for i in np.nonzero(p >= 1.0)[0]]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    # pdf(d) = P(texel)/dOmega(texel) = lum(d) * C with
    # C = we / (2*pi * total) — EXACT because theta is sampled with
    # cos(theta) linear within the band (see sample_env_planar).
    c = we / (2.0 * math.pi * total)
    return (alias.astype(np.int32), prob.astype(np.float32), float(c))


def sample_env_planar(textures, u_idx, u_acc, u_x, u_y):
    """Draw one env-map direction per lane from the alias table.

    Returns (wl V3, le V3). Directions invert the equirect mapping of
    ops/wavefront._env_flat_index; theta is sampled with cos(theta)
    LINEAR within the texel band (uniform in solid angle), which is what
    makes pdf(d) = env_lum(le) * C exact. Le is fetched via the
    packed-RGBE plane when present (bitwise equal to the f32 planes)."""
    from . import wavefront as wf  # _unpack_rgbe (no import cycle: lazy)
    he, we = textures.env.shape[0], textures.env.shape[1]
    t = he * we
    i = jnp.clip((u_idx * t).astype(jnp.int32), 0, t - 1)
    take_alias = u_acc >= jnp.take(textures.env_prob, i)
    idx = jnp.where(take_alias, jnp.take(textures.env_alias, i), i)
    y = (idx // we).astype(jnp.float32)
    x = (idx % we).astype(jnp.float32)
    c0 = jnp.cos(y * (math.pi / he))
    c1 = jnp.cos((y + 1.0) * (math.pi / he))
    ct = c0 + u_y * (c1 - c0)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    a = ((x + u_x) / we - 0.5) * (2.0 * math.pi)
    wl = V3(st * jnp.sin(a), ct, -st * jnp.cos(a))
    if textures.env_packed.shape[0] == t:
        le = wf._unpack_rgbe(jnp.take(textures.env_packed, idx),
                             textures.env_enabled)
    else:
        le = V3(jnp.take(textures.env[:, :, 0].reshape(-1), idx),
                jnp.take(textures.env[:, :, 1].reshape(-1), idx),
                jnp.take(textures.env[:, :, 2].reshape(-1), idx))
    return wl, le


def env_lum(v: V3):
    """Luminance plane matching build_env_alias' texel weights."""
    return v.x * _LUM[0] + v.y * _LUM[1] + v.z * _LUM[2]


def shadow_setup(p: V3, lp: V3, ln: V3, total_area: float):
    """Shadow-ray direction + area-form geometry term.

    Returns (wl V3, dist [N], geom [N]) with
    geom = |cos_l| * A_total / d^2 (two-sided emitters — see module doc).
    """
    dv = V3(lp.x - p.x, lp.y - p.y, lp.z - p.z)
    dist = jnp.sqrt(jnp.maximum(vec.dot(dv, dv), 1e-12))
    wl = V3(dv.x / dist, dv.y / dist, dv.z / dist)
    cos_l = jnp.abs(vec.dot(ln, wl))
    geom = cos_l * total_area / (dist * dist)
    return wl, dist, geom
