"""Planar (component-SoA) 3-vector math for the hot path.

Layout rationale: a logical [N,3] array puts a length-3 axis innermost, so
elementwise work and memory transfers are strided or padded by it. The
structure-of-arrays form is therefore *planar*: three flat [N] arrays
(x, y, z), each contiguous over N (coalesced loads on a GPU). This module is the vocabulary the wavefront kernels
(ops/camera, ops/intersect, ops/bsdf) are written in; [N,3] appears only at
host boundaries (scene tables, final image assembly).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class V3(NamedTuple):
    """Three same-shaped arrays; a pytree, so it flows through jit/scan."""
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)


def splat(v, like=None) -> V3:
    """Broadcast a length-3 constant/array (or python seq) to a V3 of
    scalars (or arrays shaped like `like`)."""
    x, y, z = v[0], v[1], v[2]
    if like is not None:
        shp = jnp.shape(like)
        x = jnp.broadcast_to(x, shp)
        y = jnp.broadcast_to(y, shp)
        z = jnp.broadcast_to(z, shp)
    return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def from_rows(a) -> V3:
    """[N,3] (or [3]) jnp array -> V3 of [N] (or scalar) components."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: V3) -> jnp.ndarray:
    """V3 of [N] components -> [N,3]."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot(a: V3, b: V3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def norm(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """Unit vector; zero/near-zero lanes pass through unscaled.

    Double-where instead of max(dot, 1e-30): rsqrt's VJP factor is
    -ans^3/2 = 1e45 at the old floor — inf in f32 — and JAX's max
    transpose multiplies by an indicator instead of selecting, so dead
    lanes' 0 cotangent times that inf NaN'ed every gradient flowing
    through a wavefront with zero-vector lanes (miss lanes' normals are
    zero; hit lanes are unchanged bitwise — their dot passes the same
    value through). Legit directions have norm >= 1/max-scale >> 1e-6."""
    d2 = dot(a, a)
    return a * jax.lax.rsqrt(jnp.where(d2 > 1e-12, d2, 1.0))


def where(c, a: V3, b: V3) -> V3:
    return V3(jnp.where(c, a.x, b.x), jnp.where(c, a.y, b.y),
              jnp.where(c, a.z, b.z))


def select3(c, a, b):
    """Scalar/array where() convenience for non-V3 operands."""
    return jnp.where(c, a, b)


def xform_pt(mat, p: V3) -> V3:
    """Affine transform by a single [4,4] matrix (rows are scalars, so this
    is 9 FMAs on [N] planes — full VPU utilization, full f32)."""
    return V3(
        mat[0, 0] * p.x + mat[0, 1] * p.y + mat[0, 2] * p.z + mat[0, 3],
        mat[1, 0] * p.x + mat[1, 1] * p.y + mat[1, 2] * p.z + mat[1, 3],
        mat[2, 0] * p.x + mat[2, 1] * p.y + mat[2, 2] * p.z + mat[2, 3],
    )


def xform_dir(mat, v: V3) -> V3:
    return V3(
        mat[0, 0] * v.x + mat[0, 1] * v.y + mat[0, 2] * v.z,
        mat[1, 0] * v.x + mat[1, 1] * v.y + mat[1, 2] * v.z,
        mat[2, 0] * v.x + mat[2, 1] * v.y + mat[2, 2] * v.z,
    )


def gather_rows(table, idx) -> V3:
    """table [M,3] gathered by idx [N] -> V3 of [N]. For small M the gather
    is cheap; kernels that need it hotter unroll a masked-select instead."""
    g = jnp.take(table, idx, axis=0)
    return V3(g[:, 0], g[:, 1], g[:, 2])
