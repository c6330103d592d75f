"""Camera ray generation (wavefront stage 1).

Structure-of-arrays re-design of generateRayFromCamera
(reference: src/pathtrace.cu:122-143):
    dir = normalize(view - right*pl.x*(x - W/2) - up*pl.y*(y - H/2))
Both offsets subtracted -> the raw framebuffer is x-mirrored and the save
path compensates (reference: src/main.cpp:87). We reproduce both.

Implements the three ray-gen TODO slots of the reference
(src/pathtrace.cu:118-120): stochastic antialiasing (sub-pixel jitter),
thin-lens depth of field, and motion-blur time jitter.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.math import TWO_PI


def generate_rays(cam: dict, width: int, height: int, key: jax.Array,
                  antialias: bool = True):
    """Build the primary-ray wavefront.

    Args:
      cam: Camera.flat() dict of float32 params (differentiable pytree).
      key: per-iteration PRNG key (folded upstream with the iteration index,
           mirroring makeSeededRandomEngine decorrelation,
           reference src/pathtrace.cu:41-45).

    Returns:
      origins [N,3], dirs [N,3] (normalized), times [N] in [0,1).
      N = width*height; path i maps to pixel (i % W, i // W)
      (reference: src/pathtrace.cu:128,140).
    """
    n = width * height
    idx = jnp.arange(n, dtype=jnp.int32)
    x = (idx % width).astype(jnp.float32)
    y = (idx // width).astype(jnp.float32)

    k_aa, k_lens, k_time = jax.random.split(key, 3)
    if antialias:
        jit_xy = jax.random.uniform(k_aa, (n, 2), jnp.float32)
        x = x + jit_xy[:, 0]
        y = y + jit_xy[:, 1]

    view = cam["view"]
    right = cam["right"]
    up = cam["up"]
    pl = cam["pixel_length"]

    d = (view[None, :]
         - right[None, :] * (pl[0] * (x - width * 0.5))[:, None]
         - up[None, :] * (pl[1] * (y - height * 0.5))[:, None])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam["position"][None, :], (n, 3))

    # Thin-lens DoF (reference TODO: src/pathtrace.cu:120): jitter origin on a
    # disk of radius `aperture`, re-aim at the focal plane point.
    aperture = cam["aperture"]
    focal = cam["focal_distance"]
    u_lens = jax.random.uniform(k_lens, (n, 2), jnp.float32)
    r = jnp.sqrt(u_lens[:, 0]) * aperture
    phi = u_lens[:, 1] * TWO_PI
    lens_off = (right[None, :] * (r * jnp.cos(phi))[:, None]
                + up[None, :] * (r * jnp.sin(phi))[:, None])
    focus_pt = o + d * jnp.maximum(focal, 1e-6)
    o_dof = o + lens_off
    d_dof = focus_pt - o_dof
    d_dof = d_dof / jnp.linalg.norm(d_dof, axis=-1, keepdims=True)
    use_dof = (aperture > 0.0) & (focal > 0.0)
    o = jnp.where(use_dof, o_dof, o)
    d = jnp.where(use_dof, d_dof, d)

    # Motion blur (reference TODO: src/pathtrace.cu:119): per-path shutter time.
    shutter = cam["shutter"]
    times = jax.random.uniform(k_time, (n,), jnp.float32) * shutter
    return o, d, times
