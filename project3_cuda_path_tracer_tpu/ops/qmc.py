"""Hash-based Owen-scrambled Sobol (0,2)-sequences for stratified
sampling (`--stratified`), after Burley, "Practical Hash-based Owen
Scrambling" (JCGT 2020).

Why this over rank-1 lattices: the 2-D Sobol pair is a (0,2)-sequence —
every power-of-2 prefix places exactly one point in every aligned
2^a x 2^b cell (perfect low-spp stratification, no lattice aliasing) —
and per-dimension hash-based Owen scrambling keeps that property while
decorrelating pixels/bounces, so padding many 2-D pairs stays sound.

Everything is elementwise u32 bit math on [N] planes — no tables, no
gathers. The second Sobol dimension's generator matrix is the Pascal
matrix: its columns satisfy c_k = c_{k-1} ^ (c_{k-1} >> 1) from
c_0 = 0x80000000, so it is generated at import time. The full 32 bits
of the (shuffled) index are expanded — the index shuffle is a bijection
on u32, so truncating would alias distinct iterations onto the same
Sobol point (bias).

Cost: ~4 x 32 unrolled bit rows per pair; only paid under
--stratified (and a variance cut far larger than the cost under --nee).
"""
from __future__ import annotations

import jax.numpy as jnp

INDEX_BITS = 32

# second-dimension generator columns (Pascal matrix mod 2)
_SOBOL2 = []
_c = 0x80000000
for _ in range(INDEX_BITS):
    _SOBOL2.append(_c)
    _c = (_c ^ (_c >> 1)) & 0xFFFFFFFF


def _u32(x) -> jnp.ndarray:
    return x.astype(jnp.uint32)


def hash32(x: jnp.ndarray, salt: int) -> jnp.ndarray:
    """Full-avalanche 32-bit integer hash (finalizer-style) of a [N]
    plane — seeds for the per-(pixel, depth, pair) scrambles."""
    x = _u32(x) ^ jnp.uint32(salt & 0xFFFFFFFF)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def reverse_bits32(x: jnp.ndarray) -> jnp.ndarray:
    x = _u32(x)
    x = ((x & jnp.uint32(0x55555555)) << 1) | ((x >> 1)
                                               & jnp.uint32(0x55555555))
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2)
                                               & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4)
                                               & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8)
                                               & jnp.uint32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def laine_karras(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Laine-Karras-style hash: each output bit depends only on LOWER
    input bits + seed, i.e. a valid Owen scramble in the reversed-bit
    domain (multiplication only carries upward)."""
    x = _u32(x)
    x = x + _u32(seed)
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def owen_scramble(bits: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Owen-scramble a radical-inverse value (given in NORMAL bit order,
    MSB = first digit)."""
    return reverse_bits32(laine_karras(reverse_bits32(bits), seed))


def sobol2d_bits(index: jnp.ndarray):
    """The (x, y) Sobol pair for [N] u32 indices, as u32 fixed-point bit
    patterns (MSB-first radical-inverse domain)."""
    idx = _u32(index)
    x = reverse_bits32(idx)  # dim 0: van der Corput
    y = jnp.zeros_like(idx)
    for k in range(INDEX_BITS):
        take = jnp.uint32(0) - ((idx >> k) & jnp.uint32(1))  # 0 or all-ones
        y = y ^ (take & jnp.uint32(_SOBOL2[k]))
    return x, y


_INV32 = float(2.0 ** -32)


def owen_sobol_pair(index: jnp.ndarray, seed_shuffle: jnp.ndarray,
                    seed_x: jnp.ndarray, seed_y: jnp.ndarray):
    """One padded Owen-Sobol 2-D sample per lane: the per-lane-shuffled
    index's Sobol point, Owen-scrambled per dimension. Returns two f32
    planes in [0, 1)."""
    # index shuffle (Owen permutation of the index) decorrelates padded
    # pairs that share the same progressive index; a u32 bijection, so
    # the full 32 bits feed the Sobol expansion
    idx = reverse_bits32(laine_karras(reverse_bits32(_u32(index)),
                                      seed_shuffle))
    bx, by = sobol2d_bits(idx)
    bx = owen_scramble(bx, seed_x)
    by = owen_scramble(by, seed_y)
    return (bx.astype(jnp.float32) * _INV32,
            by.astype(jnp.float32) * _INV32)


def sample_planes(iteration, depth, pixel_index, num_dims: int, salt: int):
    """`num_dims` stratified uniform planes for (iteration, depth,
    pixel): padded Owen-Sobol 2-D pairs, each pair owen-scrambled and
    index-shuffled by per-(pixel, depth, pair) seeds. Drop-in for the
    lattice-based ops/wavefront.stratified_planes."""
    mix = _u32(pixel_index) ^ (jnp.asarray(depth, jnp.uint32)
                               * jnp.uint32(0x9E3779B9))
    it = jnp.broadcast_to(jnp.asarray(iteration, jnp.uint32),
                          pixel_index.shape)
    out = []
    for p in range((num_dims + 1) // 2):
        s = salt + 0x1000 * p
        ux, uy = owen_sobol_pair(it,
                                 hash32(mix, s),
                                 hash32(mix, s + 1),
                                 hash32(mix, s + 2))
        out.extend((ux, uy))
    return tuple(out[:num_dims])
