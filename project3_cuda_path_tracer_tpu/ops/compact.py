"""Stream compaction + material-key sorting under XLA static shapes.

The reference plans thrust-style compaction that *shrinks* the wavefront each
bounce (reference: src/pathtrace.cu:313-317, stream_compaction/CMakeLists.txt)
and material-key sorting for memory-coherent shading
(reference: src/pathtrace.cu:366-367). XLA has no dynamic shapes, so the
formulation here is:

  * compaction = stable partition into the same fixed-capacity buffer
    (live paths first) + a `num_live` scalar — downstream kernels mask on
    liveness and can bound work by `num_live`;
  * material sort = stable sort_key_val on a composite key that orders
    (live, material) groups contiguously — the MoE/expert-routing idiom
    applied to rays (SURVEY §2.3).

Both are built on an exclusive scan, the same primitive the reference's
stream_compaction library socket calls for.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

DEAD_KEY = jnp.int32(0x7FFFFFFF)
MISS_KEY = jnp.int32(0x3FFFFFFF)


def exclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum along the last axis (the scan at the heart of
    GPU stream compaction; maps to XLA's fused cumsum)."""
    return jnp.cumsum(x, axis=-1) - x


def compaction_permutation(alive: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable-partition permutation: indices of live paths first, dead after.

    Returns (perm [N] int32, num_live scalar int32). Equivalent to
    scan+scatter compaction but expressed as a gather (XLA schedules a
    gather better than a scatter).
    """
    alive_i = alive.astype(jnp.int32)
    n = alive.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    live_pos = exclusive_scan(alive_i)                 # rank among live
    num_live = jnp.sum(alive_i)
    dead_pos = num_live + (idx - live_pos)             # rank among dead
    dest = jnp.where(alive, live_pos, dead_pos)
    perm = jnp.zeros((n,), jnp.int32).at[dest].set(idx)
    return perm, num_live


def material_sort_key(alive: jnp.ndarray, hit_t: jnp.ndarray,
                      mat_id: jnp.ndarray) -> jnp.ndarray:
    """Composite sort key: live hits grouped by material, then live misses,
    then dead paths (so one sort does both compaction and material
    clustering)."""
    m = jnp.where(hit_t > 0, mat_id, MISS_KEY)
    return jnp.where(alive, m, DEAD_KEY)


def sort_permutation(keys: jnp.ndarray) -> jnp.ndarray:
    """Stable ascending-sort permutation of `keys`."""
    return jnp.argsort(keys, stable=True).astype(jnp.int32)


def apply_permutation(tree, perm: jnp.ndarray):
    """Gather every leaf of a pytree of [N,...] arrays by `perm`."""
    return jax.tree_util.tree_map(lambda a: jnp.take(a, perm, axis=0), tree)


def bucket_sort_permutation(bucket_ids: jnp.ndarray,
                            num_buckets: int) -> jnp.ndarray:
    """Stable counting-sort permutation for a SMALL static bucket count.

    O(num_buckets) exclusive scans instead of a full argsort — the right
    shape for material routing where buckets = materials + miss + dead
    (the reference's sort-by-material-key idiom, src/pathtrace.cu:366-367).
    """
    n = bucket_ids.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    dest = jnp.zeros((n,), jnp.int32)
    offset = jnp.int32(0)
    for b in range(num_buckets):
        mask = (bucket_ids == b).astype(jnp.int32)
        ranks = exclusive_scan(mask)
        count = ranks[-1] + mask[-1]
        dest = jnp.where(mask > 0, offset + ranks, dest)
        offset = offset + count
    return jnp.zeros((n,), jnp.int32).at[dest].set(idx)


def material_bucket_ids(alive: jnp.ndarray, hit_t: jnp.ndarray,
                        mat_id: jnp.ndarray, num_materials: int):
    """(bucket_ids, num_buckets): live hits by material, then live misses,
    then dead lanes."""
    m = jnp.where(hit_t > 0, mat_id, jnp.int32(num_materials))
    ids = jnp.where(alive, m, jnp.int32(num_materials + 1))
    return ids, num_materials + 2
