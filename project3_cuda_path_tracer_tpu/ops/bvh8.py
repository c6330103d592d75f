"""8-wide BVH: the host packer and the mesh traversal.

The packer collapses one mesh's binned-SAH binary tree (scene/bvh.py) into
an 8-ary tree: ~7x fewer interior nodes, and paths log8 deep instead of
log2. The traversal reads the packed tables in one of two ways, chosen by
the platform the program is lowered for:

  * ``cuda``: a CUDA kernel (native/src/bvh8_traverse.cu) called through
    XLA's foreign function interface — one thread per ray with a private
    stack, pushing children far-to-near along each node's sort axis by the
    ray's own direction sign. A per-ray divergent stack walk is what SIMT
    hardware runs natively; XLA can only express it as a whole-wavefront
    while loop whose trip count is the slowest ray's. The library is built
    from the repository's source at first use (`make -C native cuda`); a
    GPU program that cannot build or load it fails rather than fall back.
  * every other platform (the CPU tests): the plain XLA walk over the
    binary tree, ops/intersect.bvh_traverse — the oracle the kernel is
    checked against.

Both return the same record: (t, (nx, ny, nz), u, v, tri), where t is the
object-space hit distance (the bound itself on a miss), the normal and uv
are interpolated from the winning triangle, and tri is the mesh-local
triangle index (-1 on a miss). Rays with t_bound <= 0 are dead and report a
miss. The traversal has no VJP: callers stop_gradient its inputs and
recompute differentiable attributes from the winning triangle.

Layout (host-collapsed from the binary tree):
  nodes_f [B8, 72] f32 — child c occupies cols [6c, 6c+6) = lo.xyz, hi.xyz;
                          empty slots hold NaN boxes; cols 48-71 pad.
  nodes_i [B8, 24] i32 — col c: child c's PRE-ENCODED stack entry (node row
                          if interior, -(start*32+count)-2 if leaf, 0 for
                          empty slots — the root row 0 is nobody's child);
                          col 16: child sort axis 0/1/2.
  tris    [T+8, 24] f32 — v0, e1, e2, n0, n1, n2 (xyz each), uv0, uv1, uv2;
                          8 trailing zero rows (det = 0, never hit).
"""
from __future__ import annotations

import ctypes
import functools
import sys
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..scene import types as T
from ..utils import native
from . import intersect

WIDTH = 8          # children per node
STACK = 128        # per-ray stack entries; must match the CUDA kernel
TRI_ROW = 24       # floats per packed triangle row
# Fat leaves: a whole binary SUBTREE whose triangles (contiguous in the
# DFS perm order) number <= WIDE_LEAF_K becomes ONE leaf child. 4 = the
# binary SAH leaf maximum (ops/intersect.LEAF_K), so the merge only fuses
# single-leaf subtrees. A choice made on the previous accelerator; an H100
# mesh cell decides it again.
WIDE_LEAF_K = 4    # meta = start*32 + count (encoding allows up to 31).

# FFI target names of the two kernel modes, and their library symbols.
_TARGETS = {False: ("pt_bvh8_nearest", "PtBvh8Nearest"),
            True: ("pt_bvh8_any_hit", "PtBvh8AnyHit")}


class PackedMesh8(NamedTuple):
    """One mesh in the 8-wide layout (root node = row 0)."""
    nodes_f: jnp.ndarray   # [B8, 72] f32
    nodes_i: jnp.ndarray   # [B8, 24] i32
    tris: jnp.ndarray      # [T+8, TRI_ROW] f32


def _local_binary(meshes: T.MeshBundle, mesh_index: int):
    """Rebase one mesh's binary BVH out of the concatenated bundle:
    node indices local (root 0), tri starts local."""
    roots = np.asarray(meshes.mesh_root, np.int64)
    tri_offs = np.asarray(meshes.mesh_tri_offset, np.int64)
    b_total = np.asarray(meshes.node_lo).shape[0]
    t_total = np.asarray(meshes.tri_v0).shape[0]
    n0 = int(roots[mesh_index])
    n1 = int(roots[mesh_index + 1]) if mesh_index + 1 < len(roots) else b_total
    t0 = int(tri_offs[mesh_index])
    t1 = (int(tri_offs[mesh_index + 1]) if mesh_index + 1 < len(tri_offs)
          else t_total)
    lo = np.asarray(meshes.node_lo, np.float32)[n0:n1]
    hi = np.asarray(meshes.node_hi, np.float32)[n0:n1]
    start = np.asarray(meshes.node_start, np.int64)[n0:n1]
    count = np.asarray(meshes.node_count, np.int64)[n0:n1]
    right = np.asarray(meshes.node_right, np.int64)[n0:n1]
    start = np.where(count > 0, start - t0, -1)
    right = np.where(right >= 0, right - n0, -1)
    return lo, hi, start, count, right, t0, t1


def _pack_tris(meshes: T.MeshBundle, t0: int, t1: int) -> np.ndarray:
    t = t1 - t0
    sl = slice(t0, t1)
    tris = np.zeros((t + 8, TRI_ROW), np.float32)
    tris[:t, 0:3] = np.asarray(meshes.tri_v0, np.float32)[sl]
    tris[:t, 3:6] = np.asarray(meshes.tri_e1, np.float32)[sl]
    tris[:t, 6:9] = np.asarray(meshes.tri_e2, np.float32)[sl]
    tris[:t, 9:12] = np.asarray(meshes.tri_n0, np.float32)[sl]
    tris[:t, 12:15] = np.asarray(meshes.tri_n1, np.float32)[sl]
    tris[:t, 15:18] = np.asarray(meshes.tri_n2, np.float32)[sl]
    tris[:t, 18:20] = np.asarray(meshes.tri_uv0, np.float32)[sl]
    tris[:t, 20:22] = np.asarray(meshes.tri_uv1, np.float32)[sl]
    tris[:t, 22:24] = np.asarray(meshes.tri_uv2, np.float32)[sl]
    return tris


def pack_mesh8(meshes: T.MeshBundle, mesh_index: int = 0) -> PackedMesh8:
    """Collapse one mesh's binary BVH into the 8-wide layout.

    Collapse rule: start from a binary interior node's two children and
    repeatedly replace the interior child with the LARGEST surface area by
    its two children until 8 slots are used (the classic BVH8 grow-widest
    heuristic — the biggest boxes are the ones most worth testing early
    and in parallel).
    """
    lo, hi, start, count, right, t0, t1 = _local_binary(meshes, mesh_index)
    b_n = lo.shape[0]

    # Subtree tri ranges (contiguous because flattening is DFS with
    # leaf-contiguous perm, scene/bvh.py): reverse-index post-order pass.
    r0 = np.full(b_n, -1, np.int64)
    r1 = np.full(b_n, -1, np.int64)
    for b in range(b_n - 1, -1, -1):
        if count[b] > 0:
            r0[b], r1[b] = start[b], start[b] + count[b]
        else:
            l, r = b + 1, int(right[b])
            r0[b] = min(r0[l], r0[r])
            r1[b] = max(r1[l], r1[r])

    def is_fat_leaf(k: int) -> bool:
        return count[k] > 0 or (r1[k] - r0[k]) <= WIDE_LEAF_K

    def leaf_meta(k: int) -> int:
        s, c = (int(start[k]), int(count[k])) if count[k] > 0 else (
            int(r0[k]), int(r1[k] - r0[k]))
        assert 0 < c <= WIDE_LEAF_K
        return s * 32 + c

    nodes_f_rows: list = []
    nodes_i_rows: list = []

    def kids_of(b: int):
        kids = [b + 1, int(right[b])]
        while len(kids) < WIDTH:
            best_i, best_sa = -1, -1.0
            for i, k in enumerate(kids):
                if not is_fat_leaf(k):
                    d = np.maximum(hi[k] - lo[k], 0.0)
                    sa = float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
                    if sa > best_sa:
                        best_sa, best_i = sa, i
            if best_i < 0:
                break
            k = kids.pop(best_i)
            kids.append(k + 1)
            kids.append(int(right[k]))
        return kids

    max_depth = 0

    def build(b: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        my = len(nodes_f_rows)
        f = np.zeros(72, np.float32)
        ii = np.full(24, -1, np.int32)
        nodes_f_rows.append(f)
        nodes_i_rows.append(ii)
        kids = kids_of(b)
        # Ordered traversal: sort children ascending by box center along
        # the parent's largest axis, so a ray can visit them near-to-far
        # from its direction sign along that axis.
        axis = int(np.argmax(hi[b] - lo[b]))
        kids.sort(key=lambda k: float(lo[k][axis] + hi[k][axis]))
        ii[16] = axis
        ii[:16] = 0
        for c, k in enumerate(kids):
            f[6 * c: 6 * c + 3] = lo[k]
            f[6 * c + 3: 6 * c + 6] = hi[k]
            if is_fat_leaf(k):
                ii[c] = -leaf_meta(k) - 2
        for c in range(len(kids), WIDTH):
            # NaN box: every slab comparison is false
            f[6 * c: 6 * c + 6] = np.nan
        for c, k in enumerate(kids):
            if not is_fat_leaf(k):
                ii[c] = build(k, depth + 1)
        return my

    if count[0] > 0:
        # whole mesh is a single binary leaf: one 8-wide node, one leaf slot
        f = np.zeros(72, np.float32)
        ii = np.full(24, -1, np.int32)
        ii[:16] = 0
        ii[16] = 0
        f[0:3], f[3:6] = lo[0], hi[0]
        for c in range(1, WIDTH):
            f[6 * c: 6 * c + 6] = np.nan
        ii[0] = -(int(start[0]) * 32 + int(count[0])) - 2
        nodes_f_rows.append(f)
        nodes_i_rows.append(ii)
        max_depth = 1
    else:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            build(0, 1)
        finally:
            sys.setrecursionlimit(old)

    # Worst-case stack: each level on the DFS path parks <= WIDTH-1
    # siblings, and the deepest node pushes <= WIDTH children.
    bound = (WIDTH - 1) * max_depth + 1
    assert bound <= STACK, (
        f"BVH8 worst-case stack {bound} exceeds STACK={STACK} "
        f"(tree depth {max_depth}); raise STACK here and in "
        f"native/src/bvh8_traverse.cu")

    return PackedMesh8(
        nodes_f=jnp.asarray(np.stack(nodes_f_rows)),
        nodes_i=jnp.asarray(np.stack(nodes_i_rows)),
        tris=jnp.asarray(_pack_tris(meshes, t0, t1)))


def pack_all8(meshes: T.MeshBundle):
    """One PackedMesh8 per mesh in the bundle (empty tuple for no meshes)."""
    k = int(np.asarray(meshes.mesh_root).shape[0])
    if int(np.asarray(meshes.tri_v0).shape[0]) <= 1:
        return ()
    return tuple(pack_mesh8(meshes, i) for i in range(k))


@functools.cache
def register_cuda_targets():
    """Build (if needed) and load the CUDA library, and register both
    traversal modes as FFI targets. Raises RuntimeError when the library
    cannot be built; the loaded library stays referenced for the life of
    the process."""
    lib = ctypes.CDLL(native.cuda_library())
    for name, symbol in _TARGETS.values():
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
    return lib


def _interp_attrs(tris, tri, bu, bv):
    """Smooth normal and uv of the winning local triangle (zeros on a
    miss), the same interpolation the CUDA kernel does in-register."""
    rows = jnp.take(tris, jnp.maximum(tri, 0), axis=0)
    bw = 1.0 - bu - bv
    hit = tri >= 0

    def lerp(c0, c1, c2):
        val = bw * rows[:, c0] + bu * rows[:, c1] + bv * rows[:, c2]
        return jnp.where(hit, val, 0.0)

    return ((lerp(9, 12, 15), lerp(10, 13, 16), lerp(11, 14, 17)),
            lerp(18, 20, 22), lerp(19, 21, 23))


def traverse_walk(qo, qd, t_bound, packed: PackedMesh8,
                  meshes: T.MeshBundle, mesh_index):
    """The plain XLA walk (ops/intersect.bvh_traverse over the binary
    tree of mesh `mesh_index` in the bundle), returning the kernel's
    record. Nearest hit is also a valid any-hit answer."""
    o = jnp.stack(qo, axis=-1)
    d = jnp.stack(qd, axis=-1)
    t, tri_g, bu, bv = intersect.bvh_traverse(
        o, d, meshes, meshes.mesh_root[mesh_index], t_bound=t_bound)
    tri = jnp.where(tri_g >= 0, tri_g - meshes.mesh_tri_offset[mesh_index],
                    -1)
    normal, u, v = _interp_attrs(packed.tris, tri, bu, bv)
    return t, normal, u, v, tri


def traverse_cuda(qo, qd, t_bound, packed: PackedMesh8,
                  any_hit: bool = False):
    """The CUDA kernel as a JAX operation (no VJP; inputs must be
    stop_gradient'ed by the caller). Any ray count: the kernel guards its
    tail, so nothing is padded."""
    n = qo[0].shape[0]
    plane = jax.ShapeDtypeStruct((n,), jnp.float32)
    name, _ = _TARGETS[bool(any_hit)]
    call = jax.ffi.ffi_call(
        name, (plane,) * 6 + (jax.ShapeDtypeStruct((n,), jnp.int32),))
    rays = [jnp.asarray(p, jnp.float32) for p in (*qo, *qd, t_bound)]
    t, nx, ny, nz, u, v, tri = call(
        *rays, jnp.asarray(packed.nodes_f, jnp.float32),
        jnp.asarray(packed.nodes_i, jnp.int32),
        jnp.asarray(packed.tris, jnp.float32))
    return t, (nx, ny, nz), u, v, tri


def traverse(qo, qd, t_bound, packed: PackedMesh8, meshes: T.MeshBundle,
             mesh_index, any_hit: bool = False, mesh=None):
    """Mesh-local nearest (or any) hit for planar object-space rays.

    `qo`, `qd`: 3-tuples of [N] planes; `t_bound` [N] (<= 0 = dead ray).
    The CUDA kernel runs where the program is lowered for a CUDA device,
    the plain walk everywhere else. `mesh` (a jax.sharding.Mesh with a
    'data' axis) runs the traversal per shard under shard_map: a foreign
    call has no partitioning rule, so GSPMD would otherwise gather the
    whole wavefront onto every device around it."""
    if jax.default_backend() == "gpu":
        register_cuda_targets()

    def run(qo, qd, t_bound, packed):
        return jax.lax.platform_dependent(
            qo, qd, t_bound, packed,
            cuda=lambda *a: traverse_cuda(*a, any_hit=any_hit),
            default=lambda *a: traverse_walk(*a, meshes, mesh_index))

    if mesh is None:
        return run(qo, qd, t_bound, packed)
    from jax.sharding import PartitionSpec as P
    rays, rep = P("data"), P()
    return jax.shard_map(
        run, mesh=mesh,
        in_specs=((rays,) * 3, (rays,) * 3, rays, rep),
        out_specs=(rays, (rays,) * 3, rays, rays, rays),
        check_vma=False)(tuple(qo), tuple(qd), t_bound, packed)

