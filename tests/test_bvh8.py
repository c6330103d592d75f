"""8-wide BVH (ops/bvh8): packer invariants, the plain walk against a
brute-force Moller-Trumbore reference, the CUDA wrapper's call contract,
and platform selection. The CUDA kernel itself runs only on the card
(`gpu` marker; also checked by chip_smoke.py)."""
import os
import stat

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.ops import bvh8 as PB8
from project3_cuda_path_tracer_tpu.scene import bvh as B
from project3_cuda_path_tracer_tpu.utils import native


@pytest.fixture(scope="module")
def blob():
    return load_scene("scenes/mesh.txt")


@pytest.fixture(scope="module")
def torus_bundle():
    return B.build_mesh_bundle(["scenes/meshes/torus.obj"])


@pytest.fixture(scope="module")
def packed8(blob):
    return PB8.pack_mesh8(blob.meshes, 0)


def _bundle(name, blob, torus_bundle):
    return blob.meshes if name == "blob" else torus_bundle


def _aimed_rays(n, seed=0, radius=3.0, spread=0.4):
    """Rays from random origins on a sphere aimed near the mesh center, so
    most of them hit."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32)
    o /= np.linalg.norm(o, axis=0, keepdims=True)
    o *= radius
    target = rng.uniform(-spread, spread, size=(3, n)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def _brute_force(o, d, meshes, t_bound):
    """Nearest Moller-Trumbore hit over EVERY triangle (numpy, float64
    intermediates): (t, tri) with tri -1 on a miss."""
    v0 = np.asarray(meshes.tri_v0, np.float64)
    e1 = np.asarray(meshes.tri_e1, np.float64)
    e2 = np.asarray(meshes.tri_e2, np.float64)
    n = o.shape[1]
    t_best = np.asarray(t_bound, np.float64).copy()
    tri = np.full(n, -1, np.int64)
    for i in range(n):
        if t_best[i] <= 0:
            continue
        oi, di = o[:, i].astype(np.float64), d[:, i].astype(np.float64)
        p = np.cross(di[None, :], e2)
        det = np.einsum("ij,ij->i", e1, p)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = oi[None, :] - v0
        u = np.einsum("ij,ij->i", tv, p) * inv
        q = np.cross(tv, e1)
        v = (q @ di) * inv
        t = np.einsum("ij,ij->i", e2, q) * inv
        good = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) \
            & (t < t_best[i])
        if good.any():
            k = int(np.argmin(np.where(good, t, np.inf)))
            t_best[i], tri[i] = t[k], k
    return t_best, tri


def _walk(o, d, t_bound, meshes, packed):
    f = jax.jit(lambda qo, qd, tb: PB8.traverse_walk(
        qo, qd, tb, packed, meshes, 0))
    t, nrm, u, v, tri = f(tuple(jnp.asarray(c) for c in o),
                          tuple(jnp.asarray(c) for c in d),
                          jnp.asarray(t_bound, jnp.float32))
    return (np.asarray(t), tuple(np.asarray(c) for c in nrm), np.asarray(u),
            np.asarray(v), np.asarray(tri))


# ---------------------------------------------------------------- packer

@pytest.mark.parametrize("name", ["blob", "torus"])
def test_leaf_metas_cover_all_triangles_once(name, blob, torus_bundle):
    meshes = _bundle(name, blob, torus_bundle)
    packed = PB8.pack_mesh8(meshes, 0)
    ni = np.asarray(packed.nodes_i)
    encs = ni[:, 0:8]
    metas = -encs[encs <= -2] - 2  # leaf encodings are -(meta)-2
    n_tris = int(np.asarray(meshes.tri_v0).shape[0])
    # the packed table carries 8 zero pad rows past the real triangles
    assert np.asarray(packed.tris).shape[0] == n_tris + 8
    cover = np.zeros(n_tris, np.int32)
    for meta in metas:
        st, ct = meta // 32, meta % 32
        assert 0 < ct <= PB8.WIDE_LEAF_K
        cover[st:st + ct] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("name", ["blob", "torus"])
def test_interior_entries_reach_every_node_once(name, blob, torus_bundle):
    """Pre-encoded interior entries name every non-root row exactly once,
    empty slots (entry 0) carry NaN boxes, and the sort axis is 0-2."""
    packed = PB8.pack_mesh8(_bundle(name, blob, torus_bundle), 0)
    ni = np.asarray(packed.nodes_i)
    nf = np.asarray(packed.nodes_f)
    encs = ni[:, 0:8]
    interior = encs[encs > 0]
    assert sorted(interior.tolist()) == list(range(1, ni.shape[0]))
    boxes = nf[:, :48].reshape(-1, 8, 6)
    assert np.isnan(boxes[encs == 0]).all()
    assert np.isfinite(boxes[encs != 0]).all()
    assert set(np.unique(ni[:, 16]).tolist()) <= {0, 1, 2}


def test_wide_tree_is_smaller(blob, packed8):
    b2 = np.asarray(blob.meshes.node_lo).shape[0]
    b8 = np.asarray(packed8.nodes_f).shape[0]
    assert b8 < b2 / 4  # ~7x fewer interior nodes in an 8-ary tree


def test_parser_default_is_wide(blob):
    assert isinstance(blob.packed_meshes[0], PB8.PackedMesh8)


# ---------------------------------------------------------- plain walk

@pytest.mark.parametrize("name", ["blob", "torus"])
def test_walk_matches_brute_force(name, blob, torus_bundle):
    """Nearest hit: same triangle as exhaustive Moller-Trumbore (bar
    exact ties), t within float32 rounding."""
    meshes = _bundle(name, blob, torus_bundle)
    packed = PB8.pack_mesh8(meshes, 0)
    radius = 3.0 if name == "blob" else 4.0
    o, d = _aimed_rays(256, seed=1, radius=radius, spread=0.6)
    tb = np.full(256, 1e30, np.float32)
    t, _, _, _, tri = _walk(o, d, tb, meshes, packed)
    t_ref, tri_ref = _brute_force(o, d, meshes, tb)
    hit = tri_ref >= 0
    assert hit.sum() > 64
    np.testing.assert_array_equal(tri >= 0, hit)
    assert (tri[hit] == tri_ref[hit]).mean() > 0.99
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)


@pytest.mark.parametrize("name", ["blob", "torus"])
def test_walk_t_bound_and_dead_lanes(name, blob, torus_bundle):
    """Hits at or beyond the bound report a miss with t = bound; rays with
    t_bound <= 0 are dead and report a miss; bounded hits match the
    brute force under the same bound."""
    meshes = _bundle(name, blob, torus_bundle)
    packed = PB8.pack_mesh8(meshes, 0)
    o, d = _aimed_rays(192, seed=2, radius=4.0)
    free = np.full(192, 1e30, np.float32)
    t_free, _, _, _, tri_free = _walk(o, d, free, meshes, packed)
    hit = tri_free >= 0
    assert hit.sum() > 32
    bound = np.where(np.arange(192) % 3 == 0, t_free * 0.5,
                     np.where(hit, t_free * 1.5, 1e30)).astype(np.float32)
    bound[np.arange(192) % 7 == 0] = -1.0          # dead lanes
    t_b, _, _, _, tri_b = _walk(o, d, bound, meshes, packed)
    t_ref, tri_ref = _brute_force(o, d, meshes, bound)
    dead = bound <= 0
    assert (tri_b[dead] == -1).all()
    np.testing.assert_array_equal(t_b[dead], bound[dead])
    halved = (np.arange(192) % 3 == 0) & hit & ~dead
    assert (tri_b[halved] == -1).all()
    np.testing.assert_array_equal(tri_b >= 0, tri_ref >= 0)
    both = (tri_b >= 0)
    np.testing.assert_allclose(t_b[both], t_ref[both], rtol=1e-5)
    miss = ~both & ~dead
    np.testing.assert_array_equal(t_b[miss], bound[miss])


def test_walk_attributes_interpolate_winner(torus_bundle):
    """The walk's record carries the winner's smooth normal and uv, the
    same interpolation the CUDA kernel does in-register."""
    packed = PB8.pack_mesh8(torus_bundle, 0)
    o, d = _aimed_rays(256, seed=3, radius=4.0, spread=0.8)
    tb = np.full(256, 1e30, np.float32)
    t, (nx, ny, nz), u, v, tri = _walk(o, d, tb, torus_bundle, packed)
    hit = tri >= 0
    assert hit.sum() > 32
    rows = np.asarray(packed.tris)[tri[hit]]
    # barycentrics of the winner, recomputed in float64
    oo, dd = o[:, hit].T.astype(np.float64), d[:, hit].T.astype(np.float64)
    e1, e2 = rows[:, 3:6], rows[:, 6:9]
    p = np.cross(dd, e2)
    inv = 1.0 / np.einsum("ij,ij->i", e1, p)
    tv = oo - rows[:, 0:3]
    bu = np.einsum("ij,ij->i", tv, p) * inv
    bv = np.einsum("ij,ij->i", dd, np.cross(tv, e1)) * inv
    bw = 1 - bu - bv
    lerp = lambda a, b, c: bw * rows[:, a] + bu * rows[:, b] + bv * rows[:, c]
    np.testing.assert_allclose(nx[hit], lerp(9, 12, 15), atol=1e-4)
    np.testing.assert_allclose(ny[hit], lerp(10, 13, 16), atol=1e-4)
    np.testing.assert_allclose(nz[hit], lerp(11, 14, 17), atol=1e-4)
    np.testing.assert_allclose(u[hit], lerp(18, 20, 22), atol=1e-4)
    np.testing.assert_allclose(v[hit], lerp(19, 21, 23), atol=1e-4)
    assert (nx[~hit] == 0).all() and (u[~hit] == 0).all()


# ------------------------------------------------------- CUDA wrapper

@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_wrapper_call_contract(any_hit, packed8, monkeypatch):
    """traverse_cuda passes 7 f32 [N] ray planes and the three tables,
    unpadded for any N, to the mode's FFI target, and asks for six f32
    and one i32 [N] result."""
    seen = {}

    def fake_ffi_call(name, result_shapes, **kw):
        seen["name"], seen["results"] = name, result_shapes

        def call(*operands):
            seen["operands"] = operands
            return tuple(jnp.zeros(r.shape, r.dtype) for r in result_shapes)
        return call

    monkeypatch.setattr(jax.ffi, "ffi_call", fake_ffi_call)
    n = 1000   # not a multiple of the kernel's block: nothing is padded
    qo = tuple(jnp.zeros((n,), jnp.float16) for _ in range(3))
    qd = tuple(jnp.ones((n,), jnp.float32) for _ in range(3))
    t, nrm, u, v, tri = PB8.traverse_cuda(
        qo, qd, jnp.full((n,), 5.0), packed8, any_hit=any_hit)
    assert seen["name"] == ("pt_bvh8_any_hit" if any_hit
                            else "pt_bvh8_nearest")
    ops = seen["operands"]
    assert len(ops) == 10
    for a in ops[:7]:
        assert a.shape == (n,) and a.dtype == jnp.float32
    assert ops[7].shape == packed8.nodes_f.shape
    assert ops[7].dtype == jnp.float32
    assert ops[8].dtype == jnp.int32 and ops[8].shape[1] == 24
    assert ops[9].dtype == jnp.float32 and ops[9].shape[1] == PB8.TRI_ROW
    assert [r.dtype for r in seen["results"]] == [jnp.float32] * 6 + [
        jnp.int32]
    assert all(r.shape == (n,) for r in seen["results"])
    assert t.shape == u.shape == v.shape == tri.shape == (n,)
    assert len(nrm) == 3


def _traverse_fn(packed, meshes):
    def f(qo, qd, tb):
        return PB8.traverse(qo, qd, tb, packed, meshes, 0)
    return f


def test_platform_selection_lowers_kernel_only_for_cuda(blob, packed8):
    """The CPU program is the plain walk (no foreign call); the CUDA
    program is the kernel (and no walk loop)."""
    n = 256
    args = (tuple(jnp.zeros((n,)) for _ in range(3)),
            tuple(jnp.ones((n,)) for _ in range(3)), jnp.ones((n,)))
    f = jax.jit(_traverse_fn(packed8, blob.meshes))
    cpu = f.trace(*args).lower(lowering_platforms=("cpu",)).as_text()
    assert "pt_bvh8" not in cpu and "while" in cpu
    cuda = f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "pt_bvh8_nearest" in cuda and "stablehlo.while" not in cuda


def test_missing_library_on_gpu_raises(blob, packed8, monkeypatch,
                                       tmp_path):
    """On a GPU backend the library is required: no nvcc and no built
    library is an error, never a fallback to the walk."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(native, "CUDA_LIBRARY",
                        str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_nvcc", lambda: None)
    PB8.register_cuda_targets.cache_clear()
    try:
        n = 128
        with pytest.raises(RuntimeError, match="nvcc"):
            PB8.traverse(tuple(jnp.zeros((n,)) for _ in range(3)),
                         tuple(jnp.ones((n,)) for _ in range(3)),
                         jnp.ones((n,)), packed8, blob.meshes, 0)
    finally:
        PB8.register_cuda_targets.cache_clear()


def test_cuda_library_builds_once_with_nvcc(monkeypatch, tmp_path):
    """The build runs nvcc for sm_90a without fast math, and a library
    newer than its source is reused, not rebuilt."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$@\" >> %s\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n" % log)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "_nvcc", lambda: str(fake))
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    lib = tmp_path / "build" / "libk.so"
    assert native.cuda_library(str(src), str(lib)) == str(lib)
    assert lib.exists()
    native.cuda_library(str(src), str(lib))
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert "fast_math" not in calls[0]
    os.utime(lib, (0, 0))            # older than the source: rebuild
    native.cuda_library(str(src), str(lib))
    assert len(log.read_text().splitlines()) == 2


def test_cuda_library_reports_compile_errors(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "_nvcc", lambda: str(fake))
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    with pytest.raises(RuntimeError, match="bad kernel"):
        native.cuda_library(str(src), str(tmp_path / "libk.so"))


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
def test_cuda_kernel_matches_walk(gpu_device, blob, packed8):
    """The kernel against the plain walk on the same rays: same hit set,
    same winner bar grazing ties, t within float32 rounding; any-hit
    occlusion equals nearest-hit occlusion."""
    o, d = _aimed_rays(4096, seed=5, radius=3.0, spread=0.6)
    qo = tuple(jnp.asarray(c) for c in o)
    qd = tuple(jnp.asarray(c) for c in d)
    tb = jnp.full((4096,), 1e30, jnp.float32)
    PB8.register_cuda_targets()
    tk, _, _, _, trik = jax.jit(lambda a, b, c: PB8.traverse_cuda(
        a, b, c, packed8))(qo, qd, tb)
    _, _, _, _, tria = jax.jit(lambda a, b, c: PB8.traverse_cuda(
        a, b, c, packed8, any_hit=True))(qo, qd, tb)
    tw, _, _, _, triw = _walk(o, d, np.asarray(tb), blob.meshes, packed8)
    trik, tria = np.asarray(trik), np.asarray(tria)
    np.testing.assert_array_equal(trik >= 0, triw >= 0)
    np.testing.assert_array_equal(tria >= 0, trik >= 0)
    same = trik == triw
    assert same.mean() > 0.999
    hit = same & (trik >= 0)
    np.testing.assert_allclose(np.asarray(tk)[hit], tw[hit], rtol=1e-5)
