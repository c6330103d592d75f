"""Multi-mesh scenes: the per-mesh packing and the traversal's rebasing
(local node/tri indices) must agree with the row-form oracle over the
concatenated bundle (ops/intersect.intersect_scene)."""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render.integrator import Renderer


@pytest.fixture(scope="module")
def two_mesh_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm")
    scene = d / "two.txt"
    import os
    meshes = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "meshes")
    if not os.path.exists(os.path.join(meshes, "torus.obj")):
        pytest.skip("generated meshes absent")
    # second, distinct OBJ so the bundle really holds two meshes
    cube_obj = d / "cube.obj"
    cube_obj.write_text("""v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 3 2
f 1 4 3
f 5 6 7
f 5 7 8
f 1 2 6
f 1 6 5
f 2 3 7
f 2 7 6
f 3 4 8
f 3 8 7
f 4 1 5
f 4 5 8
""")
    scene.write_text(f"""MATERIAL 0
RGB 1 1 1
EMITTANCE 4

MATERIAL 1
RGB .8 .4 .3

MATERIAL 2
RGB .3 .5 .8

CAMERA
RES 32 32
FOVY 45
ITERATIONS 8
DEPTH 3
FILE two
EYE 0 2 8
LOOKAT 0 1 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 6 0
ROTAT 0 0 0
SCALE 4 .3 4

OBJECT 1
mesh {meshes}/torus.obj
material 1
TRANS -1.5 1 0
ROTAT 20 0 0
SCALE 1 1 1

OBJECT 2
mesh {cube_obj}
material 2
TRANS 1.5 1 0
ROTAT 0 30 0
SCALE 0.8 0.8 0.8
""")
    return str(scene)


def test_two_meshes_packet_equals_xla(two_mesh_scene):
    """Planar intersection through the packed per-mesh tables equals the
    row-form oracle on the concatenated bundle: same hits, distances,
    normals and uv, for rays aimed at both meshes."""
    import jax
    import jax.numpy as jnp
    from project3_cuda_path_tracer_tpu.ops import intersect as isect
    from project3_cuda_path_tracer_tpu.ops import vec
    from project3_cuda_path_tracer_tpu.ops import wavefront as wf
    s = load_scene(two_mesh_scene)
    assert len(s.packed_meshes) == 2  # two DISTINCT meshes in the bundle
    gt = tuple(int(t) for t in np.asarray(s.geoms.type))
    mids = tuple(int(m) for m in np.asarray(s.geoms.mesh_id))
    rng = np.random.default_rng(0)
    n = 512
    o = np.tile(np.array([[0.0, 2.0, 8.0]], np.float32), (n, 1))
    tgt = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(0.0, 2.0, n),
                    rng.uniform(-1.0, 1.0, n)], 1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    times = jnp.zeros((n,), jnp.float32)
    hp = jax.jit(lambda o, d: wf.intersect_planar(
        vec.from_rows(o), vec.from_rows(d), times, s.geoms, s.meshes, gt,
        s.packed_meshes, mids))(jnp.asarray(o), jnp.asarray(d))
    hr = jax.jit(lambda o, d: isect.intersect_scene_fused(
        o, d, times, s.geoms, s.meshes, gt))(jnp.asarray(o), jnp.asarray(d))
    t_p, t_r = np.asarray(hp.t), np.asarray(hr.t)
    np.testing.assert_array_equal(t_p > 0, t_r > 0)
    hit = t_r > 0
    mats = np.asarray(hr.mat_id)[hit]
    assert {1, 2} <= set(mats.tolist())   # both meshes were hit
    np.testing.assert_array_equal(np.asarray(hp.mat_id)[hit], mats)
    np.testing.assert_allclose(t_p[hit], t_r[hit], rtol=1e-4)
    n_p = np.stack([np.asarray(c) for c in hp.normal], 1)[hit]
    np.testing.assert_allclose(n_p, np.asarray(hr.normal)[hit], atol=1e-4)
    uv_p = np.stack([np.asarray(hp.u), np.asarray(hp.v)], 1)[hit]
    np.testing.assert_allclose(uv_p, np.asarray(hr.uv)[hit], atol=1e-4)
    # and the scene renders through the Renderer
    r = Renderer(s)
    r.render(3, seed=2)
    assert r.image().mean() > 0.01
