"""Planar wavefront kernels must match the row-based reference oracles
(ops/camera, ops/intersect, ops/bsdf keep the readable [N,3] implementations
precisely to serve as these oracles)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.ops import (
    camera as cam_ops, intersect as isect, bsdf, wavefront as wf, vec)


@pytest.fixture(scope="module")
def cornell():
    return load_scene("scenes/cornell.txt")


def rand_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 11, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_raygen_matches_rows(cornell):
    cam = cornell.camera
    cam.resolution = (16, 16)
    cam.derive()
    f = cam.flat()
    key = jax.random.PRNGKey(0)
    # AA off so both paths are deterministic and identical
    o_r, d_r, t_r = cam_ops.generate_rays(f, 16, 16, key, antialias=False)
    o_p, d_p, t_p, pix = wf.generate_rays_planar(f, 16, 16, key, antialias=False)
    np.testing.assert_allclose(np.asarray(vec.to_rows(o_p)), np.asarray(o_r),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(vec.to_rows(d_p)), np.asarray(d_r),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_r), atol=1e-7)


def test_raygen_dof_matches_rows(cornell):
    cam = cornell.camera
    cam.resolution = (8, 8)
    cam.aperture = 0.4
    cam.focal_distance = 9.0
    cam.derive()
    f = cam.flat()
    key = jax.random.PRNGKey(3)
    o_r, d_r, _ = cam_ops.generate_rays(f, 8, 8, key, antialias=False)
    o_p, d_p, _, _ = wf.generate_rays_planar(f, 8, 8, key, antialias=False)
    # same key, but rows sample (n,2) vs planar (2,n): distributions match,
    # exact values differ — compare deterministic parts via focus geometry
    cam.aperture = 0.0
    cam.focal_distance = 0.0
    f0 = cam.flat()
    o0, d0, _ = cam_ops.generate_rays(f0, 8, 8, key, antialias=False)
    focus = np.asarray(o0) + np.asarray(d0) * 9.0
    op, dp = np.asarray(vec.to_rows(o_p)), np.asarray(vec.to_rows(d_p))
    t = ((focus - op) * dp).sum(-1)
    closest = op + t[:, None] * dp
    np.testing.assert_allclose(closest, focus, atol=1e-4)


def test_intersect_matches_rows(cornell):
    o, d = rand_rays(512, seed=1)
    t = jnp.zeros((512,), jnp.float32)
    gt = tuple(int(x) for x in np.asarray(cornell.geoms.type))
    a = isect.intersect_scene(o, d, t, cornell.geoms, cornell.meshes, ())
    b = wf.intersect_planar(vec.from_rows(o), vec.from_rows(d), t,
                            cornell.geoms, cornell.meshes, gt)
    np.testing.assert_allclose(np.asarray(b.t), np.asarray(a.t), rtol=1e-4,
                               atol=1e-4)
    hit = np.asarray(a.t) > 0
    np.testing.assert_array_equal(np.asarray(b.mat_id)[hit],
                                  np.asarray(a.mat_id)[hit])
    np.testing.assert_allclose(
        np.asarray(vec.to_rows(b.normal))[hit],
        np.asarray(a.normal)[hit], atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(vec.to_rows(b.point))[hit],
        np.asarray(a.point)[hit], atol=1e-3)
    np.testing.assert_allclose(np.asarray(b.u)[hit],
                               np.asarray(a.uv)[hit, 0], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(b.outside)[hit],
                                  np.asarray(a.outside)[hit])


def test_shade_matches_rows(cornell):
    n = 512
    o, d = rand_rays(n, seed=2)
    t = jnp.zeros((n,), jnp.float32)
    gt = tuple(int(x) for x in np.asarray(cornell.geoms.type))
    hit_rows = isect.intersect_scene(o, d, t, cornell.geoms, cornell.meshes,
                                     ())
    hit_pl = wf.intersect_planar(vec.from_rows(o), vec.from_rows(d), t,
                                 cornell.geoms, cornell.meshes, gt)
    u_rows = jax.random.uniform(jax.random.PRNGKey(9), (n, 4))
    u_pl = u_rows.T

    thr = jnp.full((n, 3), 0.7, jnp.float32)
    alive = jnp.ones((n,), bool)
    last = jnp.zeros((n,), bool)

    out_r = bsdf.shade(hit_rows, d, thr, alive, cornell.materials,
                       cornell.textures, u_rows, last)
    out_p = wf.shade_planar(hit_pl, vec.from_rows(d),
                            vec.from_rows(thr), alive, cornell.materials,
                            cornell.textures, u_pl, last)

    np.testing.assert_allclose(np.asarray(vec.to_rows(out_p.radiance)),
                               np.asarray(out_r.radiance), atol=1e-5)
    np.testing.assert_allclose(np.asarray(vec.to_rows(out_p.throughput)),
                               np.asarray(out_r.throughput), atol=1e-5)
    # direction/origin are don't-care on dead lanes (missed rays): the two
    # implementations leave different garbage there; compare live hits only
    live = np.asarray(out_r.alive)
    np.testing.assert_allclose(np.asarray(vec.to_rows(out_p.direction))[live],
                               np.asarray(out_r.direction)[live], atol=1e-4)
    np.testing.assert_allclose(np.asarray(vec.to_rows(out_p.origin))[live],
                               np.asarray(out_r.origin)[live], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_p.alive),
                                  np.asarray(out_r.alive))


def test_cosine_hemisphere_planar_matches_rows():
    n = 4096
    key = jax.random.PRNGKey(1)
    nv = jax.random.normal(key, (n, 3))
    nv = nv / jnp.linalg.norm(nv, axis=-1, keepdims=True)
    u = jax.random.uniform(jax.random.PRNGKey(2), (2, n))
    d_rows = bsdf.cosine_hemisphere(nv, u[0], u[1])
    d_pl = wf.cosine_hemisphere_planar(vec.from_rows(nv), u[0], u[1])
    np.testing.assert_allclose(np.asarray(vec.to_rows(d_pl)),
                               np.asarray(d_rows), atol=1e-5)


def test_tile_swizzle_is_a_permutation():
    from project3_cuda_path_tracer_tpu.scene.types import Camera
    import numpy as np
    cam = Camera(resolution=(64, 64), position=np.array([0, 5, 10.5]),
                 look_at=np.array([0, 5, 0]), up=np.array([0, 1, 0]))
    cam.derive()
    _, _, _, pix = wf.generate_rays_planar(cam.flat(), 64, 64,
                                           jax.random.PRNGKey(0),
                                           antialias=False, tile=16)
    p = np.sort(np.asarray(pix))
    np.testing.assert_array_equal(p, np.arange(64 * 64))
    # path 0..255 should cover exactly the first 16x16 tile
    first = np.asarray(pix)[:256]
    xs, ys = first % 64, first // 64
    assert xs.max() < 16 and ys.max() < 16


def test_tiled_render_matches_untiled():
    """depth-1 render is RNG-free per pixel -> tiled == untiled exactly."""
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render import integrator as I
    import dataclasses
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    gt = tuple(int(x) for x in np.asarray(s.geoms.type))
    base = I.TraceConfig(width=32, height=32, trace_depth=1,
                         antialias=False, geom_types=gt)
    tiled = dataclasses.replace(base, tile=8)
    key = jax.random.PRNGKey(0)
    img_a = I.render_radiance(s.materials, s.camera.flat(), s.geoms,
                              s.meshes, s.textures, key, base)
    img_b = I.render_radiance(s.materials, s.camera.flat(), s.geoms,
                              s.meshes, s.textures, key, tiled)
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_b),
                               atol=1e-6)


def test_texture_env_planar_match_rows():
    """Planar texture/env samplers must match the row-based oracles."""
    from project3_cuda_path_tracer_tpu import load_scene
    s = load_scene("scenes/textured_env.txt")
    n = 1024
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.uniform(-1, 2, n).astype(np.float32))
    v = jnp.asarray(rng.uniform(-1, 2, n).astype(np.float32))
    mat_id = jnp.asarray(rng.integers(0, 4, n).astype(np.int32))
    base = jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32))

    rows = bsdf.sample_texture(s.textures, mat_id,
                               jnp.stack([u, v], -1), base)
    planar = wf._sample_texture_planar(s.textures, mat_id, u, v,
                                       vec.from_rows(base))
    np.testing.assert_allclose(np.asarray(vec.to_rows(planar)),
                               np.asarray(rows), atol=1e-6)

    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    env_rows = bsdf.sample_env(s.textures, jnp.asarray(d))
    env_pl = wf._sample_env_planar(s.textures, vec.from_rows(jnp.asarray(d)))
    np.testing.assert_allclose(np.asarray(vec.to_rows(env_pl)),
                               np.asarray(env_rows), atol=1e-5)


def test_packed_texture_planes_attached_and_bitwise():
    """The u32 single-gather texel planes (utils/image.pack_rgb8/pack_rgbe)
    must attach for the PNG atlas + HDR envmap assets and reproduce the
    three-take f32 fetch BITWISE."""
    import dataclasses
    from project3_cuda_path_tracer_tpu import load_scene
    s = load_scene("scenes/textured_env.txt")
    tex = s.textures
    ha, wa = tex.atlas.shape[0], tex.atlas.shape[1]
    he, we = tex.env.shape[0], tex.env.shape[1]
    assert tex.atlas_packed.shape[0] == ha * wa, "atlas pack fell back"
    assert tex.env_packed.shape[0] == he * we, "env pack fell back"

    bare = dataclasses.replace(
        tex, atlas_packed=jnp.zeros((1,), jnp.uint32),
        env_packed=jnp.zeros((1,), jnp.uint32))

    n = 2048
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.uniform(-1, 2, n).astype(np.float32))
    v = jnp.asarray(rng.uniform(-1, 2, n).astype(np.float32))
    mat_id = jnp.asarray(rng.integers(0, tex.rect.shape[0], n)
                         .astype(np.int32))
    base = vec.from_rows(jnp.asarray(
        rng.uniform(0, 1, (n, 3)).astype(np.float32)))
    packed = wf._sample_texture_planar(tex, mat_id, u, v, base)
    plain = wf._sample_texture_planar(bare, mat_id, u, v, base)
    for a, b in zip(packed, plain):
        assert (np.asarray(a) == np.asarray(b)).all()

    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dd = vec.from_rows(jnp.asarray(d))
    env_packed = wf._sample_env_planar(tex, dd)
    env_plain = wf._sample_env_planar(bare, dd)
    for a, b in zip(env_packed, env_plain):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_fused_texture_env_fetch_bitwise():
    """The fused single-take texture+env fetch (hit lanes read the atlas,
    missed lanes the env map, one take on the concatenated u32 tables —
    ops/wavefront.shade_planar) must render BITWISE identically to the
    two-take path on the real textured_env scene."""
    import dataclasses
    import jax
    from project3_cuda_path_tracer_tpu import load_scene
    from project3_cuda_path_tracer_tpu.render import integrator as I

    s = load_scene("scenes/textured_env.txt")
    gt = tuple(int(t) for t in np.asarray(s.geoms.type))
    mids = tuple(int(m) for m in np.asarray(s.geoms.mesh_id))
    cfg = I.TraceConfig(width=32, height=32, trace_depth=3, antialias=True,
                        geom_types=gt, mesh_ids=mids, unroll=True,
                        glossy=True, sky=False)
    key = jax.random.PRNGKey(7)
    fused = I.render_radiance(s.materials, s.camera.flat(), s.geoms,
                              s.meshes, s.textures, key, cfg,
                              packed_meshes=s.packed_meshes)
    bare_tex = dataclasses.replace(
        s.textures, atlas_packed=jnp.zeros((1,), jnp.uint32),
        env_packed=jnp.zeros((1,), jnp.uint32))
    plain = I.render_radiance(s.materials, s.camera.flat(), s.geoms,
                              s.meshes, bare_tex, key, cfg,
                              packed_meshes=s.packed_meshes)
    assert (np.asarray(fused) == np.asarray(plain)).all()
