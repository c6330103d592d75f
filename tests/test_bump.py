"""Bump / normal mapping (the INSTRUCTION.md texture item's second half:
"Texture mapping AND Bump mapping"): parser keys, uv tangents from the
intersect stage, the procedural bump path, and file-loaded normal maps
(including the flat-map identity and the mesh per-triangle tangent)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.ops import wavefront as wf
from project3_cuda_path_tracer_tpu.ops import vec
from project3_cuda_path_tracer_tpu.ops.vec import V3
from project3_cuda_path_tracer_tpu.render import integrator as I
from project3_cuda_path_tracer_tpu.scene import types as T
from project3_cuda_path_tracer_tpu.utils import image as img_io


def _scene_text(extra_mat="", envline=""):
    return f"""{envline}

MATERIAL 0
RGB .8 .7 .6
{extra_mat}

MATERIAL 1
RGB 1 1 1
EMITTANCE 8

CAMERA
RES 48 48
FOVY 45
ITERATIONS 8
DEPTH 4
FILE b
EYE 0 0 6
LOOKAT 0 0 0
UP 0 1 0

OBJECT 0
sphere
material 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 3 3 3

OBJECT 1
cube
material 1
TRANS 0 4.5 3
ROTAT 0 0 0
SCALE 3 .1 3
"""


def _render(scene, iters=32, seed=3):
    r = I.Renderer(scene)
    r.step_many(iters)
    return np.asarray(r.accum) / r.iteration


def test_parser_bump_and_normalmap_keys(tmp_path):
    nm = np.zeros((4, 4, 3), np.uint8)
    nm[..., 2] = 255
    nm[..., 0] = 128
    nm[..., 1] = 128
    img_io.write_png(str(tmp_path / "nm.png"), nm)
    (tmp_path / "s.txt").write_text(
        _scene_text(extra_mat="BUMP 0.5 7\nNORMALMAP nm.png"))
    s = load_scene(str(tmp_path / "s.txt"))
    bump = np.asarray(s.textures.bump)
    assert bump[0, 0] == pytest.approx(0.5)
    assert bump[0, 1] == pytest.approx(7.0)
    assert int(np.asarray(s.textures.nrm_id)[0]) == 0
    assert int(np.asarray(s.textures.nrm_id)[1]) == -1
    w, h = np.asarray(s.textures.nrm_rect)[0, 2:4]
    assert (w, h) == (4, 4)
    # reference scenes must parse unchanged (no bump)
    ref = load_scene("scenes/cornell.txt")
    assert not np.any(np.asarray(ref.textures.bump))


def _axis_rays(n=8):
    z = jnp.zeros((n,), jnp.float32)
    o = V3(jnp.linspace(-0.3, 0.3, n), z + 0.11, z + 5.0)
    d = V3(z, z, z - 1.0)
    return o, d, z


def _make_geoms(gtype, scale=(2, 2, 2)):
    from project3_cuda_path_tracer_tpu.utils import math as m
    tr = m.build_transformation_matrix((0, 0, 0), (0, 0, 0), scale)[None]
    return T.Geoms(
        type=jnp.array([gtype], jnp.int32),
        material_id=jnp.zeros((1,), jnp.int32),
        transform=jnp.asarray(tr),
        inverse_transform=jnp.asarray(np.stack([m.inverse(tr[0])])),
        inverse_transpose=jnp.asarray(
            np.stack([m.inverse_transpose(tr[0])])),
        velocity=jnp.zeros((1, 3), jnp.float32),
        mesh_id=-jnp.ones((1,), jnp.int32),
    )


def test_tangents_cube_sphere():
    """intersect_planar(tangents=True) returns a world dP/du that is
    tangent to the surface and matches the analytic direction."""
    for shape in ("cube", "sphere"):
        g = _make_geoms(T.CUBE if shape == "cube" else T.SPHERE)
        o, d, times = _axis_rays()
        hit = wf.intersect_planar(o, d, times, g, T.MeshBundle.empty(),
                                  (int(np.asarray(g.type)[0]),),
                                  tangents=True)
        assert hit.tan is not None
        t = np.stack([np.asarray(hit.tan.x), np.asarray(hit.tan.y),
                      np.asarray(hit.tan.z)], -1)
        nrm = np.stack([np.asarray(hit.normal.x), np.asarray(hit.normal.y),
                        np.asarray(hit.normal.z)], -1)
        assert np.all(np.asarray(hit.t) > 0)
        tlen = np.linalg.norm(t, axis=-1)
        assert np.all(tlen > 1e-3)
        cosang = np.abs((t * nrm).sum(-1)) / tlen
        np.testing.assert_allclose(cosang, 0.0, atol=1e-4)
        if shape == "cube":
            # front (+z) face: u = x + 0.5, so dP/du ~ +x
            np.testing.assert_allclose(t / tlen[:, None],
                                       np.array([[1.0, 0, 0]] * 8),
                                       atol=1e-5)


def test_procedural_bump_changes_shading(tmp_path):
    (tmp_path / "plain.txt").write_text(_scene_text())
    (tmp_path / "bump.txt").write_text(_scene_text(extra_mat="BUMP 0.8 9"))
    a_plain = _render(load_scene(str(tmp_path / "plain.txt")))
    a_bump = _render(load_scene(str(tmp_path / "bump.txt")))
    diff = np.abs(a_plain - a_bump).mean()
    assert diff > 1e-3, "bump had no visible effect"
    # energy sanity: bump redistributes light, it must not create much
    assert abs(a_bump.mean() - a_plain.mean()) < 0.25 * a_plain.mean()


def test_flat_normal_map_is_identity(tmp_path):
    """A constant (128,128,255) normal map is (to 8-bit quantization)
    the identity perturbation: the render must match the unmapped one."""
    nm = np.zeros((8, 8, 3), np.uint8)
    nm[..., 0] = 128
    nm[..., 1] = 128
    nm[..., 2] = 255
    img_io.write_png(str(tmp_path / "flat.png"), nm)
    (tmp_path / "plain.txt").write_text(_scene_text())
    (tmp_path / "nm.txt").write_text(
        _scene_text(extra_mat="NORMALMAP flat.png"))
    a_plain = _render(load_scene(str(tmp_path / "plain.txt")))
    a_nm = _render(load_scene(str(tmp_path / "nm.txt")))
    # (128/255*2-1 ~ 0.004 tilt; diffuse render differs only marginally)
    assert np.abs(a_plain - a_nm).mean() < 0.015


def test_normal_map_changes_shading(tmp_path):
    """A strong checkered normal map visibly changes the sphere."""
    nm = np.zeros((8, 8, 3), np.uint8)
    nm[..., 2] = 200
    nm[::2, :, 0] = 230   # alternate rows tilt toward +u
    nm[1::2, :, 0] = 25
    nm[..., 1] = 128
    img_io.write_png(str(tmp_path / "ck.png"), nm)
    (tmp_path / "plain.txt").write_text(_scene_text())
    (tmp_path / "nm.txt").write_text(
        _scene_text(extra_mat="NORMALMAP ck.png"))
    a_plain = _render(load_scene(str(tmp_path / "plain.txt")))
    a_nm = _render(load_scene(str(tmp_path / "nm.txt")))
    assert np.abs(a_plain - a_nm).mean() > 1e-3


def test_mesh_uv_tangent(tmp_path):
    """Per-triangle uv tangent through the packet-traversal path: a quad
    in the xy plane with u along +x must return tan ~ +x."""
    (tmp_path / "q.obj").write_text("""
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/4/1
""")
    (tmp_path / "s.txt").write_text(f"""MATERIAL 0
RGB .8 .8 .8

CAMERA
RES 32 32
FOVY 45
ITERATIONS 4
DEPTH 2
FILE q
EYE 0 0 4
LOOKAT 0 0 0
UP 0 1 0

OBJECT 0
mesh q.obj
material 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 1 1 1
""")
    s = load_scene(str(tmp_path / "s.txt"))
    n = 128 * 8   # one packet
    z = jnp.zeros((n,), jnp.float32)
    o = V3(jnp.linspace(-0.8, 0.8, n), z + 0.1, z + 3.0)
    d = V3(z, z, z - 1.0)
    hit = wf.intersect_planar(o, d, z, s.geoms, s.meshes,
                              tuple(int(t) for t in np.asarray(s.geoms.type)),
                              packed_meshes=s.packed_meshes,
                              mesh_ids=tuple(
                                  int(m) for m in np.asarray(s.geoms.mesh_id)),
                              tangents=True)
    assert np.all(np.asarray(hit.t) > 0)
    t = np.stack([np.asarray(hit.tan.x), np.asarray(hit.tan.y),
                  np.asarray(hit.tan.z)], -1)
    tlen = np.linalg.norm(t, axis=-1)
    assert np.all(tlen > 1e-3)
    np.testing.assert_allclose(t / tlen[:, None],
                               np.array([[1.0, 0, 0]] * n), atol=1e-4)
