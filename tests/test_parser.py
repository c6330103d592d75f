"""Scene-parser tests: the grammar must be verbatim-compatible with the
reference format (reference: src/scene.cpp; SURVEY §5.6 requires
scenes/cornell.txt to load unchanged)."""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.scene import types as T
from project3_cuda_path_tracer_tpu.scene.parser import SceneParseError

REF_CORNELL = "scenes/cornell.txt"
REPO_CORNELL = "scenes/cornell.txt"


@pytest.fixture(scope="module")
def cornell():
    return load_scene(REF_CORNELL)


def test_reference_cornell_loads_verbatim(cornell):
    assert cornell.num_materials == 5
    assert cornell.num_geoms == 7


def test_materials(cornell):
    m = cornell.materials
    np.testing.assert_allclose(m.emittance, [5, 0, 0, 0, 0])
    np.testing.assert_allclose(m.color[2], [0.85, 0.35, 0.35], rtol=1e-6)
    np.testing.assert_allclose(m.has_reflective, [0, 0, 0, 0, 1])
    np.testing.assert_allclose(m.specular_color[4], [0.98, 0.98, 0.98],
                               rtol=1e-6)


def test_geoms(cornell):
    g = cornell.geoms
    assert list(np.asarray(g.type)) == [T.CUBE] * 6 + [T.SPHERE]
    assert list(np.asarray(g.material_id)) == [0, 1, 1, 1, 2, 3, 4]
    # light transform: TRANS (0,10,0), SCALE (3,.3,3)
    t0 = np.asarray(g.transform[0])
    np.testing.assert_allclose(t0[:3, 3], [0, 10, 0], atol=1e-6)
    np.testing.assert_allclose(np.diag(t0)[:3], [3, 0.3, 3], rtol=1e-6)
    # inverse is a real inverse
    np.testing.assert_allclose(
        t0 @ np.asarray(g.inverse_transform[0]), np.eye(4), atol=1e-5)


def test_camera_derivation(cornell):
    """Derived quantities per Scene::loadCamera (src/scene.cpp:132-142)."""
    c = cornell.camera
    assert c.resolution == (800, 800)
    yscaled = np.tan(45.0 * np.pi / 180.0)
    np.testing.assert_allclose(c.pixel_length, [2 * yscaled / 800] * 2,
                               rtol=1e-5)
    np.testing.assert_allclose(c.view, [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(c.right, [1, 0, 0], atol=1e-6)
    assert cornell.settings.iterations == 5000
    assert cornell.settings.trace_depth == 8
    assert cornell.settings.image_name == "cornell"


def test_repo_scene_matches_reference_scene():
    a, b = load_scene(REF_CORNELL), load_scene(REPO_CORNELL)
    np.testing.assert_allclose(a.materials.color, b.materials.color)
    np.testing.assert_allclose(a.geoms.transform, b.geoms.transform)
    assert a.camera.resolution == b.camera.resolution


def test_sphere_scene():
    s = load_scene("scenes/sphere.txt")
    assert s.num_geoms == 1
    assert int(s.geoms.type[0]) == T.SPHERE
    assert float(s.materials.emittance[0]) == 5.0


def test_nonsequential_ids_rejected(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("MATERIAL 1\nRGB 1 1 1\n")
    with pytest.raises(SceneParseError):
        load_scene(str(bad))


def test_extension_keywords(tmp_path):
    f = tmp_path / "ext.txt"
    f.write_text("""MATERIAL 0
RGB 1 1 1
EMITTANCE 2

CAMERA
RES 16 16
FOVY 45
ITERATIONS 10
DEPTH 4
FILE out
EYE 0 0 5
LOOKAT 0 0 0
UP 0 1 0
APERTURE 0.3
FOCAL 5.0
SHUTTER 0.5

OBJECT 0
sphere
material 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 1 1 1
VELOC 1 0 0
""")
    s = load_scene(str(f))
    assert s.camera.aperture == pytest.approx(0.3)
    assert s.camera.focal_distance == pytest.approx(5.0)
    assert s.camera.shutter == pytest.approx(0.5)
    np.testing.assert_allclose(s.geoms.velocity[0], [1, 0, 0])


def test_procedural_checker_and_sky(tmp_path):
    f = tmp_path / "proc.txt"
    f.write_text("""ENVSKY 0.3 0.5 1.0 1.5 1.4 1.1 -0.6 0.45 -0.5 30 28 24 700

MATERIAL 0
RGB 0.9 0.3 0.1
CHECKER 16 0.1 0.5 0.8

CAMERA
RES 16 16
FOVY 45
ITERATIONS 4
DEPTH 3
FILE proc
EYE 0 2 6
LOOKAT 0 0 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 -0.1 0
ROTAT 0 0 0
SCALE 10 0.2 10
""")
    s = load_scene(str(f))
    assert float(s.textures.checker_scale[0]) == 16.0
    np.testing.assert_allclose(np.asarray(s.textures.checker_color2[0]),
                               [0.1, 0.5, 0.8], atol=1e-6)
    assert float(s.textures.sky[0]) == 1.0
    assert float(s.textures.sky[13]) == 700.0
    # renders with nonzero sky illumination
    from project3_cuda_path_tracer_tpu.render.integrator import Renderer
    r = Renderer(s)
    r.render(4)
    img = r.image()
    assert img.mean() > 0.05
    assert np.isfinite(img).all()
