"""RIS direct lighting (--nee-ris): unbiasedness vs plain NEE and
variance reduction on a multi-light scene."""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import integrator as I
from project3_cuda_path_tracer_tpu.scene import types as T


@pytest.fixture(scope="module")
def lights_small():
    s = load_scene("scenes/lights.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    s.settings.trace_depth = 4
    return s


def render(scene, spp, **kw):
    st = T.RenderSettings(**{**scene.settings.__dict__, **kw})
    r = I.Renderer(scene, settings=st)
    r.render(spp)
    return r.image()


def test_ris_cfg_gate(lights_small):
    st = T.RenderSettings(**{**lights_small.settings.__dict__,
                             "nee": True, "nee_ris": 8})
    r = I.Renderer(lights_small, settings=st)
    assert r.cfg.nee_ris == 8 and r.cfg.nee


def test_ris_matches_nee_in_expectation(lights_small):
    """RIS re-weights which light sample gets the shadow ray; the
    estimator mean must match plain NEE (independent seeds)."""
    plain = render(lights_small, 64, nee=True, seed=3)
    ris = render(lights_small, 64, nee=True, nee_ris=8, seed=9)
    assert abs(float(plain.mean()) - float(ris.mean())) < 0.015
    # per-pixel agreement within MC noise
    assert float(np.abs(plain - ris).mean()) < 0.06


@pytest.mark.slow
def test_ris_cuts_direct_light_variance(lights_small):
    """On the two-light scene RIS at M=8 must reduce RMSE vs plain NEE
    at equal spp (both against a high-spp ground truth)."""
    gt = render(lights_small, 512, nee=True, seed=1)

    def rmse(img):
        return float(np.sqrt(((img - gt) ** 2).mean()))

    e_plain = np.mean([rmse(render(lights_small, 12, nee=True, seed=s))
                       for s in (5, 7)])
    e_ris = np.mean([rmse(render(lights_small, 12, nee=True, nee_ris=8,
                                 seed=s)) for s in (5, 7)])
    assert e_ris < e_plain


def test_ris_pure_glossy_not_starved(tmp_path):
    """A REFL=1 glossy material has zero diffuse target; the glossy floor
    in the RIS target must keep its direct light alive (vs plain NEE)."""
    f = tmp_path / "glossy.txt"
    f.write_text("""MATERIAL 0
RGB 1 1 1
EMITTANCE 4

MATERIAL 1
RGB 0 0 0
SPECEX 32
SPECRGB .9 .9 .9
REFL 1

CAMERA
RES 24 24
FOVY 45
ITERATIONS 8
DEPTH 3
FILE g
EYE 0 2 6
LOOKAT 0 2 0
UP 0 1 0

OBJECT 0
cube
material 0
TRANS 0 6 0
ROTAT 0 0 0
SCALE 2 .2 2

OBJECT 1
cube
material 1
TRANS 0 0 0
ROTAT 0 0 0
SCALE 8 .1 8
""")
    s = load_scene(str(f))
    plain = render(s, 96, nee=True, seed=3)
    ris = render(s, 96, nee=True, nee_ris=4, seed=9)
    # glossy floor keeps energy: means agree within MC noise
    assert abs(float(plain.mean()) - float(ris.mean())) \
        < 0.1 * max(float(plain.mean()), 1e-6) + 0.01


@pytest.fixture(scope="module")
def mixed_scene(tmp_path_factory):
    """Area light AND an HDR env map — the case where --nee-ris now draws
    its M candidates from the same area/env one-sample mixture the plain
    mixed branch uses (round-4; previously RIS was silently area-only and
    the mixed branch won the dispatch)."""
    import numpy as np
    from project3_cuda_path_tracer_tpu.utils import image as img_io
    d = tmp_path_factory.mktemp("mixed_ris")
    env = np.full((16, 32, 3), 0.05, np.float32)
    env[3:6, 8:12] = [20.0, 15.0, 5.0]
    img_io.write_hdr(str(d / "env.hdr"), env)
    (d / "s.txt").write_text(f"""ENVMAP {d}/env.hdr

MATERIAL 0
RGB .7 .7 .7

MATERIAL 1
RGB 1 0.9 0.8
EMITTANCE 12

CAMERA
RES 48 48
FOVY 45
ITERATIONS 8
DEPTH 4
FILE m
EYE 0 1.5 6
LOOKAT 0 1 0
UP 0 1 0

OBJECT 0
sphere
material 0
TRANS 0 1 0
ROTAT 0 0 0
SCALE 2 2 2

OBJECT 1
cube
material 0
TRANS 0 -1.05 0
ROTAT 0 0 0
SCALE 16 .1 16

OBJECT 2
cube
material 1
TRANS 2.5 3.5 1
ROTAT 0 0 30
SCALE 1 .1 1
""")
    return load_scene(str(d / "s.txt"))


def test_mixed_ris_wiring(mixed_scene):
    """nee_ris >= 2 on an area+env scene must keep BOTH strategies armed
    (mixed mode) and take the RIS branch (the dispatch no longer ignores
    the flag when the scene is mixed)."""
    st = T.RenderSettings(**{**mixed_scene.settings.__dict__,
                             "nee": True, "nee_ris": 4})
    r = I.Renderer(mixed_scene, settings=st)
    assert r.cfg.nee_ris == 4 and r.cfg.nee
    assert r.cfg.nee_lights and r.cfg.nee_env and 0.1 <= r.cfg.nee_q <= 0.9


@pytest.mark.slow
def test_mixed_ris_matches_mixed_nee_in_expectation(mixed_scene):
    """Mixed-candidate RIS re-weights which mixture sample gets the
    shadow ray; the estimator mean must match the plain one-sample
    mixture (independent seeds). Measured at commit time: absdiff 7e-4 at
    192 spp; low-spp RMSE 1.21-1.25x better."""
    plain = render(mixed_scene, 96, nee=True, seed=3)
    ris = render(mixed_scene, 96, nee=True, nee_ris=4, seed=9)
    assert abs(float(plain.mean()) - float(ris.mean())) < 0.02
    assert float(np.abs(plain - ris).mean()) < 0.08


@pytest.mark.slow
def test_mixed_ris_cuts_variance(mixed_scene):
    """At equal spp the M=4 mixture-candidate RIS must beat the plain
    one-sample mixture on the area+env scene."""
    gt = render(mixed_scene, 384, nee=True, seed=1)

    def rmse(img):
        return float(np.sqrt(((img - gt) ** 2).mean()))

    e_plain = np.mean([rmse(render(mixed_scene, 8, nee=True, seed=s))
                       for s in (5, 7)])
    e_ris = np.mean([rmse(render(mixed_scene, 8, nee=True, nee_ris=4,
                                 seed=s)) for s in (5, 7)])
    assert e_ris < e_plain, (e_ris, e_plain)
