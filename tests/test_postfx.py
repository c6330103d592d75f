"""Radiance clamp (--clamp) and save-time display transforms
(--gamma/--aces)."""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import integrator as I
from project3_cuda_path_tracer_tpu.scene import types as T
from project3_cuda_path_tracer_tpu.utils import image as img_io


def test_clamp_caps_per_sample_radiance():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    st = T.RenderSettings(**{**s.settings.__dict__, "clamp": 0.5,
                             "antialias": False, "trace_depth": 3})
    r = I.Renderer(s, settings=st)
    r.render(4)
    img = r.image()
    # the light pixel reads emittance 5 unclamped; every sample is capped
    assert img.max() <= 0.5 + 1e-6
    assert img.max() > 0.4   # the cap is actually reached


def test_clamp_zero_is_identity():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    base = I.Renderer(s)
    base.render(2)
    st = T.RenderSettings(**{**s.settings.__dict__, "clamp": 0.0})
    off = I.Renderer(s, settings=st)
    off.render(2)
    assert (np.asarray(base.accum) == np.asarray(off.accum)).all()


def test_gamma_and_aces_png(tmp_path):
    accum = np.zeros((4, 4, 3), np.float32)
    accum[1, 1] = (0.25, 0.25, 0.25)   # one iteration's sums
    lin = img_io.save_render(str(tmp_path / "lin"), accum, 1)
    gam = img_io.save_render(str(tmp_path / "gam"), accum, 1, gamma=2.2)
    ace = img_io.save_render(str(tmp_path / "ace"), accum, 1, aces=True)
    a = img_io.read_png(lin)[1, 2]     # x-mirrored
    b = img_io.read_png(gam)[1, 2]
    c = img_io.read_png(ace)[1, 2]
    assert a[0] == pytest.approx(0.25, abs=0.01)
    assert b[0] == pytest.approx(0.25 ** (1 / 2.2), abs=0.01)
    assert c[0] == pytest.approx(img_io.aces_tonemap(
        np.array([[[0.25]]]))[0, 0, 0], abs=0.01)
    # hdr stays linear regardless
    h = img_io.save_render(str(tmp_path / "h"), accum, 1, hdr=True,
                           gamma=2.2, aces=True)
    hv = img_io.read_hdr(h)[1, 2]
    assert hv[0] == pytest.approx(0.25, rel=0.02)


def test_cli_flags_parse():
    from project3_cuda_path_tracer_tpu.app.cli import build_parser
    a = build_parser().parse_args(["x.txt", "--clamp", "2.5",
                                   "--gamma", "2.2", "--aces"])
    assert a.clamp == 2.5 and a.gamma == 2.2 and a.aces
