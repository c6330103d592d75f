"""HTTP preview server tests (the headless GL-preview replacement,
reference: src/preview.cpp)."""
import json
import urllib.request

import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render.integrator import Renderer
from project3_cuda_path_tracer_tpu.app.preview import PreviewServer


@pytest.fixture(scope="module")
def server():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    s.settings.trace_depth = 2
    r = Renderer(s)
    r.render(2)
    srv = PreviewServer(r, port=0).start()
    yield srv, r
    srv.stop()


def _get(srv, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}{path}", timeout=10)


def test_index(server):
    srv, _ = server
    body = _get(srv, "/").read()
    assert b"path tracer" in body


def test_state(server):
    srv, r = server
    st = json.loads(_get(srv, "/state").read())
    assert st["iteration"] == r.iteration
    assert st["width"] == 16


def test_frame_png(server):
    srv, _ = server
    data = _get(srv, "/frame.png").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_orbit_resets_accumulation(server):
    srv, r = server
    assert r.iteration > 0
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/orbit?dphi=0.2&dtheta=0&dzoom=0",
        method="POST")
    resp = urllib.request.urlopen(req, timeout=10)
    assert json.loads(resp.read())["ok"]
    # camera change resets accumulation (reference: src/main.cpp:102-120)
    assert r.iteration == 0


def test_orbit_pan_moves_look_at(server):
    """Middle/shift-drag pan (reference: src/main.cpp:194-204) via the
    dpanx/dpany query params shifts lookAt in the ground plane."""
    srv, r = server
    before = np.asarray(r.scene.camera.look_at).copy()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/orbit?dpanx=0.5&dpany=0.25",
        method="POST")
    assert json.loads(urllib.request.urlopen(req, timeout=10).read())["ok"]
    after = np.asarray(r.scene.camera.look_at)
    assert not np.allclose(before, after)
    assert after[1] == pytest.approx(before[1])  # ground-plane: y fixed


def test_encode_png_roundtrip(tmp_path):
    """encode_png (the in-memory form the preview serves) matches the
    file writer byte semantics: read back == input."""
    from project3_cuda_path_tracer_tpu.utils import image as img_io
    rng = np.random.default_rng(0)
    rgb8 = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    data = img_io.encode_png(rgb8)
    p = tmp_path / "x.png"
    p.write_bytes(data)
    back = img_io.read_png(str(p))
    np.testing.assert_allclose(back, rgb8.astype(np.float32) / 255.0,
                               atol=1e-6)


def test_preview_with_restir_orbit_invalidates_reservoir():
    """--restir is pitched as the interactive-preview feature: the preview must serve frames from a restir
    renderer, and an orbit (camera change) must RESET the temporal
    reservoir — stale light points must never survive a camera move."""
    from project3_cuda_path_tracer_tpu.scene import types as T
    s = load_scene("scenes/manylights.txt")
    s.camera.resolution = (16, 16)
    s.camera.derive()
    s.settings.trace_depth = 2
    st = T.RenderSettings(**{**s.settings.__dict__, "restir": 2})
    r = Renderer(s, settings=st)
    r.render(3)
    assert float(np.asarray(r.reservoir["M"]).max()) > 0
    srv = PreviewServer(r, port=0).start()
    try:
        data = _get(srv, "/frame.png").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/orbit?dphi=0.3&dtheta=0&dzoom=0",
            method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=10).read())["ok"]
        assert r.iteration == 0
        assert float(np.asarray(r.reservoir["M"]).max()) == 0.0
        r.render(2)   # renders again from the new camera
        assert np.isfinite(r.image()).all()
    finally:
        srv.stop()
