"""Orbit-camera control parity (reference: src/main.cpp:60-67,102-120,
169-205)."""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.app.orbit import OrbitState


@pytest.fixture()
def cam():
    return load_scene("scenes/cornell.txt").camera


def test_roundtrip_preserves_camera(cam):
    """from_camera -> apply with no edits must reproduce the camera."""
    pos0 = np.asarray(cam.position).copy()
    view0 = np.asarray(cam.view).copy()
    st = OrbitState.from_camera(cam)
    st.apply(cam)
    np.testing.assert_allclose(np.asarray(cam.position), pos0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cam.view), view0, atol=1e-5)


def test_zoom_changes_distance(cam):
    st = OrbitState.from_camera(cam)
    d0 = st.zoom
    st = st.dolly(-2.0)
    st.apply(cam)
    d1 = np.linalg.norm(np.asarray(cam.position) - np.asarray(cam.look_at))
    assert d1 == pytest.approx(d0 - 2.0, abs=1e-5)


def test_zoom_clamped_at_min(cam):
    st = OrbitState.from_camera(cam)
    st = st.dolly(-1000.0)
    assert st.zoom == pytest.approx(0.1)


def test_theta_clamped(cam):
    st = OrbitState.from_camera(cam)
    st = st.rotate(0.0, 10.0)
    assert st.theta < np.pi
    st = st.rotate(0.0, -20.0)
    assert st.theta >= 0.001


def test_orbit_keeps_lookat_fixed(cam):
    st = OrbitState.from_camera(cam)
    la0 = np.asarray(cam.look_at).copy()
    st = st.rotate(0.7, -0.3)
    st.apply(cam)
    np.testing.assert_allclose(np.asarray(cam.look_at), la0, atol=1e-6)
    # camera still looks at the look-at point
    to_target = la0 - np.asarray(cam.position)
    to_target /= np.linalg.norm(to_target)
    np.testing.assert_allclose(np.asarray(cam.view), to_target, atol=1e-5)


def test_pan_moves_lookat_in_ground_plane(cam):
    st = OrbitState.from_camera(cam)
    la0 = np.asarray(st.look_at).copy()
    st = st.pan(1.0, 0.0, cam)
    assert st.look_at[1] == pytest.approx(la0[1])  # no vertical motion
    assert np.linalg.norm(st.look_at - la0) == pytest.approx(1.0, abs=1e-5)


def test_recenter(cam):
    st = OrbitState.from_camera(cam).pan(3.0, 2.0, cam).recenter()
    np.testing.assert_allclose(st.look_at, 0.0)
