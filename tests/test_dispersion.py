"""Spectral dispersion (MATERIAL key DISPERSION): parser, energy
conservation, channel separation, and the zero-strength no-op."""
import numpy as np
import pytest

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render import integrator as I
from project3_cuda_path_tracer_tpu.scene import types as T


@pytest.fixture(scope="module")
def disp_scene():
    s = load_scene("scenes/dispersion.txt")
    s.camera.resolution = (48, 48)
    s.camera.derive()
    return s


def render(scene, spp, **kw):
    st = T.RenderSettings(**{**scene.settings.__dict__, **kw})
    r = I.Renderer(scene, settings=st)
    r.render(spp)
    return r.image()


def test_parser_reads_dispersion(disp_scene):
    d = np.asarray(disp_scene.materials.dispersion)
    assert d.shape == (3,)
    assert d[2] == pytest.approx(0.12)
    assert d[0] == 0.0 and d[1] == 0.0


def test_cfg_gate(disp_scene):
    r = I.Renderer(disp_scene)
    assert r.cfg.dispersion is True
    s2 = load_scene("scenes/cornell.txt")
    assert I.Renderer(s2).cfg.dispersion is False


def test_channels_separate(disp_scene):
    """With strong dispersion the R and B images differ inside the
    refracted region far more than pure Monte-Carlo noise."""
    img = render(disp_scene, 96)
    rb = np.abs(img[..., 0] - img[..., 2]).mean()
    # same scene with dispersion forced to 0 (same estimator + split)
    s0 = load_scene("scenes/dispersion.txt")
    s0.camera.resolution = (48, 48)
    s0.camera.derive()
    import jax.numpy as jnp
    s0.materials.dispersion = jnp.zeros_like(s0.materials.dispersion)
    img0 = render(s0, 96)
    rb0 = np.abs(img0[..., 0] - img0[..., 2]).mean()
    assert rb > 3.0 * max(rb0, 1e-6)


def test_sharded_dispersion_smoke(disp_scene):
    from project3_cuda_path_tracer_tpu.parallel.sharding import (
        ShardedRenderer)
    r = ShardedRenderer(disp_scene)
    assert r.cfg.dispersion is True
    r.render(4)
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0


def test_energy_preserved_at_zero_strength(disp_scene):
    """DISPERSION 0 on the same geometry must agree with the plain glass
    estimator in expectation (the channel split is an unbiased 3x one-hot
    decomposition; at d=0 all channels refract identically)."""
    s0 = load_scene("scenes/dispersion.txt")
    s0.camera.resolution = (32, 32)
    s0.camera.derive()
    import jax.numpy as jnp
    base = render(s0, 128, seed=3)          # dispersion gate ON, d=0.12
    s0.materials.dispersion = jnp.zeros_like(s0.materials.dispersion)
    zero = render(s0, 128, seed=5)          # gate ON, d=0
    # gate OFF entirely (plain glass shading path)
    s1 = load_scene("scenes/dispersion.txt")
    s1.camera.resolution = (32, 32)
    s1.camera.derive()
    s1.materials.dispersion = None
    plain = render(s1, 128, seed=7)
    # luminance means agree (dispersion redistributes between channels,
    # total energy is unchanged; d=0 must agree channelwise)
    assert abs(zero.mean() - plain.mean()) < 0.02
    assert abs(base.mean() - plain.mean()) < 0.02
    assert np.abs(zero.mean(axis=(0, 1)) - plain.mean(axis=(0, 1))).max() \
        < 0.03
