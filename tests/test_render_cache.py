"""First-bounce cache: identical estimator when ray-gen is deterministic."""
import numpy as np

from project3_cuda_path_tracer_tpu import load_scene
from project3_cuda_path_tracer_tpu.render.integrator import Renderer
from project3_cuda_path_tracer_tpu.scene.types import RenderSettings


def test_first_bounce_cache_matches():
    s = load_scene("scenes/cornell.txt")
    s.camera.resolution = (32, 32)
    s.camera.derive()
    base = RenderSettings(**{**s.settings.__dict__, "antialias": False,
                             "trace_depth": 4})
    cached = RenderSettings(**{**base.__dict__, "first_bounce_cache": True})

    r0 = Renderer(s, settings=base)
    r0.render(4, seed=3)
    r1 = Renderer(s, settings=cached)
    r1.render(4, seed=3)
    np.testing.assert_allclose(r0.image(), r1.image(), atol=1e-5)
    assert r1._first_hit is not None  # the cache was actually built
